"""The ``mamba_scan`` backward's design choices measured on the card: the
tree's ``csrc/mamba_scan.cu`` built as it is and as variants that differ
in one choice each (the decay by ``expf`` or ``exp2f`` instead of
``ex2.approx``; sub-chunks of 6 steps in segments of 96), each loaded
in place of the shipped library.  For each: ptxas' spills and the main
kernel's registers, the readings at ``MAMBA_BWD_CASES``, the dt = 0 pad
identity (bitwise, pads across segment boundaries), the device ms of
each of the four kernels (``torch.profiler``) and the call's ms at
falcon-mamba's training shape, timed twice in turns:

    python scripts/chip_scan_bwd_variants.py [tree]

Prints the card's name and power limit and, last, one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch
from chip_int8_phases import load_smoke

SHIPPED = "  float r;\n  asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(r) : \"f\"(dtv * al));\n  return r;"
# name: (decay body, sub-chunk steps, segment steps)
VARIANTS = {"shipped": (SHIPPED, 8, 128),
            "exp2f": ("  return exp2f(dtv * al);", 8, 128),
            "expf": ("  return expf(dtv * al * kLn2);", 8, 128),
            "sub6_seg96": (SHIPPED, 6, 96)}
PADS = ((70, 26), (98, 60), (251, 138))


def source(src: str, body: str, sub: int, seg: int) -> str:
    cut = src.index("// Backward (the TPU kernel")
    bwd = src[cut:]
    for old, new in ((SHIPPED, body),
                     ("constexpr int kSeg = 128;", f"constexpr int kSeg = {seg};"),
                     ("constexpr int kSub = 8;", f"constexpr int kSub = {sub};")):
        assert old in bwd, old
        bwd = bwd.replace(old, new)
    return src[:cut] + bwd


def ptxas(log: str) -> dict:
    out, entry = {}, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "mamba_scan_bwd" in entry:
            k = re.search(r"(mamba_scan_bwd_\w*?kernel\w*?E)EvP", entry)
            name = k.group(1) if k else entry
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and int(m.group(1)):
                out[name + " spill bytes"] = int(m.group(1))
            r = re.search(r"Used (\d+) registers", line)
            if r and "kernelI13__nv_bfloat16Li4ELb1E" in name:
                out[name + " registers"] = int(r.group(1))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=".")
    tree = Path(ap.parse_args().tree).resolve()
    cs = load_smoke(tree)
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: the variants need one GPU")
    port = cs.load_port()
    ms_, build = port.ms, port.build
    src = (build.CSRC / "mamba_scan.cu").read_text()
    out_dir = tree / "build" / "scan_bwd_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (body, sub, seg) in VARIANTS.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(source(src, body, sub, seg))
        jobs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs, res = {}, {}
    for name, proc in jobs.items():
        _, log = proc.communicate()
        cs.check(proc.returncode == 0, f"{name} did not build: {log[-2000:]}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        lib.mamba_scan_bwd.argtypes = ms_._BWD_ARGTYPES
        lib.mamba_scan_bwd.restype = ctypes.c_int
        libs[name] = lib
        res[name] = {"ptxas": ptxas(log)}
        print(f"  {name} ptxas {json.dumps(res[name]['ptxas'])}")

    def use(name):
        ms_._lib = lambda: libs[name]
        ms_.SEGMENT = VARIANTS[name][2]
        ms_._bwd_plan.cache_clear()

    def pads_exact() -> bool:
        same = True
        for real, pad in PADS:
            gen = torch.Generator(device=cs.DEV).manual_seed(1)
            x, dt, bm, cm, a, h0 = cs.scan_inputs(gen, 2, real + pad, 256, 16,
                                                  torch.bfloat16, True)
            dt[:, real:] = 0
            dy = torch.randn(2, real + pad, 256, generator=gen, device=cs.DEV)
            dy[:, real:] = 0
            dhf = torch.randn(2, 256, 16, generator=gen, device=cs.DEV)
            full = ms_.mamba_scan_bwd(x, dt, bm, cm, a, h0, dy, dhf)
            cut = ms_.mamba_scan_bwd(
                *(t[:, :real].contiguous() for t in (x, dt, bm, cm)), a, h0,
                dy[:, :real].contiguous(), dhf)
            trimmed = [g[:, :real] for g in full[:4]] + list(full[4:])
            same &= all(torch.equal(u, v) for u, v in zip(trimmed, cut))
        return same

    gen = torch.Generator(device=cs.DEV).manual_seed(31)
    b, s, d, n, dtype, carried = cs.MAMBA_BWD_CASES["train_b1_s2048"]
    x, dt, bm, cm, a, h0 = cs.scan_inputs(gen, b, s, d, n, dtype, carried)
    dy = torch.randn(b, s, d, generator=gen, device=cs.DEV)
    args = (x, dt, bm, cm, a, h0, dy, None)
    for name in VARIANTS:
        use(name)
        print(f"{name}:")
        rows = cs.check_mamba_scan_bwd(port)
        res[name]["readings"] = rows["train_b1_s2048"]["readings"]
        res[name]["pads_exact"] = pads_exact()
        cs.check(res[name]["pads_exact"], f"{name}: a dt = 0 pad changed"
                 f" the prefix's gradients")
        for _ in range(3):
            ms_.mamba_scan_bwd(*args)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(10):
                ms_.mamba_scan_bwd(*args)
            torch.cuda.synchronize()
        res[name]["kernels_ms"] = {
            re.search(r"mamba_scan_bwd_\w*kernel", e.key).group(0):
                e.device_time_total / 10 / 1e3
            for e in prof.key_averages() if "mamba_scan_bwd" in e.key}
        print(f"  {name} kernels {json.dumps(res[name]['kernels_ms'])}")
    for name in list(VARIANTS) + list(reversed(VARIANTS)):
        use(name)
        res[name].setdefault("ms", []).append(
            cs.time_ms(lambda: ms_.mamba_scan_bwd(*args), reps=10))
    for name in VARIANTS:
        print(f"  {name:11s} ms {res[name]['ms']}")
    gpu = cs.gpu_line()
    print(gpu)
    print(json.dumps({"gpu": gpu, "variants": res}))


if __name__ == "__main__":
    main()
