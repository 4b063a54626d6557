"""The training-breadth phases of one tree's ``chip_smoke.py``, on the
card: the build of ``flash_attention`` and ``mamba_scan`` with ptxas'
report for the backward kernels (D 80 and D 256, the scan's), phase 7's
steps under each remat policy with a profile of one "dots" step and one
"dots_no_batch" step, phase 2's rows of the ``flash_attention`` backward
at D 80 and D 256 and of the ``mamba_scan`` backward, and phase 16
(falcon-mamba-7b, zamba2-2.7b and gemma3-4b trained at full width,
two-layer gradients against the plain path):

    python scripts/chip_train_phases.py [tree]

Prints the card's name and power limit and, last, one JSON line of the
rows and the phases' metrics.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch
from chip_int8_phases import load_smoke

# the ptxas report of these instantiations is printed
WIDE = ("Li80E", "Li256E", "mamba_scan_bwd")


def profile_step(cs, call, trace: Path) -> dict:
    """One ``call`` (after an untimed one) under ``torch.profiler``: its
    host wall, the device's busy ms, the kernels and host events by count,
    and the kernels and CUDA runtime calls that take the most time."""
    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    trace.unlink()
    by_cat, top = {}, {"kernel": {}, "cuda_runtime": {}}
    for e in events:
        cat = e.get("cat")
        by_cat[cat] = by_cat.get(cat, 0) + 1
        if cat in top:
            ms, n = top[cat].get(e["name"][:60], (0.0, 0))
            top[cat][e["name"][:60]] = (ms + e.get("dur", 0) / 1e3, n + 1)
    kernels = [(e["ts"], e["dur"]) for e in events
               if e.get("cat") == "kernel"]
    return dict(host_wall_ms=wall_ms,
                device_busy_ms=cs._merged_us(kernels) / 1e3,
                events_by_category=by_cat,
                **{f"top_{cat}": sorted(
                    ((k, round(ms, 3), n) for k, (ms, n) in d.items()),
                    key=lambda r: -r[1])[:8] for cat, d in top.items()})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=".",
                    help="root of a checkout holding chip_smoke.py")
    tree = Path(ap.parse_args().tree).resolve()
    cs = load_smoke(tree)
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: the training phases need one GPU")
    port = cs.load_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tree {tree}")
    t0 = time.perf_counter()
    logs = port.build.build_all(["flash_attention", "mamba_scan"])
    for log in logs.values():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.strip()
            elif any(w in entry for w in WIDE) and ("registers" in line
                                                    or "spill" in line):
                print("   " + entry[40:150] + " | " + line.strip()[-70:])
    print(f"  build {time.perf_counter() - t0:.1f} s")
    out = {"tree": str(tree)}

    t0 = time.perf_counter()
    print("phase 7: internlm2-1.8b under each remat policy")
    cfg = cs.full_config(port, 24)
    params, opt_state, tokens = cs.train_state(port, cfg)
    batch = next(port.synthetic.lm_batches(tokens[:cs.TRAIN_TOKENS],
                                           cs.TRAIN_BATCH, cs.TRAIN_SEQ,
                                           seed=0))
    out["remat"] = cs.remat_policies(port, cfg, params, opt_state, batch)
    out["remat_profile"] = {}
    for policy in ("dots", "dots_no_batch"):
        step = port.train_step.make_train_step(
            cfg, remat=policy,
            opt=port.optimizer.AdamWConfig(lr=cs.TRAIN_LR))
        prof = profile_step(
            cs, lambda: float(step(params, opt_state, batch)[2]["loss"]),
            tree / "build" / "profile_remat.json")
        print(f"  profile of a {policy} step: {json.dumps(prof)}")
        out["remat_profile"][policy] = prof
    del params, opt_state
    torch.cuda.empty_cache()
    print(f"  remat {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    print("phase 2: the backward rows")
    out["flash_attention"] = {}
    for cases in (cs.FA_D256_CASES, cs.FA_D80_CASES):
        for name, rows in cs.check_flash_attention_wide(port, cases).items():
            out["flash_attention"].setdefault(name, {}).update(rows)
    out["mamba_scan_bwd"] = cs.check_mamba_scan_bwd(port)
    print(f"  rows {time.perf_counter() - t0:.1f} s")

    print("phase 16: training breadth at full width")
    out["phase16"] = cs.breadth_phase(port)
    gpu = cs.gpu_line()
    print(gpu)
    out["gpu"] = gpu
    print(json.dumps(out))


if __name__ == "__main__":
    main()
