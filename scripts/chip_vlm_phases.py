"""The VLM phases of one tree's ``chip_smoke.py``, on the card: the build
of the three kernels their path runs (``flash_decode``, ``int8_matmul``,
``flash_attention``) with ptxas' report for ``flash_attention``, phase 2's
rows at qwen2-vl-72b's shapes (both training attention kernels masked by
position: an image's positions at B 1, S 2,048, 64/8 heads of 128, bf16
and f32, and packed rows with pads, causal and with a window of 256; both
serving kernels at G 8, contiguous and paged, float and int8;
``int8_matmul`` at its projections) and phase 15 (qwen2-vl-72b served and
trained at full width; the small float32 oracle):

    python scripts/chip_vlm_phases.py [tree] [--phase15] [--seamless-noise]

``--phase15`` runs phase 15 alone (no phase 2 rows).  ``--seamless-noise``
runs, instead, the reading behind phase 14's int8 greedy gate: the
seamless-m4t-large-v2 int8 one-shot path against itself with every
encoder input moved by one ulp (``NOISE_SEEDS``), through the kernels and
through their plain versions, float beside it, each teacher-forced with
the float run's tokens as phase 14 is.

Prints the card's name and power limit and, last, one JSON line of the
rows and readings.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch
from chip_int8_phases import load_smoke

NOISE_SEEDS = (1, 2)


def one_ulp(x: torch.Tensor, seed: int) -> torch.Tensor:
    """``x`` (bf16) with every element moved one ulp up or down in
    magnitude, the direction drawn from ``seed``."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    bits = x.view(torch.int16)
    step = torch.randint(0, 2, x.shape, generator=gen, device=x.device,
                         dtype=torch.int16) * 2 - 1
    # a zero moves up: its bits less one would be a NaN
    step = torch.where((bits & 0x7FFF) == 0, 1, step).to(torch.int16)
    return (bits + step).view(x.dtype)


def seamless_noise(cs, port) -> dict:
    """Phase 14's model and inputs: the int8 and float one-shot runs,
    teacher-forced with the float run's tokens, against the same runs on
    encoder inputs moved by one ulp; through the kernels, and through the
    plain versions (``encdec_plain``) as the control that tells the
    kernels' own sensitivity from the model's."""
    cfg = cs.encdec_config(port)
    params = port.init_params(cfg, torch.Generator(device=cs.DEV)
                              .manual_seed(0), cs.DEV)
    gen = torch.Generator(device=cs.DEV).manual_seed(11)
    inputs = port.api.synthetic_inputs(cfg, cs.ENCDEC_B, 4 * cs.ENCDEC_ENC,
                                       gen, train=False, device=cs.DEV)
    enc = inputs["enc_embeddings"]
    prompts = inputs["tokens"][:, :cs.ENCDEC_PROMPT].contiguous()
    cs.check(enc.dtype == torch.bfloat16, f"encoder inputs {enc.dtype}")
    _, forced, _ = cs.encdec_run(port, cfg, params, enc, prompts, None,
                                 "oneshot")
    int8 = port.quantize.INT8
    weights = {"float": (params, None),
               "int8": (port.quantize.quantize_model_params(params, int8),
                        int8)}
    out = {}
    for precision, (w, policy) in weights.items():
        def run(x):
            return cs.encdec_run(port, cfg, w, x, prompts, policy,
                                 "oneshot", forced)[0]
        bases = {}
        for path, patches in (("kernel", []),
                              ("plain", cs.encdec_plain(port))):
            with cs.patched(patches):
                base = bases[path] = run(enc)
                out[f"{precision}_{path}_rerun"] = cs.logit_reading(
                    run(enc), base)
                for seed in NOISE_SEEDS:
                    out[f"{precision}_{path}_one_ulp_seed{seed}"] = \
                        cs.logit_reading(run(one_ulp(enc, seed)), base)
        out[f"{precision}_kernel_vs_plain"] = cs.logit_reading(
            bases["kernel"], bases["plain"])
        print(f"  seamless-m4t {precision}, each path against itself: "
              + json.dumps({k: v for k, v in out.items()
                            if k.startswith(precision)}))
        del bases
    del params, weights
    torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=".",
                    help="root of a checkout holding chip_smoke.py")
    ap.add_argument("--phase15", action="store_true",
                    help="phase 15 alone, without phase 2's rows")
    ap.add_argument("--seamless-noise", action="store_true",
                    help="the seamless-m4t int8 noise reading alone")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    cs = load_smoke(tree)
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: the VLM phases need one GPU")
    port = cs.load_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tree {tree}")
    t0 = time.perf_counter()
    logs = port.build.build_all(["flash_decode", "int8_matmul",
                                 "flash_attention"])
    print(f"  build {time.perf_counter() - t0:.1f} s")
    entry = ""
    for line in logs["flash_attention"].splitlines():
        if "Compiling entry function" in line:
            entry = line.strip().split("'")[1] if "'" in line else line
        elif "spill stores" in line and " 0 bytes spill stores" not in line:
            print(f"   {entry[:120]}: {line.strip()}")

    result = {"tree": str(tree)}
    if args.seamless_noise:
        print("the seamless-m4t int8 path against itself under one-ulp"
              " noise")
        result["seamless_noise"] = seamless_noise(cs, port)
    else:
        if not args.phase15:
            print("phase 2: the VLM rows")
            t0 = time.perf_counter()
            layouts = {k: v for k, v in cs.SLICE_LAYOUTS.items()
                       if k.startswith("d128_g8")}
            result["attention"] = cs.check_slice_attention(
                port.ops, port.ref, port.quantize.Int8KV, layouts)
            result["int8_matmul"] = cs.check_int8_matmul(
                port.ops, port.ref, port.im, cs.QWEN_MATMUL_SHAPES)
            result["flash_attention"] = \
                cs.check_flash_attention_positions(port)
            print(f"  phase 2 rows {time.perf_counter() - t0:.1f} s")
        print("phase 15: qwen2-vl-72b at full width")
        t0 = time.perf_counter()
        vlm = cs.qwen_phase(port)
        print(f"  phase 15 {time.perf_counter() - t0:.1f} s")
        result.update(serve=vlm["serve"], train=vlm["train"][1],
                      train_launches=vlm["train"][0], small=vlm["small"])
    gpu = cs.gpu_line()
    print(gpu)
    result["gpu"] = gpu
    print(json.dumps(result))


if __name__ == "__main__":
    main()
