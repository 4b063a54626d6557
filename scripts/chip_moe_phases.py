"""The MoE phases of one tree's ``chip_smoke.py``, on the card: the build of
the three kernels their path runs (``flash_decode``, ``int8_matmul``,
``flash_attention``), phase 2's rows at the MoE decoders' shapes (both
serving kernels at G 6 and G 4, D 128, contiguous and paged, float and
int8; ``int8_matmul`` at every serving shape, K 4,096 and 6,144 among
them; both training attention kernels at every case, 32/8 and 48/8 heads
among them), and phase 13 (phi3.5-moe and dbrx-132b served, dbrx
prefilled, phi3.5-moe trained, the small float32 oracles):

    python scripts/chip_moe_phases.py [tree] [--phase13]

``--phase13`` runs phase 13 alone (no phase 2 rows).

Prints the card's name and power limit and, last, one JSON line of the
rows and phase 13's readings.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch
from chip_int8_phases import load_smoke


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=".",
                    help="root of a checkout holding chip_smoke.py")
    ap.add_argument("--phase13", action="store_true",
                    help="phase 13 alone, without phase 2's rows")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    cs = load_smoke(tree)
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: the MoE phases need one GPU")
    port = cs.load_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tree {tree}")
    t0 = time.perf_counter()
    port.build.build_all(["flash_decode", "int8_matmul", "flash_attention"])
    print(f"  build {time.perf_counter() - t0:.1f} s")

    rows, mm_rows, fa_rows = {}, {}, {}
    if not args.phase13:
        print("phase 2: the MoE decoders' rows")
        layouts = {k: v for k, v in cs.SLICE_LAYOUTS.items()
                   if k.startswith(("d128_g4", "d128_g6"))}
        rows = cs.check_slice_attention(port.ops, port.ref,
                                         port.quantize.Int8KV, layouts)
        mm_rows = cs.check_int8_matmul(port.ops, port.ref, port.im)
        fa_rows = cs.check_flash_attention(port)
    print("phase 13: the MoE decoders at full width")
    t0 = time.perf_counter()
    moe = cs.moe_phase(port)
    print(f"  phase 13 {time.perf_counter() - t0:.1f} s")
    gpu = cs.gpu_line()
    print(gpu)
    phi, dbrx = moe["phi"], moe["dbrx"]
    print(json.dumps({
        "tree": str(tree), "gpu": gpu, "attention": rows,
        "int8_matmul": {k: v for k, v in mm_rows.items()
                        if "K4096" in k or "K6144" in k},
        "flash_attention": {name: {k: v for k, v in r.items()
                                   if k.startswith(("g4", "g6"))}
                            for name, r in fa_rows.items()},
        "phi": {k: v for k, v in phi.items()},
        "dbrx": {"launches": dbrx["launches"], "metrics": dbrx["metrics"],
                 "routing": dbrx["routing"], "prefill": dbrx["prefill"][1]},
        "train": moe["train"][1]}))


if __name__ == "__main__":
    main()
