"""The enc-dec phases of one tree's ``chip_smoke.py``, on the card: the
build of the three kernels their path runs (``flash_decode``,
``int8_matmul``, ``flash_attention``), phase 2's rows at seamless-m4t's
shapes (both training attention kernels with keys of another length, 16/16
heads of 64, ``causal=False``; both serving kernels at D 64 and G 1, the
self cache and the cross cache, float and int8; ``int8_matmul`` at K
1,024 and 8,192), and phase 14 (seamless-m4t-large-v2 served in one shot
and in chunks, float and int8, and trained at full width and depth; the
small float32 oracle):

    python scripts/chip_encdec_phases.py [tree] [--phase14]

``--phase14`` runs phase 14 alone (no phase 2 rows).

Prints the card's name and power limit and, last, one JSON line of the
rows and phase 14's readings.
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
    ap.add_argument("--phase14", action="store_true",
                    help="phase 14 alone, without phase 2's rows")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    cs = load_smoke(tree)
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: the enc-dec phases need one GPU")
    port = cs.load_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tree {tree}")
    t0 = time.perf_counter()
    port.build.build_all(["flash_decode", "int8_matmul", "flash_attention"])
    print(f"  build {time.perf_counter() - t0:.1f} s")

    rows, mm_rows, fa_rows = {}, {}, {}
    if not args.phase14:
        print("phase 2: the enc-dec rows")
        t0 = time.perf_counter()
        layouts = {k: v for k, v in cs.SLICE_LAYOUTS.items()
                   if k.startswith("d64_g1")}
        rows = cs.check_slice_attention(port.ops, port.ref,
                                         port.quantize.Int8KV, layouts)
        mm_rows = cs.check_int8_matmul(port.ops, port.ref, port.im)
        fa_rows = cs.check_flash_attention_cross(port)
        print(f"  phase 2 rows {time.perf_counter() - t0:.1f} s")
    print("phase 14: the encoder-decoder backbone at full width and depth")
    t0 = time.perf_counter()
    encdec = cs.encdec_phase(port)
    print(f"  phase 14 {time.perf_counter() - t0:.1f} s")
    gpu = cs.gpu_line()
    print(gpu)
    print(json.dumps({
        "tree": str(tree), "gpu": gpu, "attention": rows,
        "int8_matmul": {k: v for k, v in mm_rows.items()
                        if "K1024" in k or "K8192_N1024" in k},
        "flash_attention": fa_rows,
        "serve": encdec["serve"], "train": encdec["train"][1],
        "small": encdec["small"]}))


if __name__ == "__main__":
    main()
