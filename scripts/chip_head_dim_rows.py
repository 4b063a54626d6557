"""The attention rows that the runtime head dim must leave as they were,
for one tree's ``chip_smoke.py``, on the card: phase 2's serving rows at
internlm2-1.8b's D 128 (every layout, ``check_layouts``) and the training
kernels' rows at D 64 and D 128 (``check_flash_attention``) and at D 256
and D 80 (gemma3-4b's and zamba2-2.7b's, ``check_flash_attention_wide``),
each timed against its plain version and SDPA.  Two trees run in turns in one call
compare like with like on one card:

    for t in build/parent . . build/parent; do
        python scripts/chip_head_dim_rows.py "$t"; done

Prints the card's name and power limit and, last, one JSON line of the
kernels' ms by row.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch
from chip_int8_phases import load_smoke


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=".",
                    help="root of a checkout holding chip_smoke.py")
    ap.add_argument("--only", choices=("serving", "training"), default=None,
                    help="the serving rows or the training rows alone")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    cs = load_smoke(tree)
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: the rows need one GPU")
    port = cs.load_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = {"serving": ["flash_decode"], "training": ["flash_attention"]}
    port.build.build_all(sources.get(args.only,
                                     ["flash_decode", "flash_attention"]))
    print(f"tree {tree}")
    serving = training = wide = {}
    if args.only != "training":
        serving = cs.check_layouts(port.ops, port.ref, port.quantize.Int8KV)
    if args.only != "serving":
        training = cs.check_flash_attention(port)
        wide = cs.check_flash_attention_wide(
            port, {**cs.FA_D256_CASES, **cs.FA_D80_CASES})
    ms = {f"{kernel} {row}": r["ms"]
          for rows in (serving, training, wide)
          for kernel, by_row in rows.items() for row, r in by_row.items()}
    gpu = cs.gpu_line()
    print(gpu)
    print(json.dumps({"tree": str(tree), "gpu": gpu, "ms": ms}))


if __name__ == "__main__":
    main()
