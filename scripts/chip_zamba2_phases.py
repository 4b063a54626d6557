"""The zamba2-2.7b phases of one tree's ``chip_smoke.py``, on the card:
the build of the three kernels its path runs (``flash_decode``,
``int8_matmul``, ``flash_attention``) with ptxas' report for the D 80
instantiations, phase 2's D 80 rows (both serving kernels at 32/32 heads
of 80, contiguous, paged and full; the forward at S 2,048 and 1,000; the
shared block's int8 matmuls), and phase 12 (float continuous and int8
paged serving at full width with their logits against the plain path, a
step profile, one-shot prefill against the chunked path, the small
float32 oracle):

    python scripts/chip_zamba2_phases.py [tree]

Prints the card's name and power limit and, last, one JSON line of the
rows, the serving metrics, the prefill reading and the profile.
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
    tree = Path(ap.parse_args().tree).resolve()
    cs = load_smoke(tree)
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: the zamba2 phases need one GPU")
    port = cs.load_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tree {tree}")
    t0 = time.perf_counter()
    logs = port.build.build_all(["flash_decode", "int8_matmul",
                                 "flash_attention"])
    for log in logs.values():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.strip()
            elif "Li80E" in entry and ("registers" in line
                                       or "spill" in line):
                print("   " + entry[40:150] + " | " + line.strip()[-60:])
    print(f"  build {time.perf_counter() - t0:.1f} s")

    print("phase 2: the D 80 rows")
    d80 = {k: v for k, v in cs.SLICE_LAYOUTS.items() if k.startswith("d80")}
    rows = cs.check_slice_attention(port.ops, port.ref, port.quantize.Int8KV,
                                     d80)
    fa_rows = cs.check_flash_attention_wide(port, cs.FA_D80_CASES)
    mm_rows = cs.check_int8_matmul(port.ops, port.ref, port.im)
    print("phase 12: zamba2-2.7b at full width")
    launches, metrics, launches8, metrics8, prefill, prof = \
        cs.zamba_phase(port)
    gpu = cs.gpu_line()
    print(gpu)
    print(json.dumps({"tree": str(tree), "gpu": gpu, "attention": rows,
                      "flash_attention": fa_rows,
                      "int8_matmul": {k: v for k, v in mm_rows.items()
                                      if "2560" in k},
                      "launches": launches, "float_continuous": metrics,
                      "launches_int8": launches8, "int8_paged": metrics8,
                      "prefill": prefill[1], "profile": prof}))


if __name__ == "__main__":
    main()
