"""The serving attention phases of one tree's ``chip_smoke.py``, on the
card: the build of the two kernels the serving paths run (``flash_decode``,
``int8_matmul``), phase 2's attention rows (every layout against its
plain version, timed against the bound and SDPA), phase 3's float
serving of internlm2-1.8b at full width with phase 4's decode and chunk
step profile, and phase 5's int8 paged serving with its step profile.
Each phase is the tree's own code, so two trees run in turns in one call
compare like with like on one card:

    for t in build/parent . . build/parent; do
        python scripts/chip_attention_phases.py "$t"; done

Prints the card's name and power limit and, last, one JSON line of the
rows, the serving metrics and the step profiles.
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
        cs.fail("no CUDA device: the attention phases need one GPU")
    port = cs.load_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tree {tree}")
    t0 = time.perf_counter()
    logs = port.build.build_all(["flash_decode", "int8_matmul"])
    for line in logs["flash_decode"].splitlines():
        if "registers" in line or "spill" in line:
            print("   " + line.strip()[:170])
    print(f"  build {time.perf_counter() - t0:.1f} s")

    print("phase 2: the attention kernels against their plain versions")
    rows = cs.check_layouts(port.ops, port.ref, port.quantize.Int8KV)
    print("phase 3: full-width serving, internlm2-1.8b bf16")
    cfg = cs.full_config(port)
    params, launches, metrics = cs.serve_full(port, cfg)
    print("phase 4: where a step's time goes")
    prof = cs.profile_steps(port, cfg, params)
    print("phase 5: full-width int8 paged serving, internlm2-1.8b bf16")
    srv, launches8, metrics8 = cs.serve_int8_paged(port, cfg, params)
    prof8 = cs.profile_steps(port, cfg, srv.params, port.quantize.INT8, True)
    gpu = cs.gpu_line()
    print(gpu)
    print(json.dumps({"tree": str(tree), "gpu": gpu, "attention": rows,
                      "launches": launches, "float_continuous": metrics,
                      "profile": prof, "launches_int8": launches8,
                      "int8_paged": metrics8, "profile_int8": prof8}))


if __name__ == "__main__":
    main()
