"""Phase 17 of one tree's ``chip_smoke.py`` alone, on the card: the build
of the kernels it runs (``flash_attention``, ``flash_decode``,
``mamba_scan``) with the dry-run matrix traced on ``meta`` meanwhile in
processes of their own, the four cut cells against the card, the pod
tuner and the elastic cycle:

    python scripts/chip_dryrun_phase.py [tree]

Prints the card's name and power limit and, last, one JSON line of the
phase's readings (the memory gaps ``DRYRUN_MEM_RTOL`` is set from among
them).
"""
from __future__ import annotations

import argparse
import json
import tempfile
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
        cs.fail("no CUDA device: the dry-run phase needs one GPU")
    port = cs.load_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        procs = cs.start_dryrun_matrix(port, Path(d))
        port.build.build_all(["flash_attention", "flash_decode",
                              "mamba_scan"])
        waited = cs.finish_dryrun_matrix(procs, Path(d))
        print(f"tree {tree}; build {time.perf_counter() - t_start:.1f} s,"
              f" the matrix's wait included ({waited:.1f} s)")
        out = cs.dryrun_phase(port, Path(d), waited)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(cs.gpu_line())
    print(json.dumps({k: out[k] for k in ("matrix", "cells", "tuner",
                                           "elastic")}))


if __name__ == "__main__":
    main()
