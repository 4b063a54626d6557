"""The scan backward's part of one tree's ``chip_smoke.py``, on the card:
the build of ``mamba_scan`` with ptxas' report for the backward's
kernels, phase 2's ``mamba_scan_bwd`` rows (readings at every case, two
runs bitwise equal, the planted faults, the kernel against its bound at
falcon-mamba's training shape), and phase 16's falcon-mamba-7b part
(trained at full width and 24 of its 64 layers, the launch counts, a
two-layer run's gradients against the plain path):

    python scripts/chip_scan_bwd.py [tree] [--rows-only]

Two trees compare on one card in turns, parent, change, change, parent
(unpack the parent with ``git archive`` into ``build/parent``):

    for t in build/parent . . build/parent; do
        python scripts/chip_scan_bwd.py "$t"; done

Prints the card's name and power limit and, last, one JSON line of the
rows and the phase's metrics.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch
from chip_int8_phases import load_smoke

ARCH = "falcon-mamba-7b"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=".",
                    help="root of a checkout holding chip_smoke.py")
    ap.add_argument("--rows-only", action="store_true",
                    help="phase 2's rows, not phase 16")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    cs = load_smoke(tree)
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: the scan backward needs one GPU")
    port = cs.load_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tree {tree}")
    t0 = time.perf_counter()
    log = port.build.build_all(["mamba_scan"])["mamba_scan"]
    entry = ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.strip()
        elif "mamba_scan_bwd" in entry and ("registers" in line
                                            or "spill" in line):
            print("   " + entry[40:130] + " | " + line.strip()[-70:])
    print(f"  build {time.perf_counter() - t0:.1f} s")
    out = {"tree": str(tree)}

    t0 = time.perf_counter()
    print("phase 2: the mamba_scan backward")
    out["mamba_scan_bwd"] = cs.check_mamba_scan_bwd(port)
    print(f"  rows {time.perf_counter() - t0:.1f} s")

    if not args.rows_only:
        t0 = time.perf_counter()
        print(f"phase 16: {ARCH} at full width")
        layers, changes = cs.BREADTH[ARCH]
        _, launches, metrics = cs.breadth_train(port, ARCH, layers)
        want = {name: 0 for name in launches}
        want.update(mamba_scan=2 * layers * cs.BREADTH_STEPS,
                    mamba_scan_bwd=layers * cs.BREADTH_STEPS)
        cs.check(launches == want, f"{ARCH} training launches {launches}"
                 f" != {want}")
        grads = cs.breadth_grads_vs_plain(port, ARCH, changes)
        out["phase16"] = dict(launches=launches, metrics=metrics,
                              grads=grads)
        print(f"  phase {time.perf_counter() - t0:.1f} s")
    gpu = cs.gpu_line()
    print(gpu)
    out["gpu"] = gpu
    print(json.dumps(out))


if __name__ == "__main__":
    main()
