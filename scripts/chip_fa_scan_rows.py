"""The rows a training-kernel change must leave as they were, for one
tree's ``chip_smoke.py``, on the card: ``flash_attention``'s forward and
backward at ``FA_CASES`` (D 64 and D 128: training, ragged, full,
windowed, G 4, G 6), timed against their plain versions and SDPA, and a
SHA-256 of the serving path's ``mamba_scan`` outputs at ``MAMBA_CASES``
(seeded inputs), so that two trees can be compared bit for bit:

    for t in build/parent . . build/parent; do
        python scripts/chip_fa_scan_rows.py "$t"; done

Prints the card's name and power limit and, last, one JSON line of the
timed rows and the digests.
"""
from __future__ import annotations

import argparse
import hashlib
import json
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
        cs.fail("no CUDA device: the rows need one GPU")
    port = cs.load_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    port.build.build_all(["flash_attention", "mamba_scan"])
    print(f"tree {tree}")
    rows = cs.check_flash_attention(port)
    digests = {}
    gen = torch.Generator(device=cs.DEV).manual_seed(9)
    for name, (b, s, d, n, dtype, with_h0) in cs.MAMBA_CASES.items():
        y, h = port.ops.mamba_scan(*cs.scan_inputs(gen, b, s, d, n, dtype,
                                                   with_h0))
        digests[name] = hashlib.sha256(
            y.cpu().numpy().tobytes() + h.cpu().numpy().tobytes()).hexdigest()
    gpu = cs.gpu_line()
    print(gpu)
    print(json.dumps({"tree": str(tree), "gpu": gpu, "rows": rows,
                      "mamba_scan_digests": digests}))


if __name__ == "__main__":
    main()
