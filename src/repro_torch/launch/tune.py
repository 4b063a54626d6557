"""Pod-config tuner: the EON Tuner's loop over distribution knobs,
scored by the dry run (``launch/dryrun.py``) on the card's model.

    python -m repro_torch.launch.tune --arch internlm2-1.8b --shape train_4k --n 6

Traces each candidate on the ``meta`` device: no card is needed.  Writes
the ranked rows to ``<out>/<arch>_<shape>_single.json``.
"""
import argparse
import json
from pathlib import Path

from repro_torch.core.tuner import PodConfigTuner
from repro_torch.launch.dryrun import run_cell


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--n", type=int, default=6)
    ap.add_argument("--out", default="build/tuner")
    args = ap.parse_args(argv)

    tuner = PodConfigTuner(run_cell, arch=args.arch, shape=args.shape)
    ranked = tuner.search(n_samples=args.n)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    rows = []
    for c in ranked:
        r = c.report["roofline"]
        rows.append({"strategy": c.strategy, "n_micro": c.report["n_micro"],
                     "remat": c.remat,
                     "roofline_fraction": r["roofline_fraction"],
                     "bottleneck": r["bottleneck"],
                     "hbm_gib": c.report["memory"]["per_device_hbm_gib"]})
        print(rows[-1])
    (out / f"{args.arch}_{args.shape}_single.json").write_text(
        json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
