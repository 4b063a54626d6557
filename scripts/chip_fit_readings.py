"""Readings of ``chip_smoke.fit_vs_cpu`` (the quickstart Impulse fitted on
the card and on the CPU from the same weights) over 8 weight seeds, twice
each, with its limits reported instead of enforced: what the limits of
``FIT_LOSS_RTOL`` and ``FIT_LOGIT_ATOL`` are set from.  Needs one GPU:

    python scripts/chip_fit_readings.py
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: the readings need one GPU")
    port = cs.load_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    port.build.build_all()
    cs.check = lambda cond, msg: None if cond else print("over limit:",
                                                         msg[:200])
    quickstart = cs.quickstart
    for seed in range(1, 9):
        def seeded(port, seed=seed):
            quick, clips, labels = quickstart(port)
            quick.init(torch.Generator(device=cs.DEV).manual_seed(seed))
            return quick, clips, labels
        cs.quickstart = seeded
        for rep in range(2):
            print("seed", seed, "rep", rep, json.dumps(cs.fit_vs_cpu(port)))


if __name__ == "__main__":
    main()
