"""EON Tuner demo on the PyTorch/CUDA port (paper §4.7 / Table 3): AutoML
over the joint (DSP × NN) space under MCU resource constraints, the
survivors trained on the card (the counterpart of
``examples/eon_tuner_kws.py``).

Run:  PYTHONPATH=src python examples/torch_eon_tuner_kws.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.tuner import EONTuner
from repro_torch.data.dataset import Dataset
from repro_torch.data.synthetic import keyword_audio

N_SAMPLES = 8000


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    device = ap.parse_args().device

    ds = Dataset()
    ds.add_many(keyword_audio(n_per_class=24, n_classes=4,
                              n_samples=N_SAMPLES))
    xtr, ytr = ds.arrays("train")
    xva, yva = ds.arrays("val")

    tuner = EONTuner(input_samples=N_SAMPLES, n_classes=4,
                     target="nano33ble", max_latency_ms=400, seed=0,
                     device=device)
    cands = tuner.sample(10)
    print(f"sampled {len(cands)} configurations")
    survivors = tuner.screen(cands)
    print(f"{len(survivors)} pass the nano33ble RAM/flash/latency screen "
          f"(the paper's cheap-heuristic phase)")
    ranked = tuner.evaluate(survivors, (np.asarray(xtr), np.asarray(ytr)),
                            (np.asarray(xva), np.asarray(yva)), epochs=3)
    print(f"\n{'configuration':<46}{'acc':>5} {'dsp':>7} {'nn':>7} "
          f"{'ram':>7} {'flash':>8}")
    for c in ranked:
        e = c.estimate
        print(f"{c.describe():<46}{c.accuracy:5.2f} "
              f"{e.dsp_latency_ms:6.0f}m {e.nn_latency_ms:6.1f}m "
              f"{e.ram_kb:6.1f}k {e.flash_kb:7.1f}k")


if __name__ == "__main__":
    main()
