"""Active-learning loop demo on the PyTorch/CUDA port (the counterpart of
``examples/active_learning_demo.py``, paper §4.8): train on a small
labeled subset, embed everything, auto-label by cluster proximity,
retrain.

Run:  PYTHONPATH=src python examples/torch_active_learning_demo.py \
          [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.active_learning import active_learning_round
from repro_torch.core.blocks import make_dsp_block, make_learn_block
from repro_torch.core.impulse import Impulse
from repro_torch.data.dataset import Dataset
from repro_torch.data.synthetic import keyword_audio

N_SAMPLES = 8000
N_CLASSES = 4


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    device = resolve_device(ap.parse_args().device)

    ds = Dataset()
    ds.add_many(keyword_audio(n_per_class=30, n_classes=N_CLASSES,
                              n_samples=N_SAMPLES))
    xs, ys = ds.arrays("train")
    xs, ys = np.asarray(xs), np.asarray(ys)

    # 1. label only 6 samples per class
    labeled_idx = np.concatenate(
        [np.where(ys == c)[0][:6] for c in range(N_CLASSES)])
    print(f"labeled subset: {len(labeled_idx)}/{len(xs)} samples")

    imp = Impulse(make_dsp_block("mfcc", n_mels=32, n_coeffs=10),
                  make_learn_block("conv1d-stack", n_blocks=2, ch_first=16,
                                   ch_last=32, n_classes=N_CLASSES),
                  input_shape=N_SAMPLES, device=device)
    imp.init(torch.Generator(device=device).manual_seed(0))
    imp.fit((xs[labeled_idx], ys[labeled_idx]), epochs=8, batch_size=8,
            lr=2e-3)

    # 2-4. embed (features as the intermediate layer), project, propose
    out = active_learning_round(
        lambda x: imp.features(x).reshape(len(x), -1).cpu().numpy(),
        xs, labeled_idx, ys, N_CLASSES)
    prop, conf = out["proposed"], out["confident"]
    mask = conf & (prop >= 0)
    acc = float((prop[mask] == ys[mask]).mean())
    print(f"auto-labeled {int(mask.sum())} samples at {acc:.2%} accuracy "
          f"(PCA explained variance: {out['explained_variance']})")

    # 5. retrain on the expanded label set
    keep = mask | np.isin(np.arange(len(xs)), labeled_idx)
    imp2 = Impulse(imp.dsp, imp.learn, input_shape=N_SAMPLES, device=device)
    imp2.init(torch.Generator(device=device).manual_seed(1))
    imp2.fit((xs[keep], prop[keep]), epochs=6, batch_size=16, lr=2e-3)
    xte, yte = ds.arrays("test")
    small = imp.evaluate(imp.params, np.asarray(xte), np.asarray(yte))
    grown = imp2.evaluate(imp2.params, np.asarray(xte), np.asarray(yte))
    print(f"test acc: {small:.2%} (labeled subset only) -> "
          f"{grown:.2%} (after active-learning expansion)")


if __name__ == "__main__":
    main()
