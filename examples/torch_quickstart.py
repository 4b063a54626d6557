"""Quickstart on the PyTorch/CUDA port: the paper's end-to-end loop in
one script (the counterpart of ``examples/quickstart.py``).

data collection (synthetic keyword audio) → versioned dataset → Impulse
(MFCC DSP block + conv1d model block) → train → evaluate (confusion
matrix) → int8 quantize → per-target resource estimation → EON-compile
to a serialized artifact (a CUDA graph on the card) → performance-
calibrate the post-processing.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import estimator as est
from repro_torch.core.blocks import make_dsp_block, make_learn_block
from repro_torch.core.calibration import calibrate
from repro_torch.core.eon_compiler import compile_impulse
from repro_torch.core.impulse import Impulse
from repro_torch.data.dataset import Dataset
from repro_torch.data.synthetic import event_stream, keyword_audio

N_SAMPLES = 8000
N_CLASSES = 4


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    device = resolve_device(ap.parse_args().device)

    # 1. data: collect + version
    ds = Dataset()
    ds.add_many(keyword_audio(n_per_class=24, n_classes=N_CLASSES,
                              n_samples=N_SAMPLES))
    version = ds.commit("synthetic keywords v1")
    print(f"dataset {version}: {len(ds)} samples, "
          f"classes={ds.class_counts()}")

    # 2. impulse: DSP block + learn block
    imp = Impulse(make_dsp_block("mfcc", n_mels=32, n_coeffs=10),
                  make_learn_block("conv1d-stack", n_blocks=2, ch_first=16,
                                   ch_last=64, n_classes=N_CLASSES),
                  input_shape=N_SAMPLES, device=device)
    imp.init(torch.Generator(device=device).manual_seed(0))

    # 3. train + evaluate
    xtr, ytr = ds.arrays("train")
    xte, yte = ds.arrays("test")
    imp.fit((np.asarray(xtr), np.asarray(ytr)), epochs=6, batch_size=16,
            lr=2e-3, log_every=2)
    acc = imp.evaluate(imp.params, np.asarray(xte), np.asarray(yte))
    print(f"float test accuracy: {acc:.3f}")
    print("confusion matrix:\n",
          imp.confusion_matrix(np.asarray(xte), np.asarray(yte), N_CLASSES))

    # 4. quantize (paper C5)
    imp.quantize(np.asarray(xtr[:16]))
    acc8 = imp.int8_accuracy(np.asarray(xte), np.asarray(yte))
    print(f"int8 test accuracy: {acc8:.3f} "
          f"(weights {imp.qparams.meta['compression']:.1f}x smaller)")

    # 5. estimate per target (paper C2)
    for target in est.TARGETS:
        e = est.estimate_impulse(imp, target, engine="eon", int8=True)
        print(f"{target:10s}: dsp={e.dsp_latency_ms:6.1f}ms "
              f"nn={e.nn_latency_ms:5.1f}ms ram={e.ram_kb:6.1f}kB "
              f"flash={e.flash_kb:6.1f}kB fits={e.fits}")

    # 6. EON-compile: interpreter-less deployment artifact (paper C4)
    art = compile_impulse(imp, batch_size=1, int8=True)
    print(f"deploy artifact: {art.artifact_bytes} bytes, "
          f"compile {art.compile_time_s:.1f}s")

    # 7. performance calibration (paper C6)
    scores, spans = event_stream(n_windows=10_000, n_events=40)
    front = calibrate(scores, spans, generations=8, population=20)
    print("post-processing Pareto front (FAR/h vs FRR):")
    for p in front[:5]:
        print(f"  far={p['far_per_hour']:6.1f}/h frr={p['frr']:.3f} "
              f"cfg={p['config']}")


if __name__ == "__main__":
    main()
