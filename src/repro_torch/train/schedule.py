"""LR schedules and the paper's "learning rate finding" (§4.3).

The PyTorch counterpart of ``repro.train.schedule``: the same formulas in
f32.  ``lr_finder`` is the standard exponential sweep: run N probe steps
with exponentially increasing lr, pick the lr one decade below the
divergence knee.
"""
from __future__ import annotations

import math
from typing import Callable, List, Tuple

import numpy as np
import torch


def warmup_cosine(step, *, base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``base_lr``, then cosine decay to
    ``min_frac * base_lr`` at ``total``; a 0-d f32 tensor."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = base_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


def constant(step, *, base_lr: float) -> torch.Tensor:
    return torch.tensor(base_lr, dtype=torch.float32)


def lr_finder(step_fn: Callable[[float], float], *,
              lr_min: float = 1e-6, lr_max: float = 1.0,
              n_probe: int = 20, smooth: float = 0.7
              ) -> Tuple[float, List[Tuple[float, float]]]:
    """``step_fn(lr) -> loss`` runs one probe training step at that lr
    (the caller resets state between probes or accepts the drift, as the
    classic fastai finder does).  Returns (suggested_lr, curve)."""
    lrs = np.exp(np.linspace(np.log(lr_min), np.log(lr_max), n_probe))
    curve: List[Tuple[float, float]] = []
    ema = None
    best_lr, best_slope = lr_min, 0.0
    prev = None
    for lr in lrs:
        loss = float(step_fn(float(lr)))
        ema = loss if ema is None else smooth * ema + (1 - smooth) * loss
        curve.append((float(lr), ema))
        if prev is not None:
            slope = (ema - prev) / ema
            if slope < best_slope:
                best_slope, best_lr = slope, lr
        prev = ema
        if not np.isfinite(loss) or (curve and ema > 4 * curve[0][1]):
            break  # diverged: stop the sweep
    return float(best_lr / 10 if best_lr > lr_min else best_lr), curve
