"""The Impulse (paper C1): DSP block + learn block as one quantizable,
deployable unit, the object the platform's stages consume.

The counterpart of ``repro.core.impulse``'s inference path: ``init``,
``features``, ``logits``, ``logits_int8``, ``evaluate``,
``confusion_matrix``, ``quantize`` and ``int8_accuracy``.  An Impulse
lives on one device, ``cuda`` unless ``device="cpu"`` is given; raw input
(numpy arrays or tensors) is moved there as float32.  Training (``fit``)
comes with port slice 6 (the platform loop).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import quantize as qz
from repro_torch.core.blocks import DSPBlock, LearnBlock


@dataclasses.dataclass
class Impulse:
    dsp: DSPBlock
    learn: LearnBlock
    input_shape: Any                     # samples (audio) or (H, W, C)
    params: Optional[Any] = None
    qparams: Optional[qz.QuantizedParams] = None
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> "Impulse":
        """Random weights drawn from ``generator``, which must live on the
        Impulse's device."""
        feat_shape = self.dsp.feature_shape(self.input_shape)
        self.params = self.learn.init(generator, feat_shape, self.device)
        return self

    def features(self, raw) -> torch.Tensor:
        return self.dsp.apply(torch.as_tensor(raw, dtype=torch.float32,
                                              device=self.device))

    def logits(self, raw, params=None) -> torch.Tensor:
        feats = self.features(raw)
        return self.learn.apply(params if params is not None else self.params,
                                feats)

    def logits_int8(self, raw) -> torch.Tensor:
        """Quantized inference path (paper C5): DSP stays float, the NN
        runs on the int8 weights (dequantized), matching the platform's
        deployment split."""
        if self.qparams is None:
            raise RuntimeError("run quantize() first")
        feats = self.features(raw)
        return self.learn.apply(qz.fake_quant_params(self.qparams), feats)

    def fit(self, *args, **kwargs):
        raise NotImplementedError(
            "Impulse.fit (training with AdamW) comes with port slice 6"
            " (the platform loop)")

    # ------------------------------------------------------------------
    def _correct(self, logits: torch.Tensor, ys) -> int:
        labels = torch.as_tensor(ys, dtype=torch.long, device=logits.device)
        return int((logits.argmax(-1) == labels).sum())

    def evaluate(self, params, xs, ys, batch_size: int = 64) -> float:
        correct, total = 0, 0
        for i in range(0, xs.shape[0], batch_size):
            logits = self.learn.apply(params, self.features(
                xs[i:i + batch_size]))
            correct += self._correct(logits, ys[i:i + batch_size])
            total += int(logits.shape[0])
        return correct / max(total, 1)

    def confusion_matrix(self, xs, ys, n_classes: int) -> np.ndarray:
        preds = self.logits(xs).argmax(-1).cpu().numpy()
        cm = np.zeros((n_classes, n_classes), np.int64)
        ys = ys.cpu().numpy() if isinstance(ys, torch.Tensor) \
            else np.asarray(ys)
        for t, p in zip(ys, preds):
            cm[t, p] += 1
        return cm

    # ------------------------------------------------------------------
    def quantize(self, calib_raw) -> "Impulse":
        """Post-training int8 quantization of the weights.  ``calib_raw``
        is the calibration data of the JAX package's signature; the
        weight-only PTQ reads no activations, so it is not run through
        the DSP block (the JAX package computes its features and drops
        them)."""
        self.qparams = qz.quantize_params(self.params)
        return self

    def int8_accuracy(self, xs, ys, batch_size: int = 64) -> float:
        correct = 0
        for i in range(0, xs.shape[0], batch_size):
            logits = self.logits_int8(xs[i:i + batch_size])
            correct += self._correct(logits, ys[i:i + batch_size])
        return correct / xs.shape[0]
