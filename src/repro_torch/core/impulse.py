"""The Impulse (paper C1): DSP block + learn block as one trainable,
quantizable, deployable unit, the object the platform's stages consume.

The counterpart of ``repro.core.impulse``: ``init``, ``features``,
``logits``, ``logits_int8``, ``loss_fn``, ``fit``, ``evaluate``,
``confusion_matrix``, ``quantize`` and ``int8_accuracy``.  An Impulse
lives on one device, ``cuda`` unless ``device="cpu"`` is given; raw input
(numpy arrays or tensors) is moved there as float32.  ``fit`` trains the
learn block with the port's AdamW (``train/optimizer.py``) in float32:
cuDNN's TF32 is off over each step's forward and backward.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core import quantize as qz
from repro_torch.core import tree
from repro_torch.core.blocks import DSPBlock, LearnBlock
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update


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

    # ------------------------------------------------------------------
    def loss_fn(self, params, raw, labels):
        """(mean NLL, {"loss", "acc"}) of one batch.  The features take no
        gradient (the DSP block has no weights); the learn block does."""
        with torch.no_grad():
            feats = self.features(raw)
        logits = self.learn.apply(params, feats)
        labels = torch.as_tensor(labels, dtype=torch.long,
                                 device=logits.device)
        nll = -F.log_softmax(logits, -1).gather(1, labels[:, None]).mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        return nll, {"loss": nll.detach(), "acc": acc}

    def train_step(self, params, opt_state, opt_cfg: AdamWConfig, raw,
                   labels) -> Dict[str, torch.Tensor]:
        """One AdamW step on ``params`` (a tree whose leaves require grad)
        and ``opt_state``, in place; returns the batch's metrics as
        tensors.  cuDNN's TF32 stays off over the backward as well as the
        forward (the learn blocks turn it off only while they run), and the
        caller's setting is restored after."""
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            nll, metrics = self.loss_fn(params, raw, labels)
            grads = torch.autograd.grad(nll, tree.leaves(params))
        finally:
            torch.backends.cudnn.allow_tf32 = prev
        adamw_update(tree.unflatten(params, list(grads)), opt_state, params,
                     opt_cfg)
        return metrics

    def fit(self, train_data, *, epochs: int = 5, batch_size: int = 32,
            lr: float = 1e-3, generator: Optional[torch.Generator] = None,
            eval_data=None, log_every: int = 0) -> Dict[str, Any]:
        """Minimal in-memory training loop for platform-scale (KWS-size)
        models, the JAX package's: AdamW (lr, no weight decay, clip 1.0),
        each epoch's order from one ``RandomState(0)``, the tail partial
        batch kept, per-epoch mean ``loss`` and ``acc`` over the batches
        and ``val_acc`` on ``eval_data``.  Without weights, ``init`` draws
        them from ``generator`` (default: seed 0 on the Impulse's device).
        The training set is moved to the device once; the weights are
        trained on a copy, which replaces ``params`` at the end."""
        if self.params is None:
            self.init(generator if generator is not None else
                      torch.Generator(device=self.device).manual_seed(0))
        xs, ys = train_data
        n = xs.shape[0]
        xs = torch.as_tensor(xs, dtype=torch.float32, device=self.device)
        ys = torch.as_tensor(ys, dtype=torch.long, device=self.device)
        opt_cfg = AdamWConfig(lr=lr, weight_decay=0.0, grad_clip=1.0)
        params = tree.map_tree(
            lambda t: t.detach().clone().requires_grad_(True), self.params)
        opt_state = adamw_init(params)

        history = []
        rng = np.random.RandomState(0)
        for ep in range(epochs):
            order = torch.from_numpy(rng.permutation(n)).to(self.device)
            losses, accs = [], []
            # include the tail partial batch: platform-scale datasets are
            # tiny, so dropping it costs a large fraction of the steps
            for i in range(0, n, batch_size):
                idx = order[i:i + batch_size]
                m = self.train_step(params, opt_state, opt_cfg, xs[idx],
                                    ys[idx])
                losses.append(m["loss"])
                accs.append(m["acc"])
            # read once an epoch, summed in step order as the JAX package
            # sums them
            nb = max(len(losses), 1)
            rec = {"epoch": ep, "loss": sum(map(float, losses)) / nb,
                   "acc": sum(map(float, accs)) / nb}
            if eval_data is not None:
                rec["val_acc"] = float(self.evaluate(params, *eval_data))
            history.append(rec)
            if log_every and ep % log_every == 0:
                print(rec)
        for t in tree.leaves(params):
            t.requires_grad_(False)
        self.params = params
        return {"history": history, "final": history[-1] if history else {}}

    # ------------------------------------------------------------------
    def _correct(self, logits: torch.Tensor, ys) -> int:
        labels = torch.as_tensor(ys, dtype=torch.long, device=logits.device)
        return int((logits.argmax(-1) == labels).sum())

    @torch.no_grad()
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
