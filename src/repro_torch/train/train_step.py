"""train_step factory: loss -> gradients accumulated over microbatches ->
(compressed) gradients -> AdamW, in place.

The counterpart of ``repro.train.train_step``.  The JAX package builds a
pure function and jits it with the weights donated; here the step runs
eagerly, takes the gradient with ``torch.autograd.grad`` and updates the
weights and the optimizer state in place.  With ``n_microbatch > 1`` the
batch is split along its leading axis and the gradients are summed in f32
and divided by n, as the JAX package's ``lax.scan`` does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.arch import ArchConfig, ShapeConfig
from repro_torch.core.tree import leaves, unflatten
from repro_torch.models.api import model_fns
from repro_torch.train import compression as comp
from repro_torch.train.optimizer import AdamWConfig, adamw_update


def _on(x, device: torch.device) -> torch.Tensor:
    """A batch leaf (numpy array or tensor) as a tensor on ``device``."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device)


def loss_and_grads(cfg: ArchConfig, params, plist, micro, remat: str):
    """The loss of one (micro)batch and its gradients in the weights
    ``plist`` (``leaves(params.tree())``)."""
    loss, _ = model_fns(cfg).forward_train(cfg, params, micro, remat=remat)
    # a weight the batch does not reach (the token table under an
    # embedding batch) gets zeros, as jax.grad gives it
    grads = torch.autograd.grad(loss, plist, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), grads


def apply_grads(params, opt_state: Dict[str, Any], grads, opt: AdamWConfig,
                grad_compression: Optional[str] = None):
    """(Compressed) gradients, a list in the order of ``leaves(params.
    tree())``, into one AdamW step, in place; returns (params, opt_state,
    the optimizer's metrics)."""
    grads = unflatten(params.tree(), list(grads))
    residual = None
    if grad_compression and grad_compression != "none":
        grads, residual = comp.compress_grads(
            grads, opt_state["residual"], grad_compression)
    _, opt_state, om = adamw_update(grads, opt_state, params, opt)
    if residual is not None:
        opt_state["residual"] = residual
    return params, opt_state, om


def make_train_step(cfg: ArchConfig, *, n_microbatch: int = 1,
                    remat: str = "full", opt: AdamWConfig = AdamWConfig(),
                    grad_compression: Optional[str] = None):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; ``params`` (a trainable ``ParamTree``) and
    ``opt_state`` are updated in place and returned.

    ``batch`` leaves (numpy arrays or tensors) have a leading global-batch
    axis and go to the weights' device.  With ``grad_compression`` the
    caller puts the error-feedback residual in ``opt_state["residual"]``
    (``compression.init_residual``)."""

    def train_step(params, opt_state: Dict[str, Any], batch):
        plist = leaves(params.tree())
        dev = plist[0].device
        batch = {k: _on(v, dev) for k, v in batch.items()}
        if n_microbatch > 1:
            for k, v in batch.items():
                if v.shape[0] % n_microbatch:
                    raise ValueError(f"batch[{k!r}] of {v.shape[0]} rows %"
                                     f" n_microbatch {n_microbatch} != 0")
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                   for p in plist]
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(n_microbatch):
                micro = {k: v.reshape(n_microbatch, -1, *v.shape[1:])[i]
                         for k, v in batch.items()}
                loss, grads = loss_and_grads(cfg, params, plist, micro,
                                             remat)
                for a, g in zip(acc, grads):
                    a.add_(g)
                loss_sum = loss_sum + loss
            grads = [a / n_microbatch for a in acc]
            loss = loss_sum / n_microbatch
        else:
            loss, grads = loss_and_grads(cfg, params, plist, batch, remat)
        params, opt_state, om = apply_grads(params, opt_state, grads, opt,
                                            grad_compression)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def batch_reshape_check(shape: ShapeConfig, n_microbatch: int) -> None:
    if shape.global_batch % n_microbatch:
        raise ValueError(
            f"global_batch {shape.global_batch} % n_microbatch "
            f"{n_microbatch} != 0")
