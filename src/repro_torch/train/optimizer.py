"""AdamW and SGD over a parameter tree, updating in place.

The PyTorch counterpart of ``repro.train.optimizer``, in its order of
operations: clip by the global norm, f32 moments, bias correction with
the step as f32, weight decay on every leaf (1-D norm scales included),
``p - lr * delta`` cast back to the leaf's dtype.  Where the JAX package
returns new arrays (and donates the old ones), the port updates the
weights and moments in place under ``torch.no_grad``, and returns the
same objects.

Trees are a ``ParamTree`` or nested dicts of tensors; leaves are visited
in sorted key order (``core/tree.py``), as ``jax.tree`` visits them.  The
state is ``{"m": tree, "v": tree, "step": int32 0-d tensor}``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Union

import torch

from repro_torch.core.tree import as_tree, leaves, map_tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params) -> Dict[str, Any]:
    """Zero moments of each leaf's shape, dtype and device; step 0."""
    tree = as_tree(params)
    dev = leaves(tree)[0].device
    return {"m": map_tree(torch.zeros_like, tree),
            "v": map_tree(torch.zeros_like, tree),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    sums = [l.float().square().sum() for l in leaves(tree)]
    return torch.sqrt(torch.stack(sums).sum())


# elements of one slice of a leaf's update: its f32 temporaries (about six
# of them) stay at 256 MB each, where a whole token table of 1.26 B
# weights would take six of 5 GB beside the weights, the gradients and
# both moments
_SLICE = 1 << 26


def _slices(tensors):
    """(p, g, m, v) of one leaf as aligned flat slices of ``_SLICE``
    elements (views: the in-place updates land in the leaves), or whole
    where one of them is not contiguous.  The update is elementwise, so
    the slices give the whole leaf's result bit for bit."""
    if not all(t.is_contiguous() for t in tensors):
        return [tensors]
    return zip(*(t.view(-1).split(_SLICE) for t in tensors))


@torch.no_grad()
def adamw_update(grads, state: Dict[str, Any], params, cfg: AdamWConfig,
                 lr: Union[torch.Tensor, float, None] = None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step in place: ``params``, ``state["m"]``, ``state["v"]``
    and ``state["step"]`` are updated.  ``grads`` has the params' tree.
    Returns (params, state, {"grad_norm", "lr"})."""
    lr = cfg.lr if lr is None else lr
    ptree = as_tree(params)
    dev = leaves(ptree)[0].device
    step = state["step"] + 1
    gnorm = global_norm(grads)
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
    else:
        scale = torch.ones((), device=dev)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.float()
    bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=dev) ** stepf
    bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=dev) ** stepf
    lr_t = torch.as_tensor(lr, dtype=torch.float32, device=dev)

    for leaf in zip(leaves(ptree), leaves(grads), leaves(state["m"]),
                    leaves(state["v"])):
        for p, g, m, v in _slices(leaf):
            g = g.float() * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if cfg.weight_decay > 0:
                delta = delta + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr_t * delta).to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr_t}


@torch.no_grad()
def sgd_update(grads, state, params, lr: float):
    """``p - lr * g`` in f32, cast back to p's dtype, in place."""
    for p, g in zip(leaves(as_tree(params)), leaves(grads)):
        p.copy_((p.float() - lr * g.float()).to(p.dtype))
    return params, state, {"grad_norm": global_norm(grads)}


def abstract_opt_state(abstract_params) -> Dict[str, Any]:
    """The AdamW state of ``abstract_params`` (meta tensors) on the
    ``meta`` device: moments of each leaf's shape and dtype, the step."""
    tree = as_tree(abstract_params)
    like = lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta")
    return {"m": map_tree(like, tree), "v": map_tree(like, tree),
            "step": torch.empty((), dtype=torch.int32, device="meta")}
