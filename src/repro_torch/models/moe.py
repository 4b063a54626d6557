"""Mixture-of-experts layer: top-k routing and capacity dispatch.

The counterpart of ``repro.models.moe`` on one card: the dense dispatch
``moe_layer_dense`` (Switch/GShard-style: per-token top-k, a capacity a
expert, overflow dropped), which the JAX package's ``moe_layer`` picks
wherever there is no mesh with a model axis.  The expert-parallel
all-to-all path needs more than one device and comes with slice 11.

The semantics are the reference's, exactly:

* the router logits are computed in the activation dtype and routed in
  float32; the top k come from a **stable** descending sort, so among
  equal logits the lower expert index comes first, as ``lax.top_k``
  orders them (``torch.topk`` promises no order among ties);
* ``capacity = max(round_up(int(cf * T * k / E), 128), 128)`` with T the
  call's B x S, so a chunk's pad rows and a decode step's idle slots
  are routed and take capacity like any other row;
* the (token, choice) rows are taken token-major; a row's slot is the
  count of earlier rows that chose the same expert, and a row at
  ``slot >= capacity`` lands on a scratch slot that is sliced away, so it
  contributes zero.

Nothing here reads the card from the host (no ``nonzero``, boolean
indexing or data-dependent shape): the capacity comes from shapes alone,
so a decode step with experts can be captured as a CUDA graph.  The
expert products are batched matmuls over the (E, capacity, d) buffer, as
the JAX package computes them outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.arch import ArchConfig


def route_topk(router_logits: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, E) logits -> (T, k) expert ids (int64) and their weights, the
    softmax over the k chosen logits in float32.  Ties go to the lower
    expert index."""
    logits = router_logits.float()
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    weights = torch.softmax(vals[:, :k], dim=-1)
    return idx[:, :k], weights


def _dispatch_indices(logits: torch.Tensor, k: int, e: int, capacity: int):
    """Routing bookkeeping: (T, E) logits -> (flat_e, slot_c, keep,
    weights), the (T*k,) expert of each token-major row, its slot
    (``capacity``, the scratch slot, where it is dropped), whether it is
    kept, and the (T, k) weights."""
    t = logits.shape[0]
    expert_idx, weights = route_topk(logits, k)
    flat_e = expert_idx.reshape(t * k)
    experts = torch.arange(e, device=flat_e.device)
    onehot = (flat_e[:, None] == experts).to(torch.int32)      # (T*k, E)
    pos_in_expert = torch.cumsum(onehot, dim=0) - onehot      # rows before
    slot = pos_in_expert.gather(1, flat_e[:, None])[:, 0]
    keep = slot < capacity
    slot_c = torch.where(keep, slot, capacity)
    return flat_e, slot_c, keep, weights


def _expert_ffn(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor) -> torch.Tensor:
    """(E, C, d) through each expert's SwiGLU -> (E, C, d)."""
    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    return torch.bmm(h, wd)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def moe_capacity(cfg: ArchConfig, t: int) -> int:
    """Rows a expert takes in a call of ``t`` tokens."""
    capacity = int(cfg.capacity_factor * t * cfg.experts_per_tok
                   / cfg.n_experts)
    return max(_round_up(capacity, 128), 128)


def moe_layer_dense(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  SwiGLU experts, top-k token choice:
    ``p["router"]`` (d, E), ``p["w_gate"]``/``p["w_up"]`` (E, d, f),
    ``p["w_down"]`` (E, f, d), each cast to x's dtype."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_tok
    t = b * s
    xf = x.reshape(t, d)
    logits = xf @ p["router"].to(xf.dtype)                    # (T, E)
    capacity = moe_capacity(cfg, t)
    flat_e, slot_c, keep, weights = _dispatch_indices(logits, k, e,
                                                      capacity)
    xk = xf[:, None, :].expand(t, k, d).reshape(t * k, d)
    # dropped rows all land on the scratch slot (their one duplicate
    # address), which is sliced away
    buf = xf.new_zeros((e, capacity + 1, d)).index_put(
        (flat_e, slot_c), xk)[:, :capacity]
    out_buf = _expert_ffn(buf, p["w_gate"].to(buf.dtype),
                          p["w_up"].to(buf.dtype),
                          p["w_down"].to(buf.dtype))
    # combine: gather each kept row back (the scratch slot reads zeros)
    # and weight it
    out_pad = torch.cat([out_buf, out_buf.new_zeros((e, 1, d))], dim=1)
    rows = out_pad[flat_e, slot_c]                            # (T*k, d)
    rows = rows * (weights.reshape(t * k, 1) * keep[:, None]).to(rows.dtype)
    return rows.reshape(t, k, d).sum(dim=1).reshape(b, s, d)


# one card, no mesh: the reference's ``moe_layer`` picks the dense path
moe_layer = moe_layer_dense


def aux_load_balance_loss(router_logits: torch.Tensor,
                          expert_idx: torch.Tensor, n_experts: int,
                          k: int) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (mean fraction x mean
    probability), as the reference defines it; no training loss of either
    package adds it."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    experts = torch.arange(n_experts, device=expert_idx.device)
    frac = (expert_idx[..., None] == experts).float().mean(dim=(0, 1))
    return n_experts * torch.sum(frac * probs.mean(dim=0))
