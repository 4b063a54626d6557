"""State-space (Mamba1) layers: the falcon-mamba trunk's serving path.

The PyTorch counterpart of ``repro.models.ssm``'s mamba1 layer, with the
same layouts, dtype flow and mask/fill semantics.  Where the JAX package
scans each chunk with ``lax.associative_scan``, the port runs the
recurrence through ``kernels/ops.py::mamba_scan``, in order along t from
the carried state: the hand-written CUDA kernel on the card, the plain
loop on the CPU.  Both the chunk layer (``mamba1_layer``) and the one-token
step (``mamba1_decode``) call it once, so every mamba layer call of a
serving step launches the kernel once.

Each layer returns its final recurrent state (``SSMState``), so that
chunked prefill hands off to decode steps.  mamba2 (the zamba2 hybrid)
comes with slice 8.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from repro_torch.core.arch import ArchConfig
from repro_torch.kernels import ops


class SSMState(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, d_inner) rolling conv inputs
    h: torch.Tensor      # (B, d_inner, ssm_state) f32


# the name under which ``torch.export`` serializes a deployed decode
# step's state
pytree._register_namedtuple(
    SSMState, serialized_type_name="repro_torch.models.ssm.SSMState")


def _mask_dt(dt: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero the step size at masked (pad) steps: ``dt == 0`` makes the
    recurrence an exact identity (decay ``exp(0·a) == 1``, input term
    ``dt·x·b == 0``), so a ragged chunk's pad tail never touches the
    carried state."""
    if mask is None:
        return dt
    return dt * mask.to(dt.dtype)[..., None]


def _conv_state(prev: Optional[torch.Tensor], xin: torch.Tensor, k: int,
                fill: Optional[torch.Tensor]) -> torch.Tensor:
    """Next rolling conv window: the last ``k−1`` *real* inputs.

    prev: (B, k−1, di) carry-in (zeros when None); xin: (B, S, di);
    ``fill`` (B,) counts the real (non-pad) inputs per row; pad rows sit
    at the tail, so the window is ``cat[fill : fill + k − 1]`` per row
    (``cat[S : S + k − 1]`` when no ragged chunk is in play)."""
    bsz, s, di = xin.shape
    if prev is None:
        prev = xin.new_zeros((bsz, k - 1, di))
    cat = torch.cat([prev.to(xin.dtype), xin], dim=1)
    if fill is None:
        return cat[:, s:s + k - 1]
    start = fill.long().clamp(0, s)
    rows = start[:, None] + torch.arange(k - 1, device=xin.device)
    return cat[torch.arange(bsz, device=xin.device)[:, None], rows]


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv, k taps as shifts: x (B, S, di); w (k, di);
    tail (B, k−1, di) carry-in (zeros when None)."""
    k = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, j:j + s, :] * w[j].to(x.dtype) for j in range(k))
    return F.silu(out + b.to(x.dtype))


def _dt_b_c(p: dict, xc: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Step sizes ``softplus(xc·W_dt·W_proj + bias)`` and the B and C
    projections, all in the activation dtype."""
    dt = F.softplus((xc @ p["x_dt"].to(xc.dtype)) @ p["dt_proj"].to(xc.dtype)
                    + p["dt_bias"].to(xc.dtype))
    return dt, xc @ p["wb"].to(xc.dtype), xc @ p["wc"].to(xc.dtype)


def _out(p: dict, y: torch.Tensor, xc: torch.Tensor, z: torch.Tensor,
         dtype: torch.dtype) -> torch.Tensor:
    """The D skip in f32, the SiLU gate and the output projection."""
    y = y + xc.float() * p["d_skip"].float()
    y = y.to(dtype) * F.silu(z)
    return y @ p["out_proj"].to(y.dtype)


def mamba1_layer(p: dict, x: torch.Tensor, cfg: ArchConfig,
                 state: Optional[SSMState] = None,
                 mask: Optional[torch.Tensor] = None,
                 fill: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, SSMState]:
    """x: (B, S, d_model) -> (y, final_state).

    ``mask`` (B, S) marks real steps (1) against pad steps (0) and ``fill``
    (B,) counts the real steps per row, both optional, supplied by the
    chunked-prefill path so that a ragged final chunk's pad tail leaves the
    recurrent and conv state exactly where the last real token put them."""
    xz = x @ p["in_proj"].to(x.dtype)
    xin, z = xz.chunk(2, dim=-1)
    conv_tail = state.conv if state is not None else None
    xc = causal_conv(xin, p["conv_w"], p["conv_b"], conv_tail)
    new_conv = _conv_state(conv_tail, xin, cfg.d_conv, fill)
    dt, bmat, cmat = _dt_b_c(p, xc)
    dt = _mask_dt(dt, mask)
    a = -torch.exp(p["a_log"].float())                          # (di, ds)
    y, h_final = ops.mamba_scan(xc, dt, bmat, cmat, a,
                                None if state is None else state.h)
    return _out(p, y, xc, z, x.dtype), SSMState(new_conv, h_final)


def mamba1_decode(p: dict, x: torch.Tensor, cfg: ArchConfig,
                  state: SSMState) -> Tuple[torch.Tensor, SSMState]:
    """One step.  x: (B, 1, d_model); the state step is the scan at S = 1
    from the slot's state, the arithmetic of the JAX package's decode."""
    xz = x @ p["in_proj"].to(x.dtype)
    xin, z = xz.chunk(2, dim=-1)                                # (B,1,di)
    window = torch.cat([state.conv.to(x.dtype), xin], dim=1)    # (B,k,di)
    xc = F.silu(torch.einsum("bkd,kd->bd", window, p["conv_w"].to(x.dtype))
                + p["conv_b"].to(x.dtype))[:, None, :]          # (B,1,di)
    dt, bmat, cmat = _dt_b_c(p, xc)
    a = -torch.exp(p["a_log"].float())
    y, h = ops.mamba_scan(xc, dt, bmat, cmat, a, state.h)
    return _out(p, y, xc, z, x.dtype), SSMState(window[:, 1:, :], h)
