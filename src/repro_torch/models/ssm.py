"""State-space (Mamba) layers: the falcon-mamba trunk's mamba1 layer and
the zamba2 hybrid trunk's mamba2 (SSD) layer, on the serving path.

The PyTorch counterpart of ``repro.models.ssm``, with the same layouts,
dtype flow and mask/fill semantics.

mamba1: where the JAX package scans each chunk with
``lax.associative_scan``, the port runs the recurrence through
``kernels/ops.py::mamba_scan``, in order along t from the carried state:
the hand-written CUDA kernel on the card, the plain loop on the CPU.  Both
the chunk layer (``mamba1_layer``) and the one-token step
(``mamba1_decode``) call it once, so every mamba1 layer call of a serving
step launches the kernel once.

mamba2: one scalar decay a head, so a chunk's recurrence is the SSD
"matmulization": dense (L x L) products inside each chunk and a short
scan over chunk summary states.  The JAX package writes it as einsums
outside any Pallas kernel; here it is the same einsums in PyTorch
(``mamba2_layer``, which trains by autograd through them), and the
one-token step is the recurrence itself (``mamba2_decode``).

Training: ``mamba1_layer`` is differentiable through the scan's custom
operator (its backward is the ``mamba_scan_bwd`` kernel on the card), and
nothing on either layer's path writes in place into a tensor autograd
keeps.

Each layer returns its final recurrent state (``SSMState``), so that
chunked prefill hands off to decode steps.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from repro_torch.core.arch import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import rms_norm


class SSMState(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, d_inner) rolling conv inputs
    h: torch.Tensor      # f32; mamba1 (B, d_inner, ssm_state), mamba2
    #                      (B, ssm_heads, d_inner // ssm_heads, ssm_state)


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


# ---------------------------------------------------------------------------
# mamba2: the SSD chunked matmul form
# ---------------------------------------------------------------------------
def _mamba2_inputs(p: dict, x: torch.Tensor,
                   conv_tail: Optional[torch.Tensor]):
    """The input projection and the causal conv, and B, C and dt, which
    mamba2 projects from the block's normed input ``x`` (mamba1 from the
    conv output): B and C rounded to the activation dtype and then taken
    in f32, dt = softplus(x·W_dt + bias) in f32."""
    xz = x @ p["in_proj"].to(x.dtype)
    xin, z = xz.chunk(2, dim=-1)
    xc = causal_conv(xin, p["conv_w"], p["conv_b"], conv_tail)
    bmat = (x @ p["wb"].to(x.dtype)).float()
    cmat = (x @ p["wc"].to(x.dtype)).float()
    dt = F.softplus((x @ p["dt_w"].to(x.dtype)).float()
                    + p["dt_bias"].float())
    return xin, xc, z, bmat, cmat, dt


def _mamba2_out(p: dict, y: torch.Tensor, xf: torch.Tensor,
                z: torch.Tensor, cfg: ArchConfig,
                dtype: torch.dtype) -> torch.Tensor:
    """The D skip a head in f32, the SiLU gate, the gate norm and the
    output projection.  y, xf: (..., nh, P) f32."""
    y = y + xf * p["d_skip"].float()[:, None]
    y = y.reshape(*y.shape[:-2], cfg.d_inner).to(dtype) * F.silu(z)
    y = rms_norm(p["gate_norm"], y, cfg.norm_eps)
    return y @ p["out_proj"].to(y.dtype)


# a mamba2 chunk's length is a multiple of this many steps
_GRANULE = 16


def mamba2_layer(p: dict, x: torch.Tensor, cfg: ArchConfig,
                 state: Optional[SSMState] = None, chunk: int = 256,
                 mask: Optional[torch.Tensor] = None,
                 fill: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, SSMState]:
    """x: (B, S, d_model) -> (y, final_state), one scalar decay a head.
    ``mask``/``fill`` as in ``mamba1_layer``: the pad steps of a ragged
    chunk are exact no-ops on the carried state.

    S is cut into ``max(S // chunk, 1)`` chunks, the JAX package's count,
    of ``ceil(S / n)`` steps rounded up to a multiple of ``_GRANULE``: the
    tail is padded with x = 0 and dt = 0, which leaves every cumulative
    decay and chunk summary as it was, so the result is the reference's
    chunking wherever S divides evenly (the reference needs it to) and the
    same recurrence where it does not.  The pad goes on x itself, before
    the projections, and the length is rounded, so that a ragged chunk
    and its real prefix alone run every product at the same shapes: the
    pad steps then leave the state bit for bit where the prefix does."""
    bsz, s, _ = x.shape
    nh, ds = cfg.resolved_ssm_heads, cfg.ssm_state
    hp = cfg.d_inner // nh
    n = max(s // chunk, 1)
    size = -(-s // (n * _GRANULE)) * _GRANULE
    pad = n * size - s
    real = torch.arange(n * size, device=x.device) < s
    mask = real[None] if mask is None else real[None] & F.pad(mask, [0, pad])
    conv_tail = state.conv if state is not None else None
    xin, xc, z, bmat, cmat, dt = _mamba2_inputs(
        p, F.pad(x, [0, 0, 0, pad]) if pad else x, conv_tail)
    new_conv = _conv_state(conv_tail, xin[:, :s], cfg.d_conv, fill)
    dt = _mask_dt(dt, mask)                                    # (B,S,nh)
    a = -torch.exp(p["a_log"].float())                         # (nh,)

    def chunks(t):
        return t.reshape((bsz, n, size) + t.shape[2:])

    xf = xc.float().reshape(bsz, n * size, nh, hp)
    xh, dt_c, b_c, c_c = chunks(xf), chunks(dt), chunks(bmat), chunks(cmat)
    l_cum = torch.cumsum(dt_c * a, dim=2)                      # (B,n,L,nh)
    # the diagonal (intra-chunk) blocks: dense L x L products
    g = torch.einsum("bnls,bnms->bnlm", c_c, b_c)              # (B,n,L,L)
    rel = l_cum[:, :, :, None, :] - l_cum[:, :, None, :, :]    # (B,n,L,L,nh)
    tril = torch.ones(size, size, dtype=torch.bool,
                      device=x.device).tril()
    # exp of -inf above the diagonal: the same zeros as the reference's
    # where() after the exp, and a zero gradient there where exp(rel)
    # could overflow (0 x inf)
    decay = torch.exp(torch.where(tril[None, None, :, :, None], rel,
                                  rel.new_full((), float("-inf"))))
    att = g[..., None] * decay * dt_c[:, :, None, :, :]
    y_diag = torch.einsum("bnlsh,bnshp->bnlhp", att, xh)
    # the chunks' summary states and the scan over them; the chunk's
    # decay is its cumulative sum's last step, which the pad steps
    # (dt = 0) leave exactly as the last real step put it
    decay_last = torch.exp(l_cum[:, :, -1:, :] - l_cum)        # (B,n,L,nh)
    xw = xh * (dt_c * decay_last)[..., None]
    s_c = torch.einsum("bnlhp,bnls->bnhps", xw, b_c)           # (B,n,nh,P,ds)
    chunk_decay = torch.exp(l_cum[:, :, -1, :])                # (B,n,nh)
    h = (state.h if state is not None
         else x.new_zeros((bsz, nh, hp, ds), dtype=torch.float32))
    h_prevs = []
    for i in range(n):
        h_prevs.append(h)
        h = chunk_decay[:, i, :, None, None] * h + s_c[:, i]
    h_prev = torch.stack(h_prevs, dim=1)                       # (B,n,nh,P,ds)
    y_inter = torch.einsum("bnls,bnhps->bnlhp", c_c, h_prev) \
        * torch.exp(l_cum)[..., None]
    y = (y_diag + y_inter).reshape(bsz, n * size, nh, hp)
    out = _mamba2_out(p, y, xf, z, cfg, x.dtype)
    return out[:, :s], SSMState(new_conv, h)


def mamba2_decode(p: dict, x: torch.Tensor, cfg: ArchConfig,
                  state: SSMState) -> Tuple[torch.Tensor, SSMState]:
    """One step.  x: (B, 1, d_model); h = exp(dt·A)·h + dt·x ⊗ B a head,
    y = h·C, as the JAX package's decode."""
    bsz = x.shape[0]
    nh = cfg.resolved_ssm_heads
    hp = cfg.d_inner // nh
    xz = x @ p["in_proj"].to(x.dtype)
    xin, z = xz.chunk(2, dim=-1)                                # (B,1,di)
    window = torch.cat([state.conv.to(x.dtype), xin], dim=1)    # (B,k,di)
    xc = F.silu(torch.einsum("bkd,kd->bd", window, p["conv_w"].to(x.dtype))
                + p["conv_b"].to(x.dtype))                      # (B,di)
    x0 = x[:, 0]
    bmat = (x0 @ p["wb"].to(x.dtype)).float()                   # (B,ds)
    cmat = (x0 @ p["wc"].to(x.dtype)).float()
    dt = F.softplus((x0 @ p["dt_w"].to(x.dtype)).float()
                    + p["dt_bias"].float())                     # (B,nh)
    a = -torch.exp(p["a_log"].float())
    xf = xc.float().reshape(bsz, nh, hp)
    inp = torch.einsum("bhp,bs->bhps", xf * dt[..., None], bmat)
    h = torch.exp(dt * a)[..., None, None] * state.h + inp
    y = torch.einsum("bhps,bs->bhp", h, cmat)
    out = _mamba2_out(p, y[:, None], xf[:, None], z, cfg, x.dtype)
    return out, SSMState(window[:, 1:, :], h)
