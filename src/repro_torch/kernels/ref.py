"""Plain PyTorch versions of the kernels (the correctness contracts).

Each function is the definition its CUDA kernel must reproduce: the CPU
path of ``kernels/ops.py`` runs it, and ``chip_smoke.py`` holds each
kernel against it on the card.  Semantics are those of
``repro.kernels.ref``: the int8 matmul, attention over the contiguous
or paged KV cache in float or int8 (``Int8KV``) form, the mel
frontend of the DSP blocks, whole-sequence attention (training), and the
selective scan of the mamba1 layers.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import flags

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# int8 matmul with per-channel dequant (paper C5: full int8 inference)
# ---------------------------------------------------------------------------
def int8_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                    x_scale: torch.Tensor, w_scale: torch.Tensor
                    ) -> torch.Tensor:
    """x_q: (M, K) int8; w_q: (N, K) int8 (output channel first, the
    port's ``QTensor`` layout); x_scale: (M,) f32 per row; w_scale: (N,)
    f32 per output channel.  Returns f32 (M, N):
    ``float(acc) * (x_scale[m] * w_scale[n])`` with ``acc`` the exact
    int32 dot product.

    The sum is exact on either device: int32 on the CPU; on the card,
    where ``torch.matmul`` has no integer path, float64, which holds every
    integer below 2^53, so every partial sum of K < 2^39 int8 products
    (each at most 2^14 in size) exactly, in any order."""
    if x_q.device.type == "cpu":
        acc = x_q.to(torch.int32) @ w_q.to(torch.int32).t()
    else:
        if x_q.shape[1] >= 2 ** 39:
            raise ValueError(f"K {x_q.shape[1]} >= 2^39: the float64 sum"
                             " is exact only below it")
        acc = x_q.double() @ w_q.double().t()
    scale = x_scale[:, None] * w_scale[None, :]
    return acc.float() * scale


# ---------------------------------------------------------------------------
# flash attention (causal, optional sliding window): the training path
# ---------------------------------------------------------------------------
def _check_lengths(sq: int, skv: int, causal: bool, window: int,
                   positions: bool = False) -> None:
    """Keys of another length than the queries only where every key is
    visible, or where positions say which are: an index mask between two
    sequences of different length (a diagonal, a window) means nothing."""
    if sq != skv and (causal or window > 0) and not positions:
        raise ValueError(f"queries of {sq} against keys of {skv}: another"
                         " key length is taken only with causal=False and"
                         " window == 0, or with positions")


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        q_pos: Optional[torch.Tensor] = None,
                        k_pos: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D).  The JAX package's
    ``flash_attention_ref`` after ``ops.flash_attention``'s GQA expansion
    (query head h reads KV head h // (Hq // Hkv)): index masks (key j
    visible to row i when ``j <= i`` if causal, and ``j > i - window`` with
    a window), f32 math, output in q.dtype.  Skv may differ from Sq only
    with ``causal=False`` and ``window == 0`` (cross-attention: every key
    visible).

    With ``q_pos`` (B, Sq) and ``k_pos`` (B, Skv) int the masks are the
    reference's ``full_attention`` masks (``repro/models/layers.py:150``)
    instead, by position: key j visible to row i when ``k_pos[j] >= 0``,
    ``k_pos[j] <= q_pos[i]`` if causal and ``k_pos[j] > q_pos[i] - window``
    with a window, any Sq and Skv.  A masked score is the finite −1e30, as
    there, so a row that sees no key (a pad query at −1) gets the mean of V
    over all Skv keys.  Autograd through it is the plain backward."""
    return flash_attention_fwd_ref(q, k, v, causal, window, q_pos, k_pos,
                                   lse=False)[0]


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True,
                            window: int = 0,
                            q_pos: Optional[torch.Tensor] = None,
                            k_pos: Optional[torch.Tensor] = None,
                            lse: bool = True
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version of the forward kernel: ``flash_attention_ref``'s
    output and (``lse``) the rows' log-sum-exp of the masked, scaled
    scores (B, Hq, Sq) f32, as the kernel writes it for its backward.

    Under the flag ``bf16_attn_p`` (``flags.py``) P is taken in V's dtype
    for the PV product, as the reference's jnp chunked attention takes it
    (``repro/models/layers.py:211``); the sum stays f32."""
    g = q.shape[2] // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    scores, _ = _attention_scores(q.float(), k.float(), causal, window,
                                  q_pos, k_pos)
    p = torch.softmax(scores, dim=-1)
    if flags.get("bf16_attn_p") and v.dtype != torch.float32:
        out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).float()
    else:
        out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype), (torch.logsumexp(scores, dim=-1) if lse
                             else None)


def attention_mask(sq: int, skv: int, causal: bool, window: int,
                   q_pos: Optional[torch.Tensor] = None,
                   k_pos: Optional[torch.Tensor] = None,
                   device=None) -> Optional[torch.Tensor]:
    """The visible (query, key) pairs: (Sq, Skv) bool by index, (B, 1, Sq,
    Skv) by position (``q_pos`` and ``k_pos`` given), or None when every
    key is visible (no positions, ``causal=False``, no window)."""
    if (q_pos is None) != (k_pos is None):
        raise ValueError("q_pos and k_pos come together")
    _check_lengths(sq, skv, causal, window, q_pos is not None)
    if q_pos is not None:
        qp = q_pos.to(torch.int64)[:, None, :, None]
        kp = k_pos.to(torch.int64)[:, None, None, :]
        mask = kp >= 0
    elif not causal and window <= 0:
        return None
    else:
        idx = torch.arange(sq, device=device)
        qp, kp = idx[:, None], idx[None, :]
        mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & (kp > qp - window)
    return mask


def _attention_scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
                      window: int, q_pos: Optional[torch.Tensor] = None,
                      k_pos: Optional[torch.Tensor] = None):
    """q·kᵀ·D^-1/2, a masked score −1e30 under ``attention_mask``'s masks,
    (B, H, Sq, Skv), and the mask (None: every key visible); q (B, Sq, H,
    D) and k (B, Skv, H, D) with the KV heads expanded."""
    sq, skv, d = q.shape[1], k.shape[1], q.shape[3]
    mask = attention_mask(sq, skv, causal, window, q_pos, k_pos, q.device)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * (d ** -0.5)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    return scores, mask


def _attention_probs(q: torch.Tensor, k: torch.Tensor, causal: bool,
                     window: int, q_pos: Optional[torch.Tensor] = None,
                     k_pos: Optional[torch.Tensor] = None):
    """softmax of ``_attention_scores``, and the mask."""
    scores, mask = _attention_scores(q, k, causal, window, q_pos, k_pos)
    return torch.softmax(scores, dim=-1), mask


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            dout: torch.Tensor, causal: bool = True,
                            window: int = 0,
                            q_pos: Optional[torch.Tensor] = None,
                            k_pos: Optional[torch.Tensor] = None):
    """The plain version of the backward kernel: (dq, dk, dv) of
    ``flash_attention_ref``'s output against ``dout``, in f32 math,
    returned in q.dtype.  P is rebuilt from q and k; the row sums
    ``Dr = rowsum(dout * out)`` come from the ``out`` given, as the kernel
    takes them from its saved (rounded) output:

        dV = Pᵀ dO,  dS = M ∘ P ∘ (dO Vᵀ − Dr),  dQ = D^-1/2 dS K,
        dK = D^-1/2 dSᵀ Q,

    with M the mask (a masked score is a constant, so no gradient reaches
    it: a row that sees no key adds its uniform P to dV alone).  dK and dV
    are summed over the query heads that share a KV head; dq of q's shape
    (B, Sq, Hq, D), dk/dv of k's (B, Skv, Hkv, D).  Given the f32 output
    of ``flash_attention_ref`` this is autograd through it."""
    b, _, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, out, dout))
    kf, vf = kf.repeat_interleave(g, dim=2), vf.repeat_interleave(g, dim=2)
    p, mask = _attention_probs(qf, kf, causal, window, q_pos, k_pos)
    rowdot = (dof * of).sum(-1).transpose(1, 2)            # (B, H, Sq)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - rowdot[..., None])
    if mask is not None:
        ds = torch.where(mask, ds, 0.0)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * (d ** -0.5)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * (d ** -0.5)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk, dv = (t.reshape(b, skv, hkv, g, d).sum(3) for t in (dk, dv))
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


def flash_attention_vjp_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, dout: torch.Tensor,
                            causal: bool = True, window: int = 0,
                            q_pos: Optional[torch.Tensor] = None,
                            k_pos: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of ``flash_attention_ref``'s output against ``dout``
    as autograd forms them through it, bit for bit: P rebuilt as the
    forward builds it, the softmax's own backward (``dS = P ∘ (dP −
    rowsum(dP ∘ P))``), the mask, the scale, the products, and the
    expanded KV heads' gradients cast to the inputs' dtype before their
    groups are summed.  The CPU implementation of the backward operator
    (``ops.py``), where autograd cannot record; unlike
    ``flash_attention_bwd_ref`` (the kernel's contract) it reads neither
    the forward's output nor its lse.

    Under the flag ``bf16_attn_p`` it differentiates the forward's cast as
    autograd does: dV from P in V's dtype, and dP = dO Vᵀ in V's dtype."""
    b, _, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    if g > 1:
        kf, vf = kf.repeat_interleave(g, dim=2), vf.repeat_interleave(g, dim=2)
    scores, mask = _attention_scores(qf, kf, causal, window, q_pos, k_pos)
    p = torch.softmax(scores, dim=-1)
    if flags.get("bf16_attn_p") and v.dtype != torch.float32:
        vb = v.repeat_interleave(g, dim=2) if g > 1 else v
        dob = dout.to(v.dtype)
        dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype), dob)
        dp = torch.einsum("bqhd,bkhd->bhqk", dob, vb).float()
    else:
        dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = torch.ops.aten._softmax_backward_data(dp, p, -1, torch.float32)
    if mask is not None:
        ds = torch.where(mask, ds, 0.0)
    ds = ds * (d ** -0.5)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dk, dv = (t.to(q.dtype).reshape(b, skv, hkv, g, d).sum(3)
              for t in (dk, dv))
    return dq.to(q.dtype), dk, dv


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_position: torch.Tensor,
                         cache_positions: torch.Tensor, *, window: int = 0,
                         kv_len: Optional[torch.Tensor] = None,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """One-token decode against a KV cache: the C == 1 case of
    ``chunk_attention_ref``.

    q: (B, 1, Hq, D); k/v: (B, S, Hkv, D) float, or int8 with
    ``k_scale``/``v_scale`` (B, S, Hkv) f32; q_position: (B,);
    cache_positions: (B, S), −1 marking invalid entries; ``kv_len`` (B,)
    optionally bounds each slot's valid region by index.  A slot with no
    valid entry returns exact zeros.
    """
    return chunk_attention_ref(q, k, v, q_position[:, None], cache_positions,
                               window=window, kv_len=kv_len, k_scale=k_scale,
                               v_scale=v_scale)


def chunk_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_positions: torch.Tensor,
                        cache_positions: torch.Tensor, *, window: int = 0,
                        kv_len: Optional[torch.Tensor] = None,
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Chunk-prefill attention: C queries per slot against the slot's cache.

    q: (B, C, Hq, D); k/v: (B, S, Hkv, D) float, or int8 values with
    ``k_scale``/``v_scale`` (B, S, Hkv) f32 per-(entry, head) scales,
    dequantized to q's dtype (``value * scale`` in f32, rounded once);
    q_positions: (B, C) absolute positions (−1 marks a pad query, whose
    row is exact zeros); cache_positions: (B, S) stored positions (−1
    invalid); ``kv_len`` (B,) optionally bounds the live region by index.
    An entry is valid when ``pos >= 0``, ``pos <= q_pos``, ``idx < kv_len``
    and, with a window, ``pos > q_pos - window``.  Grouped-query GQA: the
    KV heads are never repeated.  Scores and softmax in float32; output in
    ``v.dtype`` (q's dtype for an int8 cache).
    """
    if k_scale is not None:
        k = (k.float() * k_scale[..., None]).to(q.dtype)
        v = (v.float() * v_scale[..., None]).to(q.dtype)
    if kv_len is not None:
        # entries past kv_len are not read (the kernels never load them):
        # whatever a recycled or unmapped row holds stays out of P·V
        live = torch.arange(k.shape[1], device=k.device)[None, :] \
            < kv_len[:, None].to(torch.int64)
        k = torch.where(live[:, :, None, None], k, 0)
        v = torch.where(live[:, :, None, None], v, 0)
    b, c, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = (q * d ** -0.5).reshape(b, c, hkv, g, d)
    scores = torch.einsum("bchgd,bkhd->bchgk", qg.float(), k.float())

    kp = cache_positions[:, None, :]                        # (B, 1, S)
    qp = q_positions[:, :, None]                            # (B, C, 1)
    valid = (kp >= 0) & (kp <= qp)
    if window > 0:
        valid &= kp > qp - window
    if kv_len is not None:
        idx = torch.arange(s, device=k.device, dtype=torch.int32)
        valid &= idx[None, None, :] < kv_len[:, None, None].to(torch.int32)
    vmask = valid[:, :, None, None, :]                      # (B,C,1,1,S)
    scores = torch.where(vmask, scores, NEG_INF)

    # masked softmax: a row with no valid key (a pad query, or an empty
    # slot) gives exact zeros instead of a mean over garbage
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m) * vmask
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bchgk,bkhd->bchgd", p.to(v.dtype), v)
    return o.reshape(b, c, hq, d)


# ---------------------------------------------------------------------------
# Paged KV pool (block-table indirection)
# ---------------------------------------------------------------------------
def gather_kv_pages(pool: torch.Tensor, block_table: torch.Tensor
                    ) -> torch.Tensor:
    """A slot-contiguous copy of a paged pool.

    pool: (NB, BS, ...); block_table: (B, n) int32, slot ``b``'s logical
    block ``j`` in physical block ``block_table[b, j]``.  Returns
    (B, n * BS, ...): logical entry ``i`` of slot ``b`` is
    ``pool[table[b, i // BS], i % BS]``.  Entries past a slot's kv_len
    come from whatever block the table names there; the caller's kv_len
    masks them, as in the kernel."""
    b, n = block_table.shape
    pages = pool[block_table.long()]                 # (B, n, BS, ...)
    return pages.reshape((b, n * pool.shape[1]) + tuple(pool.shape[2:]))


def paged_chunk_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor,
                              q_positions: torch.Tensor,
                              pool_positions: torch.Tensor,
                              block_table: torch.Tensor,
                              kv_len: torch.Tensor, *, window: int = 0,
                              k_scale: Optional[torch.Tensor] = None,
                              v_scale: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """``chunk_attention_ref`` over a paged pool: gather each operand
    through the block table, then delegate.  ``kv_len`` is mandatory: it
    is what fences a slot off from the blocks its table tail names."""
    k = gather_kv_pages(k_pool, block_table)
    v = gather_kv_pages(v_pool, block_table)
    cache_positions = gather_kv_pages(pool_positions, block_table)
    if k_scale is not None:
        k_scale = gather_kv_pages(k_scale, block_table)
        v_scale = gather_kv_pages(v_scale, block_table)
    return chunk_attention_ref(
        q, k, v, q_positions, cache_positions, window=window,
        kv_len=kv_len, k_scale=k_scale, v_scale=v_scale)


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               q_position: torch.Tensor,
                               pool_positions: torch.Tensor,
                               block_table: torch.Tensor,
                               kv_len: torch.Tensor, *, window: int = 0,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Decode (C == 1) case of ``paged_chunk_attention_ref``."""
    return paged_chunk_attention_ref(
        q, k_pool, v_pool, q_position[:, None], pool_positions,
        block_table, kv_len, window=window, k_scale=k_scale,
        v_scale=v_scale)


# ---------------------------------------------------------------------------
# mel frontend (window -> DFT as two products -> power -> mel -> log)
# ---------------------------------------------------------------------------
# the floor under the mel energies before the log, as the JAX package's
LOG_FLOOR = 1e-6


def mel_frontend_ref(frames: torch.Tensor, window: torch.Tensor,
                     dft_cos: torch.Tensor, dft_sin: torch.Tensor,
                     mel_fb: torch.Tensor) -> torch.Tensor:
    """frames: (..., F, L), any strides (an ``unfold`` view of the signal
    included); window: (L,); dft_cos/sin: (L, nbins); mel_fb: (nbins,
    n_mels).  Returns the log-mel energies (..., F, n_mels) in f32:
    ``log(max(((x * window) @ cos)^2 + ((x * window) @ sin)^2) @ mel,
    LOG_FLOOR))``."""
    xw = frames.float() * window.float()
    re = xw @ dft_cos.float()
    im = xw @ dft_sin.float()
    power = re * re + im * im
    mel = power @ mel_fb.float()
    return torch.log(torch.clamp(mel, min=LOG_FLOOR))


# ---------------------------------------------------------------------------
# selective scan (mamba1-style diagonal SSM)
# ---------------------------------------------------------------------------
def _widen(t: torch.Tensor) -> torch.Tensor:
    """f32 for bf16 and f32, f64 left as it is."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def mamba_scan_ref(x: torch.Tensor, dt: torch.Tensor, b_mat: torch.Tensor,
                   c_mat: torch.Tensor, a: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x/dt: (B, S, D); b_mat/c_mat: (B, S, N); a: (D, N), negative; h0:
    (B, D, N) carried-in state (zeros when None).  A loop over time in
    f32, the inputs widened first:

        h[t] = exp(dt[t] * a) * h[t-1] + (dt[t] * x[t]) * b[t]
        y[t] = sum_n h[t, :, n] * c[t, n]

    Returns (y (B, S, D) f32, h_final (B, D, N) f32).  ``dt == 0`` leaves
    the state exactly as it was (``exp(0) == 1``, input term 0).  Float64
    inputs stay float64 (``gradcheck``)."""
    bsz, s, d = x.shape
    n = b_mat.shape[-1]
    xf, dtf, bf, cf, af = (_widen(t) for t in (x, dt, b_mat, c_mat, a))
    h = (torch.zeros((bsz, d, n), dtype=xf.dtype, device=x.device)
         if h0 is None else _widen(h0))
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t, :, None] * af)
        h = decay * h + (dtf[:, t] * xf[:, t])[:, :, None] * bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    return torch.stack(ys, dim=1), h


def mamba_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor,
                       b_mat: torch.Tensor, c_mat: torch.Tensor,
                       a: torch.Tensor, h0: Optional[torch.Tensor],
                       dy: torch.Tensor, dh_final: Optional[torch.Tensor]
                       ) -> Tuple[torch.Tensor, ...]:
    """The gradients of ``mamba_scan_ref`` against ``dy`` (B, S, D) f32
    and ``dh_final`` (B, D, N) f32 (zeros when None), as an explicit
    reverse sweep over t.  With decay[t] = exp(dt[t] a) and g the
    gradient of h[t], carried from g = dh_final at t = S:

        g[t]   = decay[t+1] g[t+1] + dy[t] ⊗ C[t]
        dC[t]  = sum_d dy[t] h[t]
        dB[t]  = sum_d g[t] (dt[t] x[t])
        dx[t]  = dt[t] sum_n g[t] B[t]
        ddt[t] = x[t] sum_n g[t] B[t] + sum_n g[t] h[t-1] decay[t] a
        dA     = sum_{b,t} g[t] h[t-1] decay[t] dt[t]
        dh0    = decay[0] g[0]

    h[t-1] comes from the forward recurrence, run first; nothing divides
    by a decay (exp(dt a) underflows to 0).  Returns (dx, ddt, dB, dC) in
    x's dtype and (dA (D, N), dh0 (B, D, N)) in f32 (f64 for f64 inputs)."""
    bsz, s, d = x.shape
    n = b_mat.shape[-1]
    xf, dtf, bf, cf, af, dyf = (_widen(t)
                                for t in (x, dt, b_mat, c_mat, a, dy))
    h = (torch.zeros((bsz, d, n), dtype=xf.dtype, device=x.device)
         if h0 is None else _widen(h0))
    hs = [h]                                   # hs[t] = h[t-1]
    for t in range(s):
        h = torch.exp(dtf[:, t, :, None] * af) * h \
            + (dtf[:, t] * xf[:, t])[:, :, None] * bf[:, t, None, :]
        hs.append(h)
    g = torch.zeros_like(h) if dh_final is None else _widen(dh_final)
    dx, ddt, db, dc = (torch.empty_like(t) for t in (xf, xf, bf, bf))
    da = torch.zeros_like(af)
    for t in reversed(range(s)):
        dec = torch.exp(dtf[:, t, :, None] * af)
        g = g + dyf[:, t, :, None] * cf[:, t, None, :]
        dc[:, t] = torch.einsum("bdn,bd->bn", hs[t + 1], dyf[:, t])
        db[:, t] = torch.einsum("bdn,bd->bn", g, dtf[:, t] * xf[:, t])
        gb = (g * bf[:, t, None, :]).sum(-1)
        gh = g * hs[t] * dec
        dx[:, t] = dtf[:, t] * gb
        ddt[:, t] = xf[:, t] * gb + (gh * af).sum(-1)
        da += (gh * dtf[:, t, :, None]).sum(0)
        g = dec * g
    return (dx.to(x.dtype), ddt.to(x.dtype), db.to(x.dtype), dc.to(x.dtype),
            da, g)
