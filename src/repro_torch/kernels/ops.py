"""Dispatch wrappers: the CUDA kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor.

The model layers call these.  Which path runs follows from where the
tensor lies and from nothing else: a CUDA tensor launches the kernel (or
the wrapper raises), a CPU tensor takes ``kernels/ref.py``.  There is no
fallback and no switch.

``quant_matmul`` is the matmul every projection goes through: a float
weight is ``x @ w``, left to ``torch.matmul`` as the JAX package leaves
it to XLA; a ``QTensor`` weight takes the int8 path, its activations
quantized per row (dynamically or against a calibrated amax), through
``int8_matmul`` (or its fake-quant float simulation).  The
attention wrappers take the cache as float tensors or ``Int8KV`` pairs,
contiguous or paged (``block_table``).  ``mel_frontend`` is the DSP
blocks' fused frontend.  ``flash_attention`` is the training path's
whole-sequence attention, differentiable on either device through its
forward and backward operators.  ``mamba_scan`` is the selective scan of
the mamba1 layers, from a carried-in state.

The kernels (``flash_decode``, ``int8_matmul``, ``mel_frontend``,
``mamba_scan`` and ``flash_attention``, the last two with their
backward) are registered as custom operators (``torch.ops.repro_torch.*``)
at the level of their tensor arguments: the ``cpu`` implementation is the
plain version, the ``cuda`` one the kernel's launch (which counts
``LAUNCHES``), and a fake implementation gives the output shapes, so
that ``torch.export`` traces each one as one node instead of reaching
into the ``ctypes`` launch, and a trace on the ``meta`` device (the dry
run, ``launch/dryrun.py``) sees each kernel as one node with none of the
plain versions' temporaries.  The dispatcher picks the implementation by
the tensors' device.  The wrappers below unpack ``Int8KV`` and
``QTensor`` before the call.  ``chunk_attention`` is no operator (the
serving step that runs it is not traced on meta): on meta it raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.library import custom_op

from repro_torch.core.quantize import (Int8KV, PrecisionPolicy, QTensor,
                                       quant_dynamic)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import int8_matmul as im
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import mel_frontend as mf
from repro_torch.kernels import ref


def launch_counts() -> dict:
    """Every kernel's launches since its last reset, by name: what the
    wrappers counted on the host (a replayed CUDA graph adds nothing)."""
    return {**fd.LAUNCHES, **im.LAUNCHES, **mf.LAUNCHES, **fa.LAUNCHES,
            **ms.LAUNCHES}


def _on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the kernels' route: a CUDA tensor launches
    them, and a ``meta`` tensor (the dry run's shapes, no data) goes to
    the registered operators, whose fake implementations give the output
    shapes, so a trace on meta follows the path the card runs.  A CPU
    tensor takes the plain version; any other device raises."""
    if x.device.type in ("cuda", "meta"):
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel path for a tensor on {x.device}")


@custom_op("repro_torch::int8_matmul", mutates_args=(), device_types="cpu",
           schema="(Tensor x_q, Tensor w_q, Tensor x_scale, Tensor w_scale)"
                  " -> Tensor")
def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """``(M, K) int8 · (N, K) int8ᵀ`` → exact int32 sum → ``× x_scale[m] ×
    w_scale[n]`` → (M, N) f32."""
    return ref.int8_matmul_ref(x_q, w_q, x_scale, w_scale)


@int8_matmul.register_kernel("cuda")
def _int8_matmul_cuda(x_q, w_q, x_scale, w_scale):
    return im.int8_matmul(x_q, w_q, x_scale, w_scale)


@int8_matmul.register_fake
def _int8_matmul_fake(x_q, w_q, x_scale, w_scale):
    return x_q.new_empty((x_q.shape[0], w_q.shape[0]), dtype=torch.float32)


def quant_matmul(x: torch.Tensor, w, *,
                 policy: Optional[PrecisionPolicy] = None) -> torch.Tensor:
    """Precision-aware matmul: ``x (..., K) @ w``.

    A float ``w`` (K, N) is ``x @ w``.  A ``QTensor`` (values (N, K)) takes
    the int8 path: the rows of x are quantized dynamically (with
    ``policy.activations == "calibrated"``, against the ``QTensor``'s
    calibrated amax where it has one), the int8 kernel runs with the
    dequant in its epilogue, and the f32 result is cast back to x's dtype.
    With ``policy.compute == "fake_quant"`` the same quantization decisions
    run in float: the integer-valued f32 product with the scales applied
    once afterwards, the kernel's accumulate-then-scale order (exact while
    every partial sum stays below 2^24), as the JAX package's oracle does.
    """
    if not isinstance(w, QTensor):
        return x @ w.to(x.dtype)
    lead, kdim = x.shape[:-1], x.shape[-1]
    calibrated = policy is not None and policy.activations == "calibrated"
    xq, xs = quant_dynamic(x.reshape(-1, kdim),
                           w.amax if calibrated else None)
    if policy is not None and policy.compute == "fake_quant":
        acc = xq.float() @ w.q.float().t()
        out = acc * (xs[:, None] * w.scale[None, :])
    else:
        out = int8_matmul(xq, w.q, xs, w.scale)
    return out.reshape(*lead, w.q.shape[0]).to(x.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_pos: Optional[torch.Tensor] = None,
                    k_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Whole-sequence attention: q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) ->
    (B, Sq, Hq, D) in q's dtype.  Index masks: key j is visible to row i
    when ``j <= i`` (causal) and ``j > i - window`` (window > 0).  Skv may
    differ from Sq only with ``causal=False`` and ``window == 0``
    (cross-attention: every key visible); otherwise either device raises.
    With ``q_pos`` (B, Sq) and ``k_pos`` (B, Skv) int32 the masks are by
    position instead (the reference's ``full_attention``: ``k_pos >= 0``,
    ``k_pos <= q_pos``, ``k_pos > q_pos - window``), for any Sq and Skv.
    GQA is read in place by the kernel (query head h on KV head h // G).
    Differentiable: the backward is ``repro_torch::flash_attention_bwd``;
    the forward stays one node."""
    _on_card(q)                       # any device but cuda, cpu, meta raises
    if q_pos is not None:
        q_pos = q_pos.to(torch.int32).contiguous()
    if k_pos is not None:
        k_pos = k_pos.to(torch.int32).contiguous()
    out, _ = _flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              q_pos, k_pos, bool(causal), int(window))
    return out


@custom_op("repro_torch::flash_attention", mutates_args=(),
           device_types="cpu",
           schema="(Tensor q, Tensor k, Tensor v, Tensor? q_pos,"
                  " Tensor? k_pos, bool causal, int window)"
                  " -> (Tensor, Tensor)")
def _flash_attention(q, k, v, q_pos, k_pos, causal, window):
    """(out (B, Sq, Hq, D) in q's dtype, lse (B, Hq, Sq) f32), contiguous
    as the kernel writes them."""
    out, lse = ref.flash_attention_fwd_ref(q, k, v, causal, window, q_pos,
                                           k_pos)
    return out.contiguous(), lse


@_flash_attention.register_kernel("cuda")
def _flash_attention_cuda(q, k, v, q_pos, k_pos, causal, window):
    return fa.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                  q_pos=q_pos, k_pos=k_pos)


@_flash_attention.register_fake
def _flash_attention_fake(q, k, v, q_pos, k_pos, causal, window):
    b, sq, hq, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, hq, sq),
                                            dtype=torch.float32)


@custom_op("repro_torch::flash_attention_bwd", mutates_args=(),
           device_types="cpu",
           schema="(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse,"
                  " Tensor dout, Tensor? q_pos, Tensor? k_pos, bool causal,"
                  " int window) -> (Tensor, Tensor, Tensor)")
def _flash_attention_bwd(q, k, v, out, lse, dout, q_pos, k_pos, causal,
                         window):
    """(dq, dk, dv) in the inputs' dtype, contiguous as the kernel writes
    them.  The plain version is autograd's gradient through the plain
    forward, bit for bit (``ref.flash_attention_vjp_ref``): it rebuilds P
    from q and k and reads neither ``out`` nor ``lse``."""
    return tuple(t.contiguous() for t in ref.flash_attention_vjp_ref(
        q, k, v, dout, causal, window, q_pos, k_pos))


@_flash_attention_bwd.register_kernel("cuda")
def _flash_attention_bwd_cuda(q, k, v, out, lse, dout, q_pos, k_pos, causal,
                              window):
    return fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                  window=window, q_pos=q_pos, k_pos=k_pos)


@_flash_attention_bwd.register_fake
def _flash_attention_bwd_fake(q, k, v, out, lse, dout, q_pos, k_pos, causal,
                              window):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _flash_attention_setup(ctx, inputs, output):
    q, k, v, q_pos, k_pos, causal, window = inputs
    ctx.save_for_backward(q, k, v, output[0], output[1], q_pos, k_pos)
    ctx.causal, ctx.window = causal, window


def _flash_attention_backward(ctx, dout, dlse):
    q, k, v, out, lse, q_pos, k_pos = ctx.saved_tensors
    dq, dk, dv = _flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                      q_pos, k_pos, ctx.causal, ctx.window)
    return dq, dk, dv, None, None, None, None


_flash_attention.register_autograd(_flash_attention_backward,
                                   setup_context=_flash_attention_setup)


def _split(cache):
    """(values, scales) of a float cache tensor or an ``Int8KV``."""
    if isinstance(cache, Int8KV):
        return cache.q, cache.scale
    return cache, None


def decode_attention(q: torch.Tensor, k_cache, v_cache,
                     q_position: torch.Tensor, cache_positions: torch.Tensor,
                     *, window: int = 0,
                     kv_len: Optional[torch.Tensor] = None,
                     block_table: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """One-token decode attention against the KV cache.

    q: (B, 1, Hq, D); k/v caches: (B, S, Hkv, D) float tensors or
    ``Int8KV`` pairs; q_position: (B,); cache_positions: (B, S), −1
    marking invalid entries.  ``kv_len`` (B,) is the per-slot fill:
    entries at index >= kv_len are not read (None reads all S).

    ``block_table`` (B, n) int32 selects the paged layout: the caches are
    (NB, BS, Hkv, D) pools, ``cache_positions`` is (NB, BS), and slot b's
    logical block j is pool block ``block_table[b, j]``.  ``kv_len`` is
    then required.
    """
    k, k_scale = _split(k_cache)
    v, v_scale = _split(v_cache)
    if block_table is not None and kv_len is None:
        raise ValueError("paged decode_attention requires kv_len")
    return flash_decode(q, k, v, k_scale, v_scale, q_position,
                        cache_positions, kv_len, block_table, int(window))


@custom_op("repro_torch::flash_decode", mutates_args=(), device_types="cpu",
           schema="(Tensor q, Tensor k, Tensor v, Tensor? k_scale,"
                  " Tensor? v_scale, Tensor q_position, Tensor"
                  " cache_positions, Tensor? kv_len, Tensor? block_table,"
                  " int window) -> Tensor")
def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 k_scale: Optional[torch.Tensor],
                 v_scale: Optional[torch.Tensor], q_position: torch.Tensor,
                 cache_positions: torch.Tensor,
                 kv_len: Optional[torch.Tensor],
                 block_table: Optional[torch.Tensor], window: int
                 ) -> torch.Tensor:
    """``decode_attention`` on the cache's tensors (an ``Int8KV``'s values
    and scales apart): q (B, 1, Hq, D) -> (B, 1, Hq, D) in q's dtype."""
    if block_table is not None:
        return ref.paged_decode_attention_ref(
            q, k, v, q_position, cache_positions, block_table, kv_len,
            window=window, k_scale=k_scale, v_scale=v_scale)
    return ref.decode_attention_ref(
        q, k, v, q_position, cache_positions, window=window, kv_len=kv_len,
        k_scale=k_scale, v_scale=v_scale)


@flash_decode.register_kernel("cuda")
def _flash_decode_cuda(q, k, v, k_scale, v_scale, q_position,
                       cache_positions, kv_len, block_table, window):
    b, _, hq, d = q.shape
    hkv = k.shape[2]
    if kv_len is None:
        kv_len = torch.full((b,), k.shape[1], dtype=torch.int32,
                            device=q.device)
    out = fd.flash_decode(
        q.reshape(b, hkv, hq // hkv, d).contiguous(), k, v,
        q_position.to(torch.int32).contiguous(), cache_positions,
        kv_len.to(torch.int32).contiguous(), k_scale=k_scale,
        v_scale=v_scale, block_table=block_table, window=window)
    return out.reshape(b, 1, hq, d)


@flash_decode.register_fake
def _flash_decode_fake(q, k, v, k_scale, v_scale, q_position,
                       cache_positions, kv_len, block_table, window):
    return torch.empty_like(q)


def chunk_attention(q: torch.Tensor, k_cache, v_cache,
                    q_positions: torch.Tensor, cache_positions: torch.Tensor,
                    *, window: int = 0,
                    kv_len: Optional[torch.Tensor] = None,
                    block_table: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Chunk-prefill attention: C queries per slot against its cache.

    q: (B, C, Hq, D); q_positions: (B, C), −1 marking pad queries (exact
    zeros out); the rest as in ``decode_attention``.  The chunk's own K/V
    must already be in the cache; ``kv_len`` is the post-write fill.
    """
    k, k_scale = _split(k_cache)
    v, v_scale = _split(v_cache)
    if block_table is not None and kv_len is None:
        raise ValueError("paged chunk_attention requires kv_len")
    if not _on_card(q):
        if block_table is not None:
            return ref.paged_chunk_attention_ref(
                q, k, v, q_positions, cache_positions, block_table, kv_len,
                window=window, k_scale=k_scale, v_scale=v_scale)
        return ref.chunk_attention_ref(
            q, k, v, q_positions, cache_positions, window=window,
            kv_len=kv_len, k_scale=k_scale, v_scale=v_scale)
    b, c, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    if kv_len is None:
        kv_len = torch.full((b,), k.shape[1], dtype=torch.int32,
                            device=q.device)
    # grouped rows ordered (query, group): row c*G + g shares KV head h
    qg = q.reshape(b, c, hkv, g, d).permute(0, 2, 1, 3, 4) \
        .reshape(b, hkv, c * g, d).contiguous()
    qp_rows = q_positions.to(torch.int32)[:, :, None].expand(b, c, g) \
        .reshape(b, c * g).contiguous()
    out = fd.flash_chunk_prefill(
        qg, k, v, qp_rows, cache_positions,
        kv_len.to(torch.int32).contiguous(), k_scale=k_scale,
        v_scale=v_scale, block_table=block_table, window=window)
    return out.reshape(b, hkv, c, g, d).permute(0, 2, 1, 3, 4) \
        .reshape(b, c, hq, d)


@custom_op("repro_torch::mel_frontend", mutates_args=(), device_types="cpu",
           schema="(Tensor frames, Tensor window, Tensor dft_cos,"
                  " Tensor dft_sin, Tensor mel_fb) -> Tensor")
def mel_frontend(frames: torch.Tensor, window: torch.Tensor,
                 dft_cos: torch.Tensor, dft_sin: torch.Tensor,
                 mel_fb: torch.Tensor) -> torch.Tensor:
    """frames: (..., F, L), a unit stride along L (``frame_signal``'s view
    of the signal is taken as it is) -> log-mel (..., F, n_mels) f32.

    The leading dims fold into the kernel's frame count: the kernel reads
    frame r of the ``(B, F, L)`` view at batch r // F, frame r % F, so the
    overlapping frames of a batch of clips need no copy."""
    return ref.mel_frontend_ref(frames, window, dft_cos, dft_sin, mel_fb)


@mel_frontend.register_kernel("cuda")
def _mel_frontend_cuda(frames, window, dft_cos, dft_sin, mel_fb):
    lead = frames.shape[:-2]
    f, l = frames.shape[-2:]
    out = mf.mel_frontend(frames.reshape(-1, f, l), window, dft_cos, dft_sin,
                          mel_fb)
    return out.reshape(*lead, f, mel_fb.shape[1])


@mel_frontend.register_fake
def _mel_frontend_fake(frames, window, dft_cos, dft_sin, mel_fb):
    return frames.new_empty(frames.shape[:-1] + (mel_fb.shape[1],),
                            dtype=torch.float32)


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, b_mat: torch.Tensor,
               c_mat: torch.Tensor, a: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan: x/dt (B, S, D) and b_mat/c_mat (B, S, N) in the
    activation dtype, a (D, N) f32, h0 (B, D, N) f32 or None (zeros) ->
    (y (B, S, D) f32, h_final (B, D, N) f32).  ``dt == 0`` steps leave the
    state exactly as it was.  Differentiable in every input: the backward
    is ``repro_torch::mamba_scan_bwd`` (the kernel on the card, the plain
    reverse sweep on the CPU); the forward stays one node."""
    return _mamba_scan(x, dt, b_mat, c_mat, a, h0)


@custom_op("repro_torch::mamba_scan", mutates_args=(), device_types="cpu",
           schema="(Tensor x, Tensor dt, Tensor b_mat, Tensor c_mat,"
                  " Tensor a, Tensor? h0) -> (Tensor, Tensor)")
def _mamba_scan(x, dt, b_mat, c_mat, a, h0):
    return ref.mamba_scan_ref(x, dt, b_mat, c_mat, a, h0)


@_mamba_scan.register_kernel("cuda")
def _mamba_scan_cuda(x, dt, b_mat, c_mat, a, h0):
    return ms.mamba_scan(x.contiguous(), dt.contiguous(), b_mat.contiguous(),
                         c_mat.contiguous(), a.float().contiguous(),
                         None if h0 is None else h0.contiguous())


@_mamba_scan.register_fake
def _mamba_scan_fake(x, dt, b_mat, c_mat, a, h0):
    bsz, s, d = x.shape
    wide = torch.promote_types(x.dtype, torch.float32)
    return (x.new_empty((bsz, s, d), dtype=wide),
            x.new_empty((bsz, d, b_mat.shape[-1]), dtype=wide))


@custom_op("repro_torch::mamba_scan_bwd", mutates_args=(), device_types="cpu",
           schema="(Tensor x, Tensor dt, Tensor b_mat, Tensor c_mat,"
                  " Tensor a, Tensor? h0, Tensor dy, Tensor? dh_final) ->"
                  " (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")
def _mamba_scan_bwd(x, dt, b_mat, c_mat, a, h0, dy, dh_final):
    return ref.mamba_scan_bwd_ref(x, dt, b_mat, c_mat, a, h0, dy, dh_final)


@_mamba_scan_bwd.register_kernel("cuda")
def _mamba_scan_bwd_cuda(x, dt, b_mat, c_mat, a, h0, dy, dh_final):
    return ms.mamba_scan_bwd(
        x.contiguous(), dt.contiguous(), b_mat.contiguous(),
        c_mat.contiguous(), a.float().contiguous(),
        None if h0 is None else h0.contiguous(), dy.float().contiguous(),
        None if dh_final is None else dh_final.float().contiguous())


@_mamba_scan_bwd.register_fake
def _mamba_scan_bwd_fake(x, dt, b_mat, c_mat, a, h0, dy, dh_final):
    bsz, _, d = x.shape
    wide = torch.promote_types(x.dtype, torch.float32)
    return (torch.empty_like(x), torch.empty_like(x), torch.empty_like(b_mat),
            torch.empty_like(c_mat), a.new_empty(a.shape, dtype=wide),
            x.new_empty((bsz, d, b_mat.shape[-1]), dtype=wide))


def _mamba_scan_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _mamba_scan_backward(ctx, dy, dh_final):
    """A gradient nobody asks for (h_final in training, y of a state
    hand-off) comes as None or zeros: None is taken as zeros."""
    x, dt, b_mat, c_mat, a, h0 = ctx.saved_tensors
    if dy is None:
        dy = x.new_zeros(x.shape,
                         dtype=torch.promote_types(x.dtype, torch.float32))
    dx, ddt, db, dc, da, dh0 = _mamba_scan_bwd(x, dt, b_mat, c_mat, a, h0,
                                               dy, dh_final)
    return (dx, ddt, db, dc, da.to(a.dtype),
            None if h0 is None else dh0.to(h0.dtype))


_mamba_scan.register_autograd(_mamba_scan_backward,
                              setup_context=_mamba_scan_setup)
