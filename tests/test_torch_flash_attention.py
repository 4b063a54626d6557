"""Port parity: whole-sequence attention (the training path's core)
against the JAX package, on the CPU.

On a CPU tensor ``ops.flash_attention`` runs the plain version
(``kernels/ref.py::flash_attention_ref``), differentiable by autograd;
the CUDA kernels are held against that plain version on the card
(``tests/test_torch_flash_attention_cuda.py``, ``chip_smoke.py``).  Here
the plain version is held against the JAX package's Pallas kernel in
interpret mode (tiles of 64 rows and keys, so tile skipping runs) where
S is a multiple of the tile, and against its jnp reference (after the
GQA expansion of ``repro.kernels.ops``) everywhere, ragged S included.
The backward kernel's plain version (``ref.flash_attention_bwd_ref``) is
held against ``jax.grad`` of the same reference.
Inputs are made with numpy from a seed.  Tolerances: f32 1e-5 (another
summation order); bf16 2e-2, the JAX kernel test's own (the output is
rounded to bf16 on both sides).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jfa_kernel
from repro.models import layers as jlayers
from repro.models.params import init_params as jinit
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as tlayers
from repro_torch.models.params import params_from_numpy

torch.set_num_threads(1)

# name: (B, S, Hq, Hkv, D, causal, window)
CASES = {
    "causal": (2, 128, 2, 2, 32, True, 0),
    "full": (2, 128, 2, 2, 32, False, 0),
    "window": (1, 128, 2, 2, 32, True, 48),
    "gqa": (1, 128, 4, 2, 32, True, 0),
    "gqa_window_full": (1, 128, 4, 1, 32, False, 40),
}
RAGGED = {
    "causal_s77": (2, 77, 4, 2, 32, True, 0),
    "window_s100": (1, 100, 2, 1, 64, True, 24),
    "full_s33": (1, 33, 2, 2, 32, False, 0),
}
DTYPES = {"float32": (np.float32, torch.float32, jnp.float32, 1e-5),
          "bfloat16": (np.float32, torch.bfloat16, jnp.bfloat16, 2e-2)}


def _inputs(b, s, hq, hkv, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, hq, d).astype(np.float32),
            rng.randn(b, s, hkv, d).astype(np.float32),
            rng.randn(b, s, hkv, d).astype(np.float32),
            rng.randn(b, s, hq, d).astype(np.float32))


def _expand(k, hq):
    return jnp.repeat(k, hq // k.shape[2], axis=2)


def _jax_ref(q, k, v, causal, window):
    return jref.flash_attention_ref(q, _expand(k, q.shape[2]),
                                    _expand(v, q.shape[2]), causal=causal,
                                    window=window)


def _jax_interpret(q, k, v, causal, window):
    b, s, hq, d = q.shape

    def fold(x):
        return _expand(x, hq).transpose(0, 2, 1, 3).reshape(b * hq, s, d)

    out = jfa_kernel(fold(q), fold(k), fold(v), causal=causal, window=window,
                     block_q=64, block_k=64, interpret=True)
    return out.reshape(b, hq, s, d).transpose(0, 2, 1, 3)


def _port(q, k, v, dtype, causal, window):
    return tops.flash_attention(*(torch.from_numpy(x).to(dtype)
                                  for x in (q, k, v)),
                                causal=causal, window=window)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax_kernel_and_ref(case, dtype):
    b, s, hq, hkv, d, causal, window = CASES[case]
    _, tdt, jdt, tol = DTYPES[dtype]
    q, k, v, _ = _inputs(b, s, hq, hkv, d)
    got = _port(q, k, v, tdt, causal, window)
    assert got.dtype == tdt and got.shape == (b, s, hq, d)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    for want in (_jax_interpret(jq, jk, jv, causal, window),
                 _jax_ref(jq, jk, jv, causal, window)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol)


def _jax_grads(case_shape, seed):
    """The numpy inputs (q, k, v, do) and ``jax.grad`` of the JAX
    reference's ``sum(out * do)`` in f32."""
    b, s, hq, hkv, d, causal, window = case_shape
    q, k, v, do = _inputs(b, s, hq, hkv, d, seed)

    def loss(q, k, v):
        return jnp.sum(_jax_ref(q, k, v, causal, window) * do)

    return (q, k, v, do), jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))


def _grads_match(case_shape, seed):
    """torch autograd through the port's op against ``jax.grad`` of the
    JAX reference, f32: dq, dk, dv at atol 2e-5 (sums over up to S rows
    in another order; gradients of order 1)."""
    causal, window = case_shape[5:]
    (q, k, v, do), want = _jax_grads(case_shape, seed)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    (out * torch.from_numpy(do)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert got.shape == w.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=2e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax(case):
    _grads_match(CASES[case], seed=1)


@pytest.mark.parametrize("case", ["window", "gqa", "gqa_window_full",
                                  "causal_s77"])
def test_plain_backward_matches_jax(case):
    """``ref.flash_attention_bwd_ref``, the backward kernel's plain version
    (it takes the forward's output for the row sums), given the plain
    forward's f32 output, against ``jax.grad`` of the JAX reference: f32,
    atol 2e-5 as above."""
    shape = {**CASES, **RAGGED}[case]
    causal, window = shape[5:]
    (q, k, v, do), want = _jax_grads(shape, seed=4)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out = tref.flash_attention_ref(tq, tk, tv, causal, window)
    got = tref.flash_attention_bwd_ref(tq, tk, tv, out, tdo, causal, window)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


@pytest.mark.parametrize("case", list(RAGGED))
def test_ragged_s_matches_jax_ref(case):
    """S no multiple of any tile (the Pallas kernel asserts S % block ==
    0): the forward in f32 and bf16 and the gradients against the jnp
    reference only."""
    b, s, hq, hkv, d, causal, window = RAGGED[case]
    q, k, v, _ = _inputs(b, s, hq, hkv, d, seed=2)
    for _, tdt, jdt, tol in DTYPES.values():
        got = _port(q, k, v, tdt, causal, window)
        want = _jax_ref(*(jnp.asarray(x, jdt) for x in (q, k, v)), causal,
                        window)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol)
    _grads_match(RAGGED[case], seed=3)


def test_attention_layer_matches_jax():
    """The port's ``attention_layer`` (projections, rope, the attention op)
    against the reference's on the smoke config's carried f32 weights at
    the default positions: output and K/V at atol 1e-5."""
    jcfg = dataclasses.replace(jconfigs.get_smoke("internlm2-1.8b"),
                               dtype="float32")
    jp = jinit(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    b, s = 2, 24
    x = np.random.RandomState(4).randn(b, s, jcfg.d_model).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    kw = dict(n_heads=jcfg.n_heads, n_kv_heads=jcfg.n_kv_heads,
              head_dim=jcfg.resolved_head_dim, rope_variant="rope",
              rope_theta=jcfg.rope_theta)
    jout, (jk, jv) = jlayers.attention_layer(
        jax.tree.map(lambda a: a[0], jp["blocks"]["attn"]), jnp.asarray(x),
        jnp.asarray(pos), mrope_sections=jcfg.mrope_sections, **kw)
    tout, (tk, tv) = tlayers.attention_layer(
        tp["blocks"].unstack()[0]["attn"], torch.from_numpy(x),
        torch.from_numpy(pos), **kw)
    for got, want in ((tout, jout), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
