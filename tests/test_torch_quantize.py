"""Port parity: int8 quantization and the int8 matmul against the JAX
package.

On the CPU.  The quantizers (``quant_dynamic``, ``quant_kv``,
``quantize_model_params``) must give **bitwise** the int8 values and f32
scales of ``repro.core.quantize``: both round half to even and compute
every scale in f32 in the same order.  ``int8_matmul_ref`` must equal the
JAX ``ref.int8_matmul_ref`` and the Pallas ``int8_matmul`` in interpret
mode bitwise, ragged shapes included: the int32 sum is exact and the
epilogue multiplies in one order.  The port stores a ``QTensor``'s values
(N, K), output channel first; the tests transpose the JAX (K, N) values to
compare.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import quantize as jq
from repro.kernels import int8_matmul as jim
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.params import init_params as jinit
from repro_torch.core import quantize as tq
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models.params import QLeaf, params_from_numpy

torch.set_num_threads(1)

ARCH = "internlm2-1.8b"


def _x(rng, shape, scale=3.0):
    """Activations with the awkward cases in them: an all-zero row (the
    1e-8 amax floor), exact half steps, and bf16-representable values."""
    x = (rng.randn(*shape) * scale).astype(np.float32)
    rows = x.reshape(-1, shape[-1])
    rows[0] = 0.0
    rows[1, :4] = [127.0, 63.5, -0.5, 1.5]
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_dynamic_bitwise(dtype):
    rng = np.random.RandomState(0)
    x = _x(rng, (5, 7, 96))
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jqv, js = jq.quant_dynamic(jx)
    tqv, ts = tq.quant_dynamic(tx)
    assert tqv.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_kv_bitwise(dtype):
    rng = np.random.RandomState(1)
    x = _x(rng, (3, 9, 2, 16))
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jkv, tkv = jq.quant_kv(jx), tq.quant_kv(tx)
    np.testing.assert_array_equal(tkv.q.numpy(), np.asarray(jkv.q))
    np.testing.assert_array_equal(tkv.scale.numpy(), np.asarray(jkv.scale))
    for out_dtype in (jnp.float32, jnp.bfloat16):
        want = np.asarray(jq.dequant_kv(jkv, out_dtype).astype(jnp.float32))
        got = tq.dequant_kv(tkv, getattr(torch, jnp.dtype(out_dtype).name))
        np.testing.assert_array_equal(got.float().numpy(), want)
    for name in ("float", "int8", "int8_fakequant"):
        jm = jq.maybe_quant_kv(jq.policy_for(name), jx)
        tm = tq.maybe_quant_kv(tq.policy_for(name), tx)
        assert isinstance(tm, tq.Int8KV) == isinstance(jm, jq.Int8KV)
        if isinstance(tm, tq.Int8KV):
            np.testing.assert_array_equal(tm.q.numpy(), np.asarray(jm.q))
        else:
            np.testing.assert_array_equal(
                tm.float().numpy(), np.asarray(jm.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_model_params_bitwise(dtype):
    """Every projection weight of the smoke model becomes a QTensor with
    the JAX package's values (transposed) and scales; embeddings and
    norms pass through; the JAX quantized tree carried across with
    ``params_from_numpy`` is the same tree."""
    cfg = jconfigs.get_smoke(ARCH)
    jp = jinit(cfg, jax.random.key(3))
    if dtype == "bfloat16":
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                          if a.ndim >= 2 else a, jp)
    np_tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp)
    tp = params_from_numpy(np_tree, device="cpu", dtype=getattr(torch, dtype))
    jqp = jq.quantize_model_params(jp, jq.INT8)
    tqp = tq.quantize_model_params(tp, tq.INT8)
    carried = params_from_numpy(
        jax.tree.map(lambda a: np.array(a if a.dtype == jnp.int8
                                        else a.astype(jnp.float32)), jqp),
        device="cpu", dtype=getattr(torch, dtype))
    n_q = 0
    for scope in ("attn", "mlp"):
        for name, jleaf in jqp["blocks"][scope].items():
            want_q = np.swapaxes(np.asarray(jleaf.q), -1, -2)
            for tleaf in (tqp["blocks"][scope][name],
                          carried["blocks"][scope][name]):
                assert isinstance(tleaf, tq.QTensor)
                assert tleaf.q.is_contiguous()
                np.testing.assert_array_equal(tleaf.q.numpy(), want_q)
                np.testing.assert_array_equal(tleaf.scale.numpy(),
                                              np.asarray(jleaf.scale))
            n_q += 1
    assert n_q == 7
    assert isinstance(tqp["blocks"]._modules["attn"]._modules["wq"], QLeaf)
    for name in ("embed", "unembed", "final_norm"):
        assert torch.equal(tqp[name], tp[name])
    assert torch.equal(tqp["blocks"]["attn_norm"], tp["blocks"]["attn_norm"])
    # per-layer views slice both tensors of a QTensor leaf
    layer1 = tqp["blocks"].unstack()[1]["mlp"]["w_down"]
    assert torch.equal(layer1.q, tqp["blocks"]["mlp"]["w_down"].q[1])
    assert tq.quantize_model_params(tp, tq.FLOAT) is tp


@pytest.mark.parametrize("m,k,n", [(4, 64, 128), (5, 200, 300), (1, 7, 1),
                                   (130, 257, 129), (64, 1040, 96)])
def test_int8_matmul_ref_bitwise(m, k, n):
    rng = np.random.RandomState(m + k + n)
    x = rng.randint(-127, 128, (m, k)).astype(np.int8)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    xs = (rng.rand(m) * 0.05 + 1e-4).astype(np.float32)
    ws = (rng.rand(n) * 0.05 + 1e-4).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (x, w, xs, ws)]
    want = np.asarray(jref.int8_matmul_ref(*jargs))
    interp = np.asarray(jim.int8_matmul(*jargs, interpret=True))
    got = tref.int8_matmul_ref(torch.from_numpy(x),
                               torch.from_numpy(np.ascontiguousarray(w.T)),
                               torch.from_numpy(xs), torch.from_numpy(ws))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), interp)
    # the dispatch wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        tops.int8_matmul(torch.from_numpy(x),
                         torch.from_numpy(np.ascontiguousarray(w.T)),
                         torch.from_numpy(xs), torch.from_numpy(ws)).numpy(),
        want)


@pytest.mark.parametrize("policy", ["int8", "int8_fakequant"])
def test_quant_matmul_matches_jax(policy):
    """The QTensor branch of ``quant_matmul`` (native: the int8 matmul;
    fake_quant: the integer-valued f32 product, scaled once) against
    JAX's, through a (B, C, K) input: bitwise in f32."""
    rng = np.random.RandomState(4)
    x = _x(rng, (2, 3, 96))
    w = (rng.randn(96, 40) * 0.1).astype(np.float32)
    jw = jq._leaf_qtensor(jnp.asarray(w))
    tw = tq._leaf_qtensor(torch.from_numpy(w))
    jout = np.asarray(jops.quant_matmul(
        jnp.asarray(x), jw, policy=jq.policy_for(policy)))
    tout = tops.quant_matmul(torch.from_numpy(x), tw,
                             policy=tq.policy_for(policy))
    assert tout.shape == (2, 3, 40) and tout.dtype == torch.float32
    np.testing.assert_array_equal(tout.numpy(), jout)


def test_policy_for_and_unported_calibration():
    assert tq.policy_for("float") is tq.FLOAT
    assert tq.policy_for("int8") is tq.INT8
    assert tq.policy_for(tq.INT8) is tq.INT8
    assert tq.INT8_FAKEQUANT.compute == "fake_quant"
    for name in ("float", "int8", "int8_fakequant"):
        assert dataclasses.asdict(tq.policy_for(name)) == \
            dataclasses.asdict(jq.policy_for(name))
    with pytest.raises(ValueError):
        tq.policy_for("fp4")
    with pytest.raises(ValueError):
        tq.PrecisionPolicy(weights="int4")
    cal = tq.PrecisionPolicy(weights="int8", activations="calibrated")
    assert dataclasses.asdict(cal) == dataclasses.asdict(
        jq.PrecisionPolicy(weights="int8", activations="calibrated"))
    with pytest.raises(ValueError):
        tq.PrecisionPolicy(activations="static")


def test_stacked_leaf_quantized_a_layer_at_a_time_bitwise():
    """A stacked (L, K, N) leaf is quantized one layer at a time (its f32
    temporaries one layer's); the values and scales equal, bitwise, the
    whole stack quantized at once and the JAX package's."""
    rng = np.random.RandomState(11)
    w = (rng.randn(3, 2, 40, 24) * 0.05).astype(np.float32)
    got = tq._leaf_qtensor(torch.from_numpy(w).to(torch.bfloat16))
    x32 = torch.from_numpy(w).to(torch.bfloat16).float()
    q, scale = tq._symmetric(x32, x32.abs().amax(dim=-2), -2)
    assert torch.equal(got.q, q.transpose(-1, -2).contiguous())
    assert torch.equal(got.scale, scale)
    assert got.q.is_contiguous() and got.q.shape == (3, 2, 24, 40)
    jgot = jq._leaf_qtensor(jnp.asarray(w, jnp.bfloat16))
    np.testing.assert_array_equal(got.q.transpose(-1, -2).numpy(),
                                  np.asarray(jgot.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(jgot.scale))
