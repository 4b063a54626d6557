"""Port parity: the mamba2 (SSD) layer of the zamba2 hybrid trunk against
the JAX package's ``repro.models.ssm``, on the CPU.

``mamba2_layer`` and ``mamba2_decode`` on weights carried across from one
layer of the JAX package's ``init_params`` on the ``zamba2-2.7b`` smoke
config, ``gate_norm`` made nonzero so that the gate norm is exercised.
float32: layer outputs, final states and conv windows within 1e-5 (both
sides run the same f32 arithmetic in another summation order; the
measured gap is about 1e-7).  bfloat16: within ``BF16_ATOL``, about a
bf16 ulp of the outputs, since the two sides round the projections'
products in another order; the f32 state within 1e-4 (measured 7.9e-6).

The JAX package cuts S into ``S // 256`` chunks of ``S // n`` steps and
fails where n does not divide S (``ROADMAP.md`` queue 3: S 513); the port
pads the last chunk with dt = 0, an exact identity on the state, so S 513
is held against the port's own one-token decode chain.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import ssm as jssm
from repro.models.params import init_params as jinit
from repro_torch import configs as tconfigs
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from repro_torch.models.params import init_params, params_from_numpy

torch.set_num_threads(1)

ARCH = "zamba2-2.7b"
ATOL = 1e-5
# twice the measured gap (2.93e-3 on outputs of at most 0.41: a bf16 ulp
# there), rounded up to a power of two
BF16_ATOL = 2.0 ** -7


def _setup(dtype="float32"):
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype=dtype)
    jp = jinit(jcfg, jax.random.key(0))
    layer = jax.tree.map(lambda x: np.asarray(x)[0, 1], jp["groups"])
    rng = np.random.RandomState(0)
    layer["mamba"]["gate_norm"] = (
        rng.randn(*layer["mamba"]["gate_norm"].shape) * 0.1
    ).astype(np.float32)
    return jcfg, tcfg, layer


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg, layer = _setup()
    jl = jax.tree.map(jnp.asarray, layer["mamba"])
    tl = params_from_numpy(layer, device="cpu").tree()["mamba"]
    return jcfg, tcfg, jl, tl


def _state(cfg, b, rng):
    nh = cfg.resolved_ssm_heads
    conv = rng.randn(b, cfg.d_conv - 1, cfg.d_inner).astype(np.float32)
    h = rng.randn(b, nh, cfg.d_inner // nh, cfg.ssm_state) \
        .astype(np.float32) * 0.5
    return conv, h


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("s", [1, 7, 64, 256, 512])
def test_layer_matches_jax(setup, s):
    """One chunk (S <= 256) and two (S 512), from zeros and from a carried
    (conv, h) state: y, the final h and the conv window."""
    jcfg, tcfg, jl, tl = setup
    rng = np.random.RandomState(s)
    x = rng.randn(2, s, tcfg.d_model).astype(np.float32) * 0.5
    conv, h = _state(tcfg, 2, rng)
    for carried in (False, True):
        jst = jssm.SSMState(jnp.asarray(conv), jnp.asarray(h)) \
            if carried else None
        tst = tssm.SSMState(torch.from_numpy(conv), torch.from_numpy(h)) \
            if carried else None
        yj, sj = jssm.mamba2_layer(jl, jnp.asarray(x), jcfg, jst)
        yt, st = tssm.mamba2_layer(tl, torch.from_numpy(x), tcfg, tst)
        _close(yt, yj)
        _close(st.h, sj.h)
        _close(st.conv, sj.conv)
        assert st.h.dtype == torch.float32


def test_layer_bf16_matches_jax():
    """bf16 activations and weights: y and the conv window within
    ``BF16_ATOL``, the f32 state within 1e-4."""
    jcfg, tcfg, layer = _setup("bfloat16")
    jl = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16)
                      if a.ndim >= 2 else jnp.asarray(a), layer["mamba"])
    tl = params_from_numpy(layer, device="cpu",
                           dtype=torch.bfloat16).tree()["mamba"]
    rng = np.random.RandomState(5)
    x = rng.randn(2, 64, tcfg.d_model).astype(np.float32) * 0.5
    yj, sj = jssm.mamba2_layer(jl, jnp.asarray(x, jnp.bfloat16), jcfg)
    yt, st = tssm.mamba2_layer(tl, torch.from_numpy(x).bfloat16(), tcfg)
    assert yt.dtype == torch.bfloat16 and st.h.dtype == torch.float32
    _close(yt, np.asarray(yj, np.float32), BF16_ATOL)
    _close(st.conv, np.asarray(sj.conv, np.float32), BF16_ATOL)
    _close(st.h, sj.h, 1e-4)


def test_ragged_s_where_the_reference_fails(setup):
    """S 513 (two chunks, 513 % 2 != 0): the reference fails; the port's
    layer equals its own decode chain step by step."""
    jcfg, tcfg, jl, tl = setup
    rng = np.random.RandomState(7)
    x = rng.randn(1, 513, tcfg.d_model).astype(np.float32) * 0.5
    with pytest.raises(TypeError):
        jssm.mamba2_layer(jl, jnp.asarray(x), jcfg)
    y, st = tssm.mamba2_layer(tl, torch.from_numpy(x), tcfg)
    state = tssm.SSMState(*(torch.from_numpy(a) * 0
                            for a in _state(tcfg, 1, rng)))
    ys = []
    for t in range(513):
        yt, state = tssm.mamba2_decode(tl, torch.from_numpy(x[:, t:t + 1]),
                                       tcfg, state)
        ys.append(yt)
    _close(torch.cat(ys, 1), y.numpy(), 1e-5)
    _close(state.h, st.h.numpy(), 1e-5)
    _close(state.conv, st.conv.numpy(), 1e-6)


def test_masked_ragged_chunk_matches_jax(setup):
    """Rows of 9 and 5 real steps in a chunk of 9, from a carried state,
    with the chunk path's mask and fill."""
    jcfg, tcfg, jl, tl = setup
    rng = np.random.RandomState(3)
    x = rng.randn(2, 9, tcfg.d_model).astype(np.float32) * 0.5
    conv, h = _state(tcfg, 2, rng)
    fill = np.array([9, 5], np.int32)
    mask = np.arange(9)[None, :] < fill[:, None]
    yj, sj = jssm.mamba2_layer(
        jl, jnp.asarray(x), jcfg, jssm.SSMState(jnp.asarray(conv),
                                               jnp.asarray(h)),
        mask=jnp.asarray(mask), fill=jnp.asarray(fill))
    yt, st = tssm.mamba2_layer(
        tl, torch.from_numpy(x), tcfg,
        tssm.SSMState(torch.from_numpy(conv), torch.from_numpy(h)),
        mask=torch.from_numpy(mask), fill=torch.from_numpy(fill))
    _close(yt[0], np.asarray(yj)[0])
    _close(yt[1, :5], np.asarray(yj)[1, :5])
    _close(st.h, sj.h)
    _close(st.conv, sj.conv)


def test_masked_tail_state_equals_truncated_prefix(setup):
    """``tests/test_chunked_prefill.py::test_mamba_mask_fill_exact_state``
    on the port, bit for bit: a masked tail leaves (conv, h) exactly where
    the real prefix alone puts them."""
    _, tcfg, _, tl = setup
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(1, 8, tcfg.d_model).astype(np.float32)
                         * 0.1)
    mask = torch.arange(8)[None, :] < 5
    _, masked = tssm.mamba2_layer(tl, x, tcfg, mask=mask,
                                  fill=torch.tensor([5], dtype=torch.int32))
    _, cut = tssm.mamba2_layer(tl, x[:, :5], tcfg)
    assert torch.equal(masked.conv, cut.conv)
    assert torch.equal(masked.h, cut.h)


def test_decode_matches_jax(setup):
    """One token from a carried state: y, h and the rolled conv window."""
    jcfg, tcfg, jl, tl = setup
    rng = np.random.RandomState(4)
    x = rng.randn(3, 1, tcfg.d_model).astype(np.float32) * 0.5
    conv, h = _state(tcfg, 3, rng)
    yj, sj = jssm.mamba2_decode(jl, jnp.asarray(x), jcfg,
                                jssm.SSMState(jnp.asarray(conv),
                                              jnp.asarray(h)))
    yt, st = tssm.mamba2_decode(tl, torch.from_numpy(x), tcfg,
                                tssm.SSMState(torch.from_numpy(conv),
                                              torch.from_numpy(h)))
    _close(yt, yj)
    _close(st.h, sj.h)
    np.testing.assert_array_equal(st.conv.numpy(), np.asarray(sj.conv))


def test_decode_chain_equals_layer(setup):
    """Nine one-token steps from a carried state give the one-shot layer's
    outputs and final state."""
    _, tcfg, _, tl = setup
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(2, 9, tcfg.d_model).astype(np.float32)
                         * 0.5)
    state = tssm.SSMState(*map(torch.from_numpy, _state(tcfg, 2, rng)))
    y, final = tssm.mamba2_layer(tl, x, tcfg, state)
    ys = []
    for t in range(9):
        yt, state = tssm.mamba2_decode(tl, x[:, t:t + 1], tcfg, state)
        ys.append(yt)
    _close(torch.cat(ys, 1), y.numpy())
    _close(state.h, final.h.numpy())
    _close(state.conv, final.conv.numpy(), 1e-6)


def test_idle_slots_keep_their_state(setup):
    """``mamba_block_decode`` with ``active``: idle rows' (conv, h) come
    back bit for bit, live rows advance."""
    _, tcfg, _, tl = setup
    rng = np.random.RandomState(8)
    p = {"norm": torch.zeros(tcfg.d_model), "mamba": tl}
    x = torch.from_numpy(rng.randn(3, 1, tcfg.d_model).astype(np.float32))
    state = tssm.SSMState(*map(torch.from_numpy, _state(tcfg, 3, rng)))
    _, new = ttr.mamba_block_decode(tcfg, p, x, state,
                                    active=torch.tensor([True, False, True]))
    for n, o in zip(new, state):
        assert torch.equal(n[1], o[1])
        assert not torch.equal(n[0], o[0])


def test_init_modes_and_dtypes():
    """``init_params`` draws the mamba2 leaves by their initializers (as
    the JAX package's ``_init_one``): ``a_log`` log(1..nh) a head, ``d_skip``
    ones, ``gate_norm`` and ``conv_b`` zeros, dt within [1e-3, 0.1]; the
    dynamics (``a_log``, ``d_skip``, ``dt_bias``) stay float32 under bf16
    weights, as the JAX layer reads them."""
    cfg = tconfigs.get_smoke(ARCH)
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    m = p["groups"]["mamba"]
    g, r, nh = 2, 3, cfg.resolved_ssm_heads
    for name in ("a_log", "d_skip", "dt_bias"):
        assert m[name].dtype == torch.float32 and m[name].shape == (g, r, nh)
    assert m["in_proj"].dtype == m["dt_w"].dtype == torch.bfloat16
    want_a = torch.log(torch.arange(1, nh + 1, dtype=torch.float32))
    assert torch.equal(m["a_log"], want_a.expand(g, r, nh))
    assert torch.equal(m["d_skip"], torch.ones(g, r, nh))
    assert not m["conv_b"].any() and not m["gate_norm"].any()
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.99 and float(dt.max()) <= 0.1 * 1.01
