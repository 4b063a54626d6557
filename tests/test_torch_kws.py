"""Port parity: the four KWS model families against the JAX package, on
the CPU.

Each family's init gives the JAX tree's structure and shapes; apply on the
JAX package's own weights, carried across with ``kws_params_from_numpy``
(layouts kept: HWIO, WIO, (in, out)), matches the JAX apply at rtol 1e-4,
atol 1e-4 (both convolve in f32, in another summation order: the measured
gaps are near 1e-6).  XLA's SAME padding is checked on odd and even sizes
with stride 2, where it pads one more at the end.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.models import kws as jkws
from repro_torch.core import tree
from repro_torch.models import kws as tkws
from repro_torch.models.params import kws_params_from_numpy

torch.set_num_threads(1)

RTOL = ATOL = 1e-4
CPU = torch.device("cpu")

# family: (config kwargs, input shape without the batch dim)
FAMILIES = {
    "dscnn": ({"n_filters": 16, "n_blocks": 2, "n_classes": 5}, (49, 10)),
    "mobilenetv1": ({}, (32, 32, 3)),
    "cifar_cnn": ({}, (32, 32, 3)),
    "conv1d_stack": ({"n_blocks": 3, "ch_first": 8, "ch_last": 32,
                      "n_classes": 4}, (49, 13)),
}
CONFIGS = {"dscnn": "DSCNNConfig", "mobilenetv1": "MobileNetV1Config",
           "cifar_cnn": "CifarCNNConfig",
           "conv1d_stack": "Conv1DStackConfig"}


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def _jax_family(name, seed=0):
    kw, shape = FAMILIES[name]
    cfg = getattr(jkws, CONFIGS[name])(**kw)
    params = getattr(jkws, f"{name}_init")(cfg, jax.random.key(seed), shape)
    return cfg, jax.tree.map(np.asarray, params), shape


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_init_shapes_match_jax(name):
    jcfg, jparams, shape = _jax_family(name)
    tcfg = getattr(tkws, CONFIGS[name])(**FAMILIES[name][0])
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    tparams = getattr(tkws, f"{name}_init")(
        tcfg, torch.Generator().manual_seed(0), shape, "cpu")
    assert _shapes(tparams) == _shapes(jparams)
    assert all(p.dtype == torch.float32 for p in tree.leaves(tparams))
    assert tkws.count_params(tparams) == jkws.count_params(jparams)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_apply_matches_jax(name):
    jcfg, jparams, shape = _jax_family(name, seed=1)
    rng = np.random.RandomState(len(name))
    # batch-norm leaves at non-trivial values, so the folded scale/offset
    # is exercised
    jparams = jax.tree.map(
        lambda a: (a * rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
                   + rng.uniform(-0.1, 0.1, a.shape).astype(np.float32))
        if a.ndim == 1 else a, jparams)
    x = rng.randn(3, *shape).astype(np.float32)
    want = np.asarray(getattr(jkws, f"{name}_apply")(
        jcfg, jparams, jnp.asarray(x)))
    tcfg = getattr(tkws, CONFIGS[name])(**FAMILIES[name][0])
    got = getattr(tkws, f"{name}_apply")(
        tcfg, kws_params_from_numpy(jparams, "cpu"), torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_dscnn_defaults_on_full_features():
    """DS-CNN at the repo's defaults (12 classes, 64 filters, 4 blocks) on
    the MFE block's (99, 40) features."""
    jcfg, tcfg = jkws.DSCNNConfig(), tkws.DSCNNConfig()
    jparams = jax.tree.map(np.asarray, jkws.dscnn_init(
        jcfg, jax.random.key(2), (99, 40)))
    x = np.random.RandomState(2).randn(4, 99, 40).astype(np.float32) * 3
    want = np.asarray(jkws.dscnn_apply(jcfg, jparams, jnp.asarray(x)))
    got = tkws.dscnn_apply(tcfg, kws_params_from_numpy(jparams, "cpu"),
                           torch.from_numpy(x))
    assert got.shape == (4, 12)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hw,kernel", [((99, 40), (10, 4)),
                                       ((50, 20), (3, 3)),
                                       ((9, 7), (3, 3)), ((8, 6), (3, 3)),
                                       ((7, 8), (1, 1))])
def test_same_padding_stride2_matches_xla(hw, kernel):
    """A stride-2 SAME convolution on odd and even sizes: XLA pads
    total // 2 before and the rest after."""
    rng = np.random.RandomState(hw[0])
    x = rng.randn(2, *hw, 3).astype(np.float32)                 # NHWC
    w = rng.randn(*kernel, 3, 5).astype(np.float32)             # HWIO
    want = np.asarray(jkws.conv2d(jnp.asarray(x), jnp.asarray(w), stride=2))
    got = tkws.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                      torch.from_numpy(w), stride=2).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_same_padding_values_and_conv1d_stride2():
    assert tkws.same_padding(99, 10, 2) == (4, 5)     # the DS-CNN stem
    assert tkws.same_padding(40, 4, 2) == (1, 1)
    assert tkws.same_padding(96, 3, 2) == (0, 1)      # MobileNetV1, even
    assert tkws.same_padding(97, 3, 2) == (1, 1)
    assert tkws.same_padding(5, 1, 1) == (0, 0)
    rng = np.random.RandomState(7)
    for n in (12, 13):
        x = rng.randn(2, n, 4).astype(np.float32)                # NWC
        w = rng.randn(3, 4, 6).astype(np.float32)                # WIO
        want = np.asarray(jkws.conv1d(jnp.asarray(x), jnp.asarray(w),
                                      stride=2))
        got = tkws.conv1d(torch.from_numpy(x).transpose(1, 2),
                          torch.from_numpy(w), stride=2).transpose(1, 2)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_depthwise_and_pooling_match_xla():
    rng = np.random.RandomState(8)
    x = rng.randn(2, 9, 11, 6).astype(np.float32)
    w = rng.randn(3, 3, 1, 6).astype(np.float32)
    want = np.asarray(jkws.conv2d(jnp.asarray(x), jnp.asarray(w), groups=6))
    want = np.asarray(lax.reduce_window(jnp.asarray(want), -jnp.inf, lax.max,
                                        (1, 2, 2, 1), (1, 2, 2, 1), "VALID"))
    t = tkws.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                    torch.from_numpy(w), groups=6)
    got = torch.nn.functional.max_pool2d(t, 2, 2).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 4, 5, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kw,shape", [({}, (99, 40)),
                                      ({"n_blocks": 2, "ch_first": 16,
                                        "ch_last": 64, "n_classes": 4},
                                       (49, 10)),
                                      ({"n_blocks": 1}, (7, 3)),
                                      ({"n_blocks": 5, "kernel": 5},
                                       (3, 13))])
def test_conv1d_channels_and_macs_match_jax(kw, shape):
    jcfg, tcfg = jkws.Conv1DStackConfig(**kw), tkws.Conv1DStackConfig(**kw)
    assert tcfg.channels == jcfg.channels
    assert tkws.model_macs_conv1d(tcfg, shape) == \
        jkws.model_macs_conv1d(jcfg, shape)
