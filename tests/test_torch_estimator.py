"""Port parity: the MCU estimator against the JAX package, on the CPU.

The port counts MACs and buffers from its own graph (one batch-1 forward
on the ``meta`` device); the JAX package counts from the jaxpr.

- MACs: equal on the models with no grouped convolution (the conv1d stack
  and the CIFAR CNN).  On the DS-CNN and MobileNetV1 the port's count is
  the JAX package's plus the depthwise convolutions' MACs it misses (by
  formula here): the reference divides a grouped convolution's MACs by the
  groups twice (its HWIO kernel's I is already C_in / groups), which
  counts a depthwise 3x3 layer of C channels as ``9 // C`` MACs an output
  instead of 9: none at all from C 10 on (ROADMAP.md queue 3).
- Peak bytes: equal on all four families.  MobileNetV1 pads its
  stride-2 layers with an ``F.pad`` buffer where XLA's SAME padding has
  none; the estimator counts a pad that only a convolution reads as part
  of that convolution, so block 2's (1, 16, 49, 49) pad does not displace
  the (1, 16, 48, 48) buffer from the top two.
- ``param_bytes``, ``estimate_mcu`` and ``estimate_impulse`` give the
  same numbers from the same inputs; the ordering checks of
  ``tests/test_core.py`` hold.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import blocks as jcb
from repro.core import estimator as je
from repro.core.impulse import Impulse as JImpulse
from repro.models import kws as jkws
from repro_torch.core import blocks as tcb
from repro_torch.core import estimator as te
from repro_torch.core.impulse import Impulse as TImpulse
from repro_torch.models import kws as tkws
from repro_torch.models.params import kws_params_from_numpy

torch.set_num_threads(1)

# name: (JAX config, init, apply; the port's apply; features shape)
FAMILIES = {
    "ds-cnn": (jkws.DSCNNConfig(), jkws.dscnn_init, jkws.dscnn_apply,
               tkws.dscnn_apply, (99, 40)),
    "mobilenetv1": (jkws.MobileNetV1Config(), jkws.mobilenetv1_init,
                    jkws.mobilenetv1_apply, tkws.mobilenetv1_apply,
                    (96, 96, 3)),
    "cifar-cnn": (jkws.CifarCNNConfig(), jkws.cifar_cnn_init,
                  jkws.cifar_cnn_apply, tkws.cifar_cnn_apply, (32, 32, 3)),
    "conv1d-stack": (jkws.Conv1DStackConfig(), jkws.conv1d_stack_init,
                     jkws.conv1d_stack_apply, tkws.conv1d_stack_apply,
                     (49, 13)),
}


def _both(name):
    cfg, init, japply, tapply, shape = FAMILIES[name]
    jp = init(cfg, jax.random.key(0), shape)
    tp = kws_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return (lambda p, f: japply(cfg, p, f), jp,
            lambda p, f: tapply(cfg, p, f), tp, shape)


def _depthwise_macs(name) -> int:
    """The depthwise 3x3 layers' MACs the reference misses, by formula: 9
    per output, less the ``9 // C`` per output it counts for C channels
    (0 from C 10 on; 1 for MobileNetV1's first block, C 8)."""
    if name == "ds-cnn":
        # stride-2 stem on (99, 40): (50, 20) x 64 channels, 4 blocks
        return 4 * 50 * 20 * 64 * 9
    if name == "mobilenetv1":
        cfg = FAMILIES[name][0]
        size, c, total = 48, max(int(32 * cfg.width_mult), 8), 0
        for c_out, stride in jkws._MBV1_PLAN:
            size = -(-size // stride)
            total += size * size * c * (9 - 9 // c)
            c = max(int(c_out * cfg.width_mult), 8)
        return total
    return 0


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_count_macs(name):
    japply, jp, tapply, tp, shape = _both(name)
    want = je.count_macs(japply, jp, shape) + _depthwise_macs(name)
    assert te.count_macs(tapply, tp, shape) == want
    if name == "ds-cnn":
        assert want == 21_248_768 == 18_944_768 + 2_304_000


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_peak_activation_bytes(name):
    japply, jp, tapply, tp, shape = _both(name)
    want = je.peak_activation_bytes(japply, jp, shape)
    got = te.peak_activation_bytes(tapply, tp, shape)
    if name == "mobilenetv1":
        assert want == 2 * 16 * 48 * 48 * 4
    assert got == want
    assert te.peak_activation_bytes(tapply, tp, shape, dtype_bytes=1) \
        == got // 4


@pytest.mark.parametrize("int8", [False, True])
def test_param_bytes(int8):
    for name in FAMILIES:
        _, jp, _, tp, _ = _both(name)
        assert te.param_bytes(tp, int8=int8) == je.param_bytes(jp, int8=int8)


def test_estimate_mcu_matches_jax():
    assert sorted(te.TARGETS) == sorted(je.TARGETS)
    assert te.RUNTIME == je.RUNTIME
    for target in te.TARGETS:
        assert dataclasses.asdict(te.TARGETS[target]) == \
            dataclasses.asdict(je.TARGETS[target])
        for engine in ("eon", "tflm"):
            for int8 in (False, True):
                kw = dict(macs=11_400_000, dsp_samples=16_000,
                          weight_bytes=70_000, act_bytes=210_000,
                          engine=engine, int8=int8)
                got = te.estimate_mcu(target, **kw)
                want = je.estimate_mcu(target, **kw)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                assert got.total_latency_ms == want.total_latency_ms


@pytest.fixture(scope="module")
def impulses():
    """The quickstart-shaped Impulse on both sides, same weights."""
    dsp = ("mfcc", {"n_mels": 32, "n_coeffs": 10})
    learn = ("conv1d-stack", {"n_blocks": 2, "ch_first": 16, "ch_last": 32,
                              "n_classes": 3})
    jimp = JImpulse(jcb.make_dsp_block(dsp[0], **dsp[1]),
                    jcb.make_learn_block(learn[0], **learn[1]),
                    input_shape=4000)
    jimp.init(jax.random.key(0))
    timp = TImpulse(tcb.make_dsp_block(dsp[0], **dsp[1]),
                    tcb.make_learn_block(learn[0], **learn[1]),
                    input_shape=4000, device="cpu")
    timp.params = kws_params_from_numpy(jax.tree.map(np.asarray,
                                                     jimp.params), "cpu")
    return jimp, timp


def test_estimate_impulse_matches_jax(impulses):
    jimp, timp = impulses
    for target in te.TARGETS:
        for engine in ("eon", "tflm"):
            for int8 in (False, True):
                got = te.estimate_impulse(timp, target, engine=engine,
                                          int8=int8)
                want = je.estimate_impulse(jimp, target, engine=engine,
                                           int8=int8)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_estimator_engine_ordering(impulses):
    """EON beats TFLM on RAM and flash (Table 4's claim); int8 beats float
    on flash and NN latency (Tables 2 and 4)."""
    _, timp = impulses
    for int8 in (False, True):
        tflm = te.estimate_impulse(timp, "nano33ble", engine="tflm",
                                   int8=int8)
        eon = te.estimate_impulse(timp, "nano33ble", engine="eon", int8=int8)
        assert eon.ram_kb < tflm.ram_kb
        assert eon.flash_kb < tflm.flash_kb
    f = te.estimate_impulse(timp, "nano33ble", int8=False)
    q = te.estimate_impulse(timp, "nano33ble", int8=True)
    assert q.flash_kb < f.flash_kb
    assert q.nn_latency_ms < f.nn_latency_ms


def test_estimator_cross_target_ordering(impulses):
    """Float inference: M4 (FPU) beats M0+ (soft float), Table 2's shape."""
    _, timp = impulses
    m4 = te.estimate_impulse(timp, "nano33ble", int8=False)
    m0 = te.estimate_impulse(timp, "rp2040", int8=False)
    assert m4.nn_latency_ms < m0.nn_latency_ms
