"""Port parity: the Impulse's inference path (DSP block -> learn block,
float and PTQ int8) against the JAX package, on the CPU.

The same weights (the JAX package's own, carried across) and the same
clips (the port's ``keyword_audio``, bitwise the JAX one's) go through
both Impulses: logits and int8 logits agree at rtol 1e-4, atol 1e-4 (f32
in another summation order; measured gaps near 1e-6), and ``evaluate``,
``confusion_matrix`` and ``int8_accuracy`` are equal.  PTQ is bitwise:
``jnp.round`` and ``torch.round`` both round half to even and the scale
is one f32 division on both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocks as jcb
from repro.core import quantize as jq
from repro.core.impulse import Impulse as JImpulse
from repro.data import synthetic as jsyn
from repro.models import kws as jkws
from repro_torch.core import blocks as tcb
from repro_torch.core import quantize as tq
from repro_torch.core.impulse import Impulse as TImpulse
from repro_torch.data import synthetic as tsyn
from repro_torch.models import kws as tkws
from repro_torch.models.params import kws_params_from_numpy

torch.set_num_threads(1)

RTOL = ATOL = 1e-4

# name: (dsp block, learn block, samples per clip, classes, clips per class)
IMPULSES = {
    "quickstart": (("mfcc", {"n_mels": 32, "n_coeffs": 10}),
                   ("conv1d-stack", {"n_blocks": 2, "ch_first": 16,
                                     "ch_last": 64, "n_classes": 4}),
                   8000, 4, 8),
    "dscnn_mfe": (("mfe", {}), ("ds-cnn", {}), 16_000, 12, 3),
}


def _assert_tree_bitwise(jtree, ttree):
    if isinstance(jtree, dict):
        assert sorted(jtree) == sorted(ttree)
        for k in jtree:
            _assert_tree_bitwise(jtree[k], ttree[k])
    elif isinstance(jtree, (list, tuple)):
        assert len(jtree) == len(ttree)
        for a, b in zip(jtree, ttree):
            _assert_tree_bitwise(a, b)
    elif jtree is None:
        assert ttree is None
    else:
        want = np.asarray(jtree)
        got = ttree.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _pair(name):
    """The JAX Impulse (weights from its own init) and the port's Impulse
    on the CPU holding the same weights, and the clips."""
    (dk, dkw), (lk, lkw), n_samples, n_classes, per_class = IMPULSES[name]
    jimp = JImpulse(jcb.make_dsp_block(dk, **dkw),
                    jcb.make_learn_block(lk, **lkw), input_shape=n_samples)
    jimp.init(jax.random.key(0))
    timp = TImpulse(tcb.make_dsp_block(dk, **dkw),
                    tcb.make_learn_block(lk, **lkw), input_shape=n_samples,
                    device="cpu")
    timp.params = kws_params_from_numpy(jax.tree.map(np.asarray,
                                                     jimp.params), "cpu")
    samples = tsyn.keyword_audio(n_per_class=per_class, n_classes=n_classes,
                                 n_samples=n_samples, seed=1)
    xs = np.stack([s.data for s in samples])
    ys = np.asarray([s.label for s in samples], np.int32)
    return jimp, timp, xs, ys, n_classes


@pytest.mark.parametrize("name", sorted(IMPULSES))
def test_impulse_matches_jax(name):
    jimp, timp, xs, ys, n_classes = _pair(name)
    want = np.asarray(jimp.logits(jnp.asarray(xs)))
    got = timp.logits(xs)
    assert got.device.type == "cpu" and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert timp.evaluate(timp.params, xs, ys, batch_size=16) == \
        jimp.evaluate(jimp.params, xs, ys, batch_size=16)
    np.testing.assert_array_equal(timp.confusion_matrix(xs, ys, n_classes),
                                  jimp.confusion_matrix(xs, ys, n_classes))

    jimp.quantize(xs[:16])
    timp.quantize(xs[:16])
    _assert_tree_bitwise(jimp.qparams.q, timp.qparams.q)
    _assert_tree_bitwise(jimp.qparams.scales, timp.qparams.scales)
    assert timp.qparams.meta == jimp.qparams.meta
    want8 = np.asarray(jimp.logits_int8(jnp.asarray(xs)))
    np.testing.assert_allclose(timp.logits_int8(xs).numpy(), want8,
                               rtol=RTOL, atol=ATOL)
    assert timp.int8_accuracy(xs, ys, batch_size=16) == \
        jimp.int8_accuracy(xs, ys, batch_size=16)


@pytest.mark.parametrize("family", ["dscnn", "mobilenetv1", "cifar_cnn",
                                    "conv1d_stack"])
def test_quantize_params_bitwise(family):
    cfg_name = {"dscnn": "DSCNNConfig", "mobilenetv1": "MobileNetV1Config",
                "cifar_cnn": "CifarCNNConfig",
                "conv1d_stack": "Conv1DStackConfig"}[family]
    shape = {"dscnn": (99, 40), "conv1d_stack": (49, 10)}.get(
        family, (32, 32, 3))
    cfg = getattr(jkws, cfg_name)()
    params = jax.tree.map(np.array, getattr(jkws, f"{family}_init")(
        cfg, jax.random.key(3), shape))
    # exact half steps and an all-zero channel (the 1e-8 amax floor)
    leaf = params["head"]["w"]
    leaf[:, 0] = 0.0
    leaf[:4, 1] = [127.0, 63.5, -0.5, 1.5]
    want = jq.quantize_params(params)
    got = tq.quantize_params(kws_params_from_numpy(params, "cpu"))
    _assert_tree_bitwise(want.q, got.q)
    _assert_tree_bitwise(want.scales, got.scales)
    assert got.meta == want.meta


def test_fake_quant_and_quantization_error_match_jax():
    cfg = jkws.Conv1DStackConfig(n_blocks=2, ch_first=16, ch_last=64)
    params = jax.tree.map(np.asarray, jkws.conv1d_stack_init(
        cfg, jax.random.key(4), (49, 10)))
    jqp = jq.quantize_params(params)
    tqp = tq.quantize_params(kws_params_from_numpy(params, "cpu"))
    _assert_tree_bitwise(jq.fake_quant_params(jqp),
                         tq.fake_quant_params(tqp))
    assert tq.quantization_error(kws_params_from_numpy(params, "cpu"),
                                 tqp) == jq.quantization_error(params, jqp)


def test_registry_errors_match_jax():
    for kind in ("dsp", "learn"):
        with pytest.raises(ValueError) as want:
            getattr(jcb, f"make_{kind}_block")("nope")
        with pytest.raises(ValueError) as got:
            getattr(tcb, f"make_{kind}_block")("nope")
        assert str(got.value) == str(want.value)


def test_custom_blocks_register():
    @dataclasses.dataclass(frozen=True)
    class Halve:
        name: str = "halve"

        def __call__(self, x):
            return x[..., ::2]

        def feature_shape(self, n):
            return ((n + 1) // 2,)

        def hyperparams(self):
            return {}

    tcb.register_dsp_block("halve", Halve)
    tcb.register_learn_block("dscnn2", tkws.DSCNNConfig, tkws.dscnn_init,
                             tkws.dscnn_apply)
    try:
        blk = tcb.make_dsp_block("halve")
        assert blk.name == "halve" and blk.feature_shape(9) == (5,)
        assert tcb.make_learn_block("dscnn2", n_blocks=1).cfg.n_blocks == 1
    finally:
        del tcb._DSP_REGISTRY["halve"], tcb._LEARN_REGISTRY["dscnn2"]


def test_fit_raises_and_int8_needs_quantize():
    """``fit`` trains (it raised before the port had it; its parity with
    the JAX package is in ``test_torch_fit.py``); the int8 path still
    needs ``quantize`` first."""
    imp = TImpulse(tcb.make_dsp_block("mfe"),
                   tcb.make_learn_block("ds-cnn", n_filters=8, n_blocks=1),
                   input_shape=16_000, device="cpu")
    imp.init(torch.Generator().manual_seed(0))
    out = imp.fit((np.zeros((3, 16_000), np.float32), np.zeros(3, np.int64)),
                  epochs=1, batch_size=2)
    assert [sorted(r) for r in out["history"]] == [["acc", "epoch", "loss"]]
    assert np.isfinite(out["final"]["loss"])
    with pytest.raises(RuntimeError, match="quantize"):
        imp.logits_int8(np.zeros((1, 16_000), np.float32))


def test_keyword_audio_bitwise():
    want = jsyn.keyword_audio(n_per_class=3, n_classes=5, n_samples=4000,
                              seed=7)
    got = tsyn.keyword_audio(n_per_class=3, n_classes=5, n_samples=4000,
                             seed=7)
    assert len(got) == len(want) == 15
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.data, b.data)
        assert (a.label, a.metadata, a.sample_id) == \
            (b.label, b.metadata, b.sample_id)


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a GPU every entry point raises unless given device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dsp, learn = tcb.make_dsp_block("mfe"), tcb.make_learn_block("ds-cnn")
    with pytest.raises(RuntimeError, match="CUDA"):
        TImpulse(dsp, learn, input_shape=16_000)
    with pytest.raises(RuntimeError, match="CUDA"):
        tkws.dscnn_init(tkws.DSCNNConfig(), torch.Generator(), (99, 40))
    with pytest.raises(RuntimeError, match="CUDA"):
        kws_params_from_numpy({"w": np.zeros((2, 2), np.float32)})
    imp = TImpulse(dsp, learn, input_shape=16_000, device="cpu")
    assert imp.device == torch.device("cpu")
