"""Port parity: ``Impulse.fit`` and QAT against the JAX package, on the CPU.

The JAX Impulse draws its weights; the port's starts from the same weights
carried across (``kws_params_from_numpy``), and both fit on the same clips
(the port's ``keyword_audio``, bitwise the JAX one's) with the same order
(one ``RandomState(0)``), the tail batch kept.  The history (per-epoch
loss, accuracy and ``val_acc``) agrees at rtol 1e-5, the weights after the
fit within ``2 x lr x steps`` plus 1e-5 (an Adam step moves a leaf whose
gradient is rounding noise by up to lr, whatever the noise's sign; the
readings are near 1e-6), and the logits after the fit at atol 1e-4.

QAT: ``fake_quant_ste`` is bitwise the JAX one's, and its gradient is the
identity, as ``jax.grad`` finds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocks as jcb
from repro.core import quantize as jq
from repro.core.impulse import Impulse as JImpulse
from repro_torch.core import blocks as tcb
from repro_torch.core import quantize as tq
from repro_torch.core import tree
from repro_torch.core.impulse import Impulse as TImpulse
from repro_torch.data import synthetic as tsyn
from repro_torch.models.params import kws_params_from_numpy

torch.set_num_threads(1)

LR = 1e-3
# name: (dsp block, learn block, samples, classes, clips per class, epochs,
# batch, held-out clips)
FITS = {
    "conv1d_mfcc": (("mfcc", {"n_mels": 32, "n_coeffs": 10}),
                    ("conv1d-stack", {"n_blocks": 2, "ch_first": 16,
                                      "ch_last": 32, "n_classes": 3}),
                    4000, 3, 7, 3, 8, 6),
    "dscnn_mfe": (("mfe", {}), ("ds-cnn", {"n_filters": 16, "n_blocks": 2}),
                  8000, 4, 5, 1, 8, 4),
}


def _pair(name):
    (dk, dkw), (lk, lkw), n_samples, n_classes, per_class, *_ = FITS[name]
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
    return jimp, timp, xs, ys


@pytest.mark.parametrize("name", sorted(FITS))
def test_fit_matches_jax(name):
    """Both fits from the same weights: 21 clips at batch 8 (a tail of 5)
    over 3 epochs, and one DS-CNN epoch (20 clips, a tail of 4), with
    ``eval_data``."""
    *_, epochs, batch, n_eval = FITS[name]
    jimp, timp, xs, ys = _pair(name)
    assert len(xs) % batch
    ev = (xs[:n_eval], ys[:n_eval])
    want = jimp.fit((xs, ys), epochs=epochs, batch_size=batch, lr=LR,
                    eval_data=ev)
    got = timp.fit((xs, ys), epochs=epochs, batch_size=batch, lr=LR,
                   eval_data=ev)
    assert len(got["history"]) == epochs
    for a, b in zip(got["history"], want["history"]):
        assert sorted(a) == sorted(b) == ["acc", "epoch", "loss", "val_acc"]
        for k in ("loss", "acc", "val_acc"):
            assert a[k] == pytest.approx(b[k], rel=1e-5), (k, a, b)
    assert got["final"] == got["history"][-1]
    steps = epochs * -(-len(xs) // batch)
    for a, b in zip(tree.leaves(timp.params), jax.tree.leaves(jimp.params)):
        assert not a.requires_grad
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2 * LR * steps + 1e-5)
    np.testing.assert_allclose(timp.logits(xs).numpy(),
                               np.asarray(jimp.logits(xs)), rtol=1e-4,
                               atol=1e-4)


def test_loss_fn_matches_jax():
    jimp, timp, xs, ys = _pair("conv1d_mfcc")
    jl, jm = jimp.loss_fn(jimp.params, xs[:9], ys[:9])
    tl, tm = timp.loss_fn(timp.params, xs[:9], ys[:9])
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    assert float(tm["acc"]) == float(jm["acc"])
    assert not tm["loss"].requires_grad


def test_fit_draws_its_weights_and_trains_a_copy():
    """Without weights, ``fit`` draws them from the default generator
    (seed 0 on the Impulse's device); the caller's tensors are not
    updated in place; cuDNN's TF32 is off over the backward and the
    caller's setting is back after."""
    _, timp, xs, ys = _pair("conv1d_mfcc")
    fresh = TImpulse(timp.dsp, timp.learn, timp.input_shape, device="cpu")
    seeded = TImpulse(timp.dsp, timp.learn, timp.input_shape, device="cpu")
    seeded.init(torch.Generator().manual_seed(0))
    before = tree.map_tree(torch.clone, seeded.params)
    seen = []
    apply = timp.learn.apply_fn

    def spy(cfg, params, feats):
        out = apply(cfg, params, feats)
        out.register_hook(lambda g: seen.append(
            torch.backends.cudnn.allow_tf32))
        return out

    learn = type(timp.learn)(timp.learn.cfg, timp.learn.init_fn, spy)
    fresh.learn = seeded.learn = learn
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        a = fresh.fit((xs, ys), epochs=1, batch_size=8, lr=LR)
        keep = seeded.params
        b = seeded.fit((xs, ys), epochs=1, batch_size=8, lr=LR)
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert seen and not any(seen)
    assert a["history"] == b["history"]
    for x, y, z in zip(tree.leaves(fresh.params), tree.leaves(seeded.params),
                       tree.leaves(before)):
        assert torch.equal(x, y) and not torch.equal(y, z)
    for x, z in zip(tree.leaves(keep), tree.leaves(before)):
        assert torch.equal(x, z)


@pytest.mark.parametrize("shape", [(8, 8), (3, 5, 7), (2, 2, 4, 6), (9,)])
def test_fake_quant_ste_bitwise(shape):
    w = (np.random.RandomState(len(shape)).randn(*shape) * 2) \
        .astype(np.float32)
    want = np.asarray(jq.fake_quant_ste(jnp.asarray(w)))
    got = tq.fake_quant_ste(torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)
    if len(shape) == 1:
        np.testing.assert_array_equal(got.numpy(), w)


def test_qat_ste_gradient_is_identity():
    """The gradient of sum(fake_quant_ste(w)^2) is 2 * fake_quant_ste(w),
    as ``jax.grad`` finds: the quantization passes the gradient through."""
    w = np.random.RandomState(0).randn(8, 8).astype(np.float32)
    want = np.asarray(jax.grad(
        lambda p: jnp.sum(jq.fake_quant_ste(p) ** 2))(jnp.asarray(w)))
    t = torch.from_numpy(w).requires_grad_(True)
    (tq.fake_quant_ste(t) ** 2).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-6)
    g = torch.randn(8, 8)
    t2 = torch.from_numpy(w).requires_grad_(True)
    tq.fake_quant_ste(t2).backward(g)
    assert torch.equal(t2.grad, g)


def test_qat_params_matches_jax():
    jimp, timp, _, _ = _pair("conv1d_mfcc")
    want = jq.qat_params(jimp.params)
    got = tq.qat_params(timp.params)
    for a, b in zip(tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
