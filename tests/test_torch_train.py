"""Port parity: the training path against the JAX package, on the CPU.

The ``internlm2-1.8b`` smoke config in float32; the JAX package's own
``init_params`` weights are carried across as trainable f32 masters
(``params_from_numpy(..., trainable=True)``); batches from the two
packages' Markov token streams, which are bitwise equal.  Tolerances,
each stated where it is used: both sides compute in float32 in another
summation order, so losses agree to about 1e-6 and gradients to about
1e-6 of their scale; AdamW divides by sqrt(v), which turns a gradient's
last-bit difference into at most a few ulp of lr in a step.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.data import synthetic as jsyn
from repro.models import transformer as jtr
from repro.models.params import init_params as jinit
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro.train import schedule as jsched
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.tree import leaves
from repro_torch.data import synthetic as tsyn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttr
from repro_torch.models.params import init_params, params_from_numpy
from repro_torch.train import compression as tcomp
from repro_torch.train import optimizer as topt
from repro_torch.train import schedule as tsched
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

ARCH = "internlm2-1.8b"


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype="float32")
    jp = jinit(jcfg, jax.random.key(0))
    tokens = jsyn.token_stream(20_000, jcfg.vocab_size, seed=1)
    return jcfg, tcfg, jp, tokens


def _carry(jp):
    """The JAX weights as the port's trainable f32 masters on the CPU."""
    return params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                             trainable=True)


def _np_leaves(tree):
    return [np.asarray(x) for x in leaves(jax.tree.map(np.asarray, tree))]


def _batch(tokens, b, s, seed):
    return next(jsyn.lm_batches(tokens, b, s, seed=seed))


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _assert_trees_close(got, want, rtol, atol):
    g, w = leaves(got), _np_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=rtol,
                                   atol=atol)


def test_token_stream_and_batches_bitwise():
    a = jsyn.token_stream(5_000, 500, seed=3)
    b = tsyn.token_stream(5_000, 500, seed=3)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    ja, ta = jsyn.lm_batches(a, 4, 32, seed=2), tsyn.lm_batches(b, 4, 32,
                                                                seed=2)
    for _ in range(3):
        x, y = next(ja), next(ta)
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])


def test_lm_loss_padded_vocab_and_ignored_labels():
    """Columns >= vocab_size masked, labels -1 ignored; f32 (atol 1e-6)."""
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 7, 64).astype(np.float32) * 3
    labels = rng.randint(0, 50, (2, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, 6] = -1
    jl, jm = jtr.lm_loss(jnp.asarray(logits), jnp.asarray(labels), 50)
    tl, tm = ttr.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                         50)
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-6)
    assert int(tm["tokens"]) == int(jm["tokens"]) == 10
    # a padded column's logit never counts, however large
    big = logits.copy()
    big[..., 50:] = 1e4
    tl2, _ = ttr.lm_loss(torch.from_numpy(big), torch.from_numpy(labels), 50)
    assert float(tl2) == float(tl)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_forward_train_loss_and_grads_match_jax(setup, remat):
    """Loss (atol 1e-5) and every gradient (rtol 1e-4, atol 1e-6) against
    ``jax.value_and_grad`` of the reference's ``forward_train``."""
    jcfg, tcfg, jp, tokens = setup
    batch = _batch(tokens, 2, 24, seed=4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jtr.forward_train(jcfg, p, jb, remat=remat),
        has_aux=True)(jp)
    params = _carry(jp)
    loss, metrics = ttr.forward_train(tcfg, params, _t(batch), remat=remat)
    grads = torch.autograd.grad(loss, leaves(params.tree()))
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    assert int(metrics["tokens"]) == 48
    g = [x.numpy() for x in grads]
    for a, b in zip(g, _np_leaves(jgrads)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_grads_reach_stacked_leaves_and_views_stay_fresh(setup):
    """Every stacked leaf gets one gradient for all its layers, and an
    in-place update shows in the next forward (no stale per-layer view)."""
    _, tcfg, jp, tokens = setup
    params = _carry(jp)
    batch = _t(_batch(tokens, 2, 16, seed=1))
    loss, _ = ttr.forward_train(tcfg, params, batch, remat="none")
    loss.backward()
    wq = params["blocks"]["attn"]["wq"]
    assert wq.grad is not None and wq.grad.shape == wq.shape
    assert all(float(wq.grad[i].abs().sum()) > 0 for i in range(wq.shape[0]))
    with torch.no_grad():
        wq.mul_(0.0)
    loss2, _ = ttr.forward_train(tcfg, params, batch, remat="none")
    views = params["blocks"].unstack()
    assert float(views[0]["attn"]["wq"].detach().abs().sum()) == 0.0
    assert loss2.item() != loss.item()


def test_adamw_update_matches_jax(setup):
    """Two AdamW steps leaf for leaf (clip active: grad norm above 1), on
    the same gradients; params and moments at rtol 1e-6, atol 1e-7."""
    _, _, jp, _ = setup
    rng = np.random.RandomState(5)
    grads = jax.tree.map(
        lambda p: rng.randn(*p.shape).astype(np.float32) * 0.3, jp)
    cfg = jopt.AdamWConfig(lr=1e-3)
    js = jopt.adamw_init(jp)
    jparams = jp
    params = _carry(jp)
    ts = topt.adamw_init(params)
    tgrads = jax.tree.map(torch.from_numpy, grads)
    for _ in range(2):
        jparams, js, jm = jopt.adamw_update(grads, js, jparams, cfg)
        _, ts, tm = topt.adamw_update(tgrads, ts, params,
                                      topt.AdamWConfig(lr=1e-3))
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 2
    _assert_trees_close(params.tree(), jparams, 1e-6, 1e-7)
    _assert_trees_close(ts["m"], js["m"], 1e-6, 1e-7)
    _assert_trees_close(ts["v"], js["v"], 1e-6, 1e-9)


def test_sgd_update_matches_jax(setup):
    """One SGD step leaf for leaf on the same gradients: params at rtol
    1e-6, atol 1e-7 (one f32 multiply-add on either side), the grad norm
    at rtol 1e-6."""
    _, _, jp, _ = setup
    rng = np.random.RandomState(6)
    grads = jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32),
                         jp)
    jparams, _, jm = jopt.sgd_update(grads, {}, jp, 0.05)
    params = _carry(jp)
    out, _, tm = topt.sgd_update(jax.tree.map(torch.from_numpy, grads), {},
                                 params, 0.05)
    assert out is params
    _assert_trees_close(params.tree(), jparams, 1e-6, 1e-7)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)


def test_lr_finder_matches_jax():
    """The sweep on a toy probe, one gradient step on |w|^2 / 2 from w = 1
    (the loss falls with lr, then grows past lr 2 until the sweep stops):
    the same curve and suggestion from both packages, exactly (the same
    float64 numpy arithmetic)."""
    def probe(lr):
        return 0.5 * (1.0 - lr) ** 2

    kw = dict(lr_min=1e-4, lr_max=10.0, n_probe=30)
    want = jsched.lr_finder(probe, **kw)
    got = tsched.lr_finder(probe, **kw)
    assert got == want
    suggested, curve = got
    assert len(curve) < 30 and 1e-4 < suggested < 1.0


def test_batch_reshape_check_matches_jax():
    """A global batch of 8 splits into 1, 2 or 8 microbatches; into 3 or 5
    both packages raise the same message."""
    from repro.core.arch import ShapeConfig as JShape
    from repro.train.train_step import batch_reshape_check as jcheck
    from repro_torch.core.arch import ShapeConfig
    from repro_torch.train.train_step import batch_reshape_check
    args = ("train_8x64", 64, 8, "train")
    raised = []
    for n_micro in (1, 2, 3, 5, 8):
        try:
            jcheck(JShape(*args), n_micro)
        except ValueError as e:
            raised.append(n_micro)
            with pytest.raises(ValueError, match=f"^{e}$"):
                batch_reshape_check(ShapeConfig(*args), n_micro)
        else:
            batch_reshape_check(ShapeConfig(*args), n_micro)
    assert raised == [3, 5]


def test_warmup_cosine_and_constant_match_jax():
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        kw = dict(base_lr=3e-4, warmup=10, total=100)
        assert float(tsched.warmup_cosine(step, **kw)) == pytest.approx(
            float(jsched.warmup_cosine(step, **kw)), rel=1e-6, abs=1e-12)
    assert float(tsched.constant(7, base_lr=0.5)) == 0.5


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_grad_compression_matches_jax(scheme):
    """Three rounds of compression with error feedback: compressed grads
    and residuals at atol 1e-6 (one f32 division and rounding each)."""
    rng = np.random.RandomState(7)
    shapes = {"a": (40, 30), "b": {"c": (100,)}}
    jres = tres = None
    for _ in range(3):
        g = jax.tree.map(lambda s: rng.randn(*s).astype(np.float32), shapes,
                         is_leaf=lambda s: isinstance(s, tuple))
        jg, jres = jcomp.compress_grads(g, jres, scheme, topk_frac=0.05)
        tg, tres = tcomp.compress_grads(
            jax.tree.map(torch.from_numpy, g), tres, scheme, topk_frac=0.05)
        _assert_trees_close(tg, jg, 0, 1e-6)
        _assert_trees_close(tres, jres, 0, 1e-6)
    if scheme == "topk":
        assert int((tg["a"] != 0).sum()) == 60


def test_microbatches_equal_one_batch(setup):
    """n_microbatch=2 against 1 on the same global batch: loss and params
    after the step at atol 1e-5 (the two sum the gradient in another
    order)."""
    _, tcfg, jp, tokens = setup
    batch = _batch(tokens, 4, 16, seed=3)
    out = []
    for n in (1, 2):
        params = _carry(jp)
        step = make_train_step(tcfg, n_microbatch=n, remat="none")
        _, _, m = step(params, topt.adamw_init(params), batch)
        out.append((float(m["loss"]), params))
    assert abs(out[0][0] - out[1][0]) < 1e-5
    for a, b in zip(leaves(out[0][1].tree()), leaves(out[1][1].tree())):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-5)


def _assert_trees_close_but_boundaries(got, want, atol, boundary_atol):
    """Within ``atol`` but for at most 0.1% of each leaf's elements, which
    stay within ``boundary_atol``: under int8 gradient compression an
    element whose g / scale lies on a rounding boundary (k + 0.5) within
    the gradients' last-bit difference rounds the other way on one side
    and moves by one quantum."""
    for a, b in zip(leaves(got), _np_leaves(want)):
        err = np.abs(a.detach().numpy() - b)
        assert err.max() <= boundary_atol
        assert (err > atol).mean() <= 1e-3


@pytest.mark.parametrize("compression", [None, "int8"])
def test_three_train_steps_match_jax(setup, compression):
    """Three ``make_train_step`` steps (AdamW lr 1e-3, remat full) on the
    same batches: loss and grad norm at rtol 1e-5, params at atol 1e-5
    (a few ulp of lr: AdamW's sqrt(v) division amplifies the gradients'
    last-bit differences); with int8 compression, elements on a rounding
    boundary of the quantizer within a tenth of lr."""
    jcfg, tcfg, jp, tokens = setup
    jstep = jax.jit(jmake_train_step(
        jcfg, remat="full", opt=jopt.AdamWConfig(lr=1e-3),
        grad_compression=compression))
    tstep = make_train_step(tcfg, remat="full",
                            opt=topt.AdamWConfig(lr=1e-3),
                            grad_compression=compression)
    js = jopt.adamw_init(jp)
    params = _carry(jp)
    ts = topt.adamw_init(params)
    if compression:
        js["residual"] = jcomp.init_residual(jp)
        ts["residual"] = tcomp.init_residual(params)
    jparams = jp
    batches = jsyn.lm_batches(tokens, 2, 24, seed=9)
    for _ in range(3):
        batch = next(batches)
        jparams, js, jm = jstep(jparams, js,
                                {k: jnp.asarray(v) for k, v in batch.items()})
        params, ts, tm = tstep(params, ts, batch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5)
    if compression:
        _assert_trees_close_but_boundaries(params.tree(), jparams, 1e-5, 1e-4)
    else:
        _assert_trees_close(params.tree(), jparams, 0, 1e-5)


def _trainer(tcfg, params, path, **kw):
    step = make_train_step(tcfg, remat="none",
                           opt=topt.AdamWConfig(lr=1e-3))
    return Trainer(step, params, topt.adamw_init(params), ckpt_dir=path,
                   config=TrainerConfig(log_every=0, **kw), device="cpu")


def test_trainer_loss_falls(setup, tmp_path):
    _, tcfg, jp, tokens = setup
    tr = _trainer(tcfg, _carry(jp), tmp_path / "ck", total_steps=30,
                  checkpoint_every=0)
    res = tr.run(iter(tsyn.lm_batches(tokens, 8, 32)))
    first = np.mean([h["loss"] for h in res["history"][:5]])
    last = np.mean([h["loss"] for h in res["history"][-5:]])
    assert last < first - 0.3, (first, last)
    assert tr.ckpt.all_steps() == [30]


def test_trainer_crash_and_resume(setup, tmp_path):
    """Killed at step 25, resumed from the checkpoint of step 20: the
    weights are those of step 20 bit for bit, and the run finishes."""
    _, tcfg, jp, tokens = setup
    kw = dict(total_steps=40, checkpoint_every=10, restore_best=False)
    t1 = _trainer(tcfg, _carry(jp), tmp_path / "ck", **kw)
    with pytest.raises(RuntimeError, match="injected node failure"):
        t1.run(iter(tsyn.lm_batches(tokens, 4, 32)), fail_at=25)
    t2 = _trainer(tcfg, _carry(jp), tmp_path / "ck", **kw)
    assert t2.maybe_resume()
    assert t2.step == 20 and int(t2.opt_state["step"]) == 20
    ref = _carry(jp)
    Checkpointer(tmp_path / "ck").restore((ref, topt.adamw_init(ref)), 20)
    for a, b in zip(leaves(t2.params.tree()), leaves(ref.tree())):
        assert torch.equal(a, b)
    res = t2.run(iter(tsyn.lm_batches(tokens, 4, 32)))
    assert t2.step == 40 and np.isfinite(res["final_loss"])
    assert [h["step"] for h in res["history"]] == list(range(21, 41))


def test_trainer_restores_best(setup, tmp_path):
    """At lr 1e-1 the loss blows up after its best early step: the trainer
    restores the weights of that step's checkpoint."""
    _, tcfg, jp, tokens = setup
    step = make_train_step(tcfg, remat="none", opt=topt.AdamWConfig(lr=0.1))
    params = _carry(jp)
    tr = Trainer(step, params, topt.adamw_init(params),
                 ckpt_dir=tmp_path / "ck", device="cpu",
                 config=TrainerConfig(total_steps=12, checkpoint_every=1,
                                      keep_checkpoints=20, log_every=0))
    res = tr.run(iter(tsyn.lm_batches(tokens, 4, 32)))
    best = res["best"]["step"]
    assert best < 12 and res["restored_step"] == best
    ref = _carry(jp)
    Checkpointer(tmp_path / "ck").restore((ref, topt.adamw_init(ref)), best)
    for a, b in zip(leaves(tr.params.tree()), leaves(ref.tree())):
        assert torch.equal(a, b)


def test_checkpointer_atomicity_and_round_trip(tmp_path):
    """A checkpoint without a manifest is invisible; values of every dtype
    (bf16 included) come back bit for bit, in place; keep=2 keeps the
    two newest; a leaf of another shape is refused."""
    ck = Checkpointer(tmp_path, keep=2)
    tree = {"a": torch.arange(6.0), "b": {"c": torch.randn(2, 3)
                                           .to(torch.bfloat16)},
            "s": torch.tensor(7, dtype=torch.int32)}
    ck.save(5, tree, extra={"best": {"loss": 1.5, "step": 5}})
    bad = tmp_path / "step_00000009"
    bad.mkdir()
    (bad / "a.npy").write_bytes(b"garbage")
    assert ck.latest_step() == 5
    into = {"a": torch.zeros(6), "b": {"c": torch.zeros(2, 3,
                                                       dtype=torch.bfloat16)},
            "s": torch.tensor(0, dtype=torch.int32)}
    out, extra = ck.restore(into)
    assert out is into and extra["best"]["step"] == 5
    for k in ("a", "s"):
        assert torch.equal(into[k], tree[k])
    assert torch.equal(into["b"]["c"], tree["b"]["c"])
    for s in (6, 7):
        ck.save(s, tree)
    assert ck.all_steps() == [6, 7]
    with pytest.raises(ValueError, match="does not fit"):
        ck.restore({"a": torch.zeros(5), "b": into["b"], "s": into["s"]})


def test_checkpoint_layout_names_leaves_as_jax(setup, tmp_path):
    """The manifest names the (params, opt_state) leaves by the JAX
    package's paths ("0/blocks/attn/wq", "1/step", ...)."""
    _, _, jp, _ = setup
    JCheckpointer(tmp_path / "j").save(1, (jp, jopt.adamw_init(jp)))
    params = _carry(jp)
    Checkpointer(tmp_path / "t").save(1, (params, topt.adamw_init(params)))
    names = [set(json.loads((tmp_path / d / "step_00000001" /
                             "manifest.json").read_text())["leaves"])
             for d in ("j", "t")]
    assert names[0] == names[1] and "0/blocks/attn/wq" in names[1]


def test_training_path_refuses_what_it_does_not_port(setup):
    """Positions/embeddings batches run (refused until the VLM slice, the
    test keeps its name): the default positions brought by the caller
    give the loss of none, embeddings of the tokens the tokens' loss,
    both differentiable; the "dots" remat policies (once refused) give
    the loss of none; cross-attention (ported with the enc-dec backbone)
    raises under a causal mask between two lengths."""
    _, tcfg, jp, tokens = setup
    params = _carry(jp)
    batch = _t(_batch(tokens, 1, 8, seed=0))
    base, _ = ttr.forward_train(tcfg, params, batch)
    emb = ttr.embed_tokens(params, batch["tokens"], tcfg).detach()
    for key, val in (("positions", ttr.default_positions(1, 8)),
                     ("embeddings", emb.requires_grad_())):
        loss, _ = ttr.forward_train(tcfg, params, {**batch, key: val})
        np.testing.assert_allclose(loss.item(), base.item(), atol=1e-6)
        grads = torch.autograd.grad(loss, leaves(params.tree()),
                                    allow_unused=True)
        assert sum(g is not None for g in grads) >= len(grads) - 1
    for policy in ("dots", "dots_no_batch"):
        loss, _ = ttr.forward_train(tcfg, params, batch, remat=policy)
        assert torch.equal(loss, base)
    p = params["blocks"].unstack()[0]["attn"]
    x = torch.zeros(1, 8, 64)
    kv = torch.zeros(1, 2, 2, 16)
    with pytest.raises(ValueError, match="causal=False"):
        tlayers.attention_layer(p, x, torch.zeros(1, 8), n_heads=4,
                                n_kv_heads=2, head_dim=16,
                                rope_variant="rope", rope_theta=1e4,
                                kv_override=(kv, kv))


def test_training_entry_points_need_a_gpu_unless_asked(setup, monkeypatch,
                                                       tmp_path):
    """Without a GPU, ``init_params`` for training, the ``Trainer`` and
    the launcher raise unless the CPU is asked for."""
    _, tcfg, jp, _ = setup
    from repro_torch.launch import train as launch
    params = init_params(tcfg, torch.Generator().manual_seed(0), "cpu",
                         trainable=True)
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in params.parameters())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(tcfg, torch.Generator().manual_seed(0), trainable=True)
    step = make_train_step(tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(step, params, topt.adamw_init(params), ckpt_dir=tmp_path)
    monkeypatch.setattr("sys.argv", ["train", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.main()


def test_launcher_trains_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``--device cpu`` with microbatches, remat full and int8 gradient
    compression: the loss and the held-out loss are finite and the run
    checkpoints."""
    from repro_torch.launch import train as launch
    out = tmp_path / "out.json"
    monkeypatch.setattr("sys.argv", [
        "train", "--device", "cpu", "--steps", "4", "--batch", "4",
        "--seq", "16", "--micro", "2", "--remat", "full",
        "--grad-compression", "int8", "--ckpt-dir", str(tmp_path / "ck"),
        "--ckpt-every", "2", "--out", str(out)])
    launch.main()
    rec = json.loads(out.read_text())
    assert rec["steps"] == 4 and np.isfinite(rec["final"])
    assert len(rec["held_out"]) == 2 and np.isfinite(rec["held_out"]).all()
    printed = capsys.readouterr().out
    assert "device=cpu" in printed and "held-out loss" in printed
    assert Checkpointer(tmp_path / "ck").all_steps() == [2, 4]


def test_adamw_slices_give_the_whole_leaf_bitwise(monkeypatch):
    """``adamw_update`` updates each leaf in flat slices (the f32
    temporaries of a 1.26 B-weight token table stay small); slices of 7
    elements, none dividing the leaves, give the whole-leaf update bit
    for bit: weights, both moments."""
    rng = np.random.RandomState(12)
    shapes = [(5, 9), (31,), (4, 3, 6)]

    def run(slice_elems):
        monkeypatch.setattr(topt, "_SLICE", slice_elems)
        params = {f"w{i}": torch.from_numpy(rng.randn(*s).astype(np.float32))
                  for i, s in enumerate(shapes)}
        grads = {k: torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
                 for k, v in params.items()}
        state = topt.adamw_init(params)
        for _ in range(2):
            topt.adamw_update(grads, state, params, topt.AdamWConfig(lr=1e-2))
        return params, state
    rng_state = rng.get_state()
    whole = run(1 << 26)
    rng.set_state(rng_state)
    sliced = run(7)
    for a, b in zip(leaves(whole[0]) + leaves(whole[1]["m"])
                    + leaves(whole[1]["v"]),
                    leaves(sliced[0]) + leaves(sliced[1]["m"])
                    + leaves(sliced[1]["v"])):
        assert torch.equal(a, b)
