"""Port parity: the VLM backbone (qwen2-vl-72b) and position batches on
the other trunks, against the JAX package, on the CPU.

qwen2-vl's smoke config in float32, the JAX package's own weights carried
across.  Batches bring the stub frontend's patch embeddings and
three-stream M-RoPE positions whose temporal stream is not the index (an
image's patches share one temporal position; one row ends in pads at
−1), so the attention must mask by position: ``forward_train``'s loss and
every gradient, ``forward_prefill``'s logits and cache (``full_pos`` the
temporal stream), ``forward_decode`` after ``grow_cache`` (the rows
written past the prompt, positions past its largest id), each in float
and int8, and ``forward_prefill_chunk`` on text (chunks take one-stream
positions), against the JAX entry points on the same numpy inputs.  Then
position batches on two other trunks: internlm2's packed rows (two
sequences a row, positions restarting, pads) and gemma3's window.  Last,
the frontend's input shapes, the weights' tree and the launchers.
Tolerances: float32 sums in another order, logits and caches 1e-5, losses
1e-5, gradients rtol 1e-4 plus atol 1e-6; int8 1e-4 (a last-bit
difference moves an activation across a rounding boundary of its
quantizer).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.arch import ShapeConfig
from repro.core import quantize as jq
from repro.models import api as japi
from repro.models import params as jparams
from repro.models import transformer as jtr
from repro.models.params import init_params as jinit
from repro.serve import kvcache as jkv
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch.core import quantize as tq
from repro_torch.core.tree import leaves
from repro_torch.launch import train as tlaunch
from repro_torch.models import api as tapi
from repro_torch.models import transformer as ttr
from repro_torch.models.params import init_params as tinit
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import kvcache as tkv
from repro_torch.serve.server import ContinuousBatchServer
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_train_step

torch.set_num_threads(1)

ARCH = "qwen2-vl-72b"
ATOL = 1e-5
INT8_ATOL = 1e-4
_SETUPS = {}


def _setup(arch):
    if arch not in _SETUPS:
        jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype="float32")
        tcfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype="float32")
        jp = jinit(jcfg, jax.random.key(0))
        _SETUPS[arch] = (jcfg, tcfg, jp)
    return _SETUPS[arch]


def _carry(jp, trainable=False):
    return params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                             trainable=trainable)


def _vlm_batch(cfg, seed=0):
    """Two rows of 24: row 0 is 3 text tokens, a 1 x 3 x 4 image and 9
    text tokens (temporal stream 0..16, the patches all at 3); row 1 the
    same shifted by 5, its last 4 entries pads (positions −1, labels
    −1).  Patch embeddings a normal times 0.1, as the stub frontend's."""
    rng = np.random.RandomState(seed)
    one = tapi.mrope_positions([("text", 3), ("image", (1, 3, 4)),
                                ("text", 9)]).numpy()
    pos = np.stack([one, one + 5]).astype(np.int32)
    pos[1, -4:] = -1
    emb = (rng.randn(2, 24, cfg.d_model) * 0.1).astype(np.float32)
    labels = rng.randint(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    labels[1, -4:] = -1
    return {"embeddings": emb, "positions": pos, "labels": labels}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _weights(jp, tp, precision):
    if precision == "float":
        return jp, tp, None, None
    jpol, tpol = jq.policy_for(precision), tq.policy_for(precision)
    return (jq.quantize_model_params(jp, jpol),
            tq.quantize_model_params(tp, tpol), jpol, tpol)


def _leaf_list(leaf):
    return list(leaf) if isinstance(leaf, tuple) else [leaf]


def _assert_cache_close(jcache, tcache, atol):
    assert set(tcache) == set(jcache)
    for key, jleaf in jcache.items():
        jl, tl = jax.tree.leaves(jleaf), _leaf_list(tcache[key])
        for a, t in zip(jl, tl):
            assert tuple(t.shape) == a.shape, key
            if key.endswith("_pos") or t.dtype == torch.int8:
                np.testing.assert_array_equal(t.numpy(), np.asarray(a),
                                              err_msg=key)
            else:
                np.testing.assert_allclose(t.float().numpy(),
                                           np.asarray(a, np.float32),
                                           atol=atol, err_msg=key)


# ---------------------------------------------------------------------------
# qwen2-vl: the four entry points on embeddings and image positions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("remat", ["none", "full"])
def test_forward_train_loss_and_grads_match_jax(remat):
    """Loss and every weight's gradient against ``jax.value_and_grad`` of
    the reference's ``forward_train`` on embeddings and image positions."""
    jcfg, tcfg, jp = _setup(ARCH)
    batch = _vlm_batch(tcfg)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jtr.forward_train(jcfg, p, _j(batch), remat=remat),
        has_aux=True)(jp)
    params = _carry(jp, trainable=True)
    loss, metrics = ttr.forward_train(tcfg, params, _t(batch), remat=remat)
    # the token table is unread on embedding batches: no gradient (JAX:
    # zeros)
    grads = torch.autograd.grad(loss, leaves(params.tree()),
                                allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=ATOL)
    assert int(metrics["tokens"]) == int(jm["tokens"]) == 44
    want = [np.asarray(x) for x in leaves(jax.tree.map(np.asarray, jgrads))]
    assert len(grads) == len(want)
    assert sum(g is None for g in grads) == 1
    for g, w in zip(grads, want):
        got = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-6)


def test_train_step_on_embeddings_matches_jax():
    """One AdamW step (``make_train_step``) on an embedding batch: the
    token table, which the batch does not reach, takes a zero gradient
    (weight decay alone moves it), as under ``jax.grad``; every weight
    after the step within a few ulp of lr (AdamW's division by sqrt(v)
    turns a last-bit gradient difference into up to lr), atol 1e-5."""
    jcfg, tcfg, jp = _setup(ARCH)
    batch = _vlm_batch(tcfg, seed=3)
    cfg_opt = dict(lr=1e-3)
    jstep = jmake_train_step(jcfg, remat="none",
                             opt=jopt.AdamWConfig(**cfg_opt))
    jparams_after, _, jm = jstep(jp, jopt.adamw_init(jp), _j(batch))
    params = _carry(jp, trainable=True)
    step = make_train_step(tcfg, remat="none",
                           opt=topt.AdamWConfig(**cfg_opt))
    params, _, m = step(params, topt.adamw_init(params), _t(batch))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               atol=ATOL)
    got = leaves(params.tree())
    want = leaves(jax.tree.map(np.asarray, jparams_after))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-5)


def test_forward_train_int8_loss_matches_jax():
    """The loss under native int8 weights and activations."""
    jcfg, tcfg, jp = _setup(ARCH)
    jw, tw, jpol, tpol = _weights(jp, _carry(jp), "int8")
    batch = _vlm_batch(tcfg, seed=1)
    jloss, _ = jtr.forward_train(jcfg, jw, _j(batch), policy=jpol)
    with torch.no_grad():
        loss, _ = ttr.forward_train(tcfg, tw, _t(batch), policy=tpol)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=INT8_ATOL)


def test_image_positions_are_not_the_index():
    """The same batch with the default positions gives another loss: the
    comparisons above tell the position masks from the index ones."""
    _, tcfg, jp = _setup(ARCH)
    params = _carry(jp)
    batch = _t(_vlm_batch(tcfg))
    with torch.no_grad():
        by_pos, _ = ttr.forward_train(tcfg, params, batch)
        batch.pop("positions")
        by_index, _ = ttr.forward_train(tcfg, params, batch)
    assert abs(float(by_pos) - float(by_index)) > 1e-3


@pytest.mark.parametrize("precision", ["float", "int8", "int8_fakequant"])
def test_forward_prefill_matches_jax(precision):
    """Last-token logits and the cache: K/V (roped by all three streams),
    ``full_pos`` the temporal stream, bitwise."""
    jcfg, tcfg, jp = _setup(ARCH)
    jw, tw, jpol, tpol = _weights(jp, _carry(jp), precision)
    batch = _vlm_batch(tcfg)
    batch.pop("labels")
    jl, jcache = jtr.forward_prefill(jcfg, jw, _j(batch), policy=jpol)
    tl, tcache = ttr.forward_prefill(tcfg, tw, _t(batch), policy=tpol)
    atol = ATOL if precision == "float" else INT8_ATOL
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol)
    _assert_cache_close(jcache, tcache, atol)
    np.testing.assert_array_equal(tcache["full_pos"].numpy(),
                                  batch["positions"][..., 0])


@pytest.mark.parametrize("precision", ["float", "int8"])
def test_decode_after_grow_matches_jax(precision):
    """``grow_cache`` by 4, then 3 decode steps written at rows 24, 25, 26
    (``write_idx``) at positions one past each row's largest id: logits
    and the cache after every step."""
    jcfg, tcfg, jp = _setup(ARCH)
    jw, tw, jpol, tpol = _weights(jp, _carry(jp), precision)
    batch = _vlm_batch(tcfg)
    batch.pop("labels")
    _, jcache = jtr.forward_prefill(jcfg, jw, _j(batch), policy=jpol)
    _, tcache = ttr.forward_prefill(tcfg, tw, _t(batch), policy=tpol)
    jcache, tcache = jtr.grow_cache(jcfg, jcache, 4), \
        ttr.grow_cache(tcfg, tcache, 4)
    first = batch["positions"][..., 0].max(axis=1) + 1
    rng = np.random.RandomState(2)
    atol = ATOL if precision == "float" else INT8_ATOL
    for t in range(3):
        tok = rng.randint(0, tcfg.vocab_size, 2).astype(np.int32)
        pos = (first + t).astype(np.int32)
        row = np.full(2, 24 + t, np.int32)
        kvl = row + 1
        jl, jcache = jtr.forward_decode(
            jcfg, jw, jcache, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(row), policy=jpol, kv_len=jnp.asarray(kvl))
        tl, tcache = ttr.forward_decode(
            tcfg, tw, tcache, torch.from_numpy(tok), torch.from_numpy(pos),
            torch.from_numpy(row), policy=tpol, kv_len=torch.from_numpy(kvl))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol)
        _assert_cache_close(jcache, tcache, atol)


@pytest.mark.parametrize("precision", ["float", "int8"])
def test_prefill_chunk_text_matches_jax(precision):
    """Text prompts in chunks of 8 (one-stream positions, roped as three
    equal streams; row 1 ragged with a pad tail) on a slot cache, then a
    decode step: logits and cache against the JAX entry points."""
    jcfg, tcfg, jp = _setup(ARCH)
    jw, tw, jpol, tpol = _weights(jp, _carry(jp), precision)
    b, cap, c = 2, 24, 8
    jcache = jkv.alloc_decode_cache(jcfg, b, cap, jpol)
    tcache = tkv.alloc_decode_cache(tcfg, b, cap, "cpu", tpol)
    rng = np.random.RandomState(3)
    atol = ATOL if precision == "float" else INT8_ATOL
    start = np.zeros(b, np.int32)
    for reals in ((8, 8), (8, 3)):
        toks = rng.randint(0, tcfg.vocab_size, (b, c)).astype(np.int32)
        pos = np.full((b, c), -1, np.int32)
        for i, r in enumerate(reals):
            pos[i, :r] = start[i] + np.arange(r)
        kvl = (start + c).astype(np.int32)
        jl, jcache = jtr.forward_prefill_chunk(
            jcfg, jw, jcache, jnp.asarray(toks), jnp.asarray(pos),
            policy=jpol, kv_len=jnp.asarray(kvl))
        tl, tcache = ttr.forward_prefill_chunk(
            tcfg, tw, tcache, torch.from_numpy(toks), torch.from_numpy(pos),
            policy=tpol, kv_len=torch.from_numpy(kvl))
        real = pos >= 0
        np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real],
                                   atol=atol)
        _assert_cache_close(jcache, tcache, atol)
        start += np.array(reals, np.int32)
    tok = rng.randint(0, tcfg.vocab_size, b).astype(np.int32)
    jl, _ = jtr.forward_decode(jcfg, jw, jcache, jnp.asarray(tok),
                               jnp.asarray(start), policy=jpol,
                               kv_len=jnp.asarray(start + 1))
    tl, _ = ttr.forward_decode(tcfg, tw, tcache, torch.from_numpy(tok),
                               torch.from_numpy(start), policy=tpol,
                               kv_len=torch.from_numpy(start + 1))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol)


def test_default_positions_take_the_index_path():
    """Tokens with no positions: the default three equal streams, masked
    by index; bringing those same positions masks by position and gives
    the same loss bitwise."""
    jcfg, tcfg, jp = _setup(ARCH)
    params = _carry(jp)
    tok = np.random.RandomState(4).randint(0, tcfg.vocab_size, (2, 16)) \
        .astype(np.int32)
    batch = {"tokens": tok, "labels": tok}
    jloss, _ = jtr.forward_train(jcfg, jp, _j(batch))
    with torch.no_grad():
        loss, _ = ttr.forward_train(tcfg, params, _t(batch))
        pos = ttr.default_positions(2, 16, cfg=tcfg)
        again, _ = ttr.forward_train(tcfg, params,
                                     {**_t(batch), "positions": pos})
    np.testing.assert_allclose(loss.item(), float(jloss), atol=ATOL)
    assert float(loss) == float(again)


# ---------------------------------------------------------------------------
# Positions on the other trunks
# ---------------------------------------------------------------------------
def _packed_positions(b, s):
    """Two sequences a row, positions restarting at the cut; row 1 ends
    in 5 pads."""
    pos = np.stack([np.r_[np.arange(9), np.arange(s - 9)],
                    np.r_[np.arange(14), np.arange(s - 14)]])
    pos[1, -5:] = -1
    return pos[:b].astype(np.int32)


def test_internlm2_packed_rows_match_jax():
    """internlm2 on packed rows: the training loss and gradients, the
    prefill logits and cache."""
    jcfg, tcfg, jp = _setup("internlm2-1.8b")
    rng = np.random.RandomState(5)
    tok = rng.randint(0, tcfg.vocab_size, (2, 22)).astype(np.int32)
    pos = _packed_positions(2, 22)
    labels = np.where(pos >= 0, np.roll(tok, -1, axis=1), -1) \
        .astype(np.int32)
    batch = {"tokens": tok, "positions": pos, "labels": labels}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jtr.forward_train(jcfg, p, _j(batch), remat="none"),
        has_aux=True)(jp)
    params = _carry(jp, trainable=True)
    loss, _ = ttr.forward_train(tcfg, params, _t(batch), remat="none")
    grads = torch.autograd.grad(loss, leaves(params.tree()))
    np.testing.assert_allclose(loss.item(), float(jloss), atol=ATOL)
    for g, w in zip(grads, leaves(jax.tree.map(np.asarray, jgrads))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)
    pre = {"tokens": tok, "positions": pos}
    jl, jcache = jtr.forward_prefill(jcfg, jp, _j(pre))
    tl, tcache = ttr.forward_prefill(tcfg, _carry(jp), _t(pre))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    _assert_cache_close(jcache, tcache, ATOL)


def test_gemma3_window_by_position_matches_jax():
    """gemma3 (window 8) on rows whose positions start at 3 and 40 (the
    window by position, not by index; S 13, where the reference masks a
    whole sequence): prefill logits and cache (rings placed by position)
    and the training loss."""
    jcfg, tcfg, jp = _setup("gemma3-4b")
    assert tcfg.sliding_window == 8
    rng = np.random.RandomState(6)
    tok = rng.randint(0, tcfg.vocab_size, (2, 13)).astype(np.int32)
    pos = np.stack([3 + np.arange(13), 40 + np.arange(13)]) \
        .astype(np.int32)
    pos[0, 5] = 6            # a tie: two entries on one position
    jl, jcache = jtr.forward_prefill(jcfg, jp, _j({"tokens": tok,
                                                   "positions": pos}))
    tl, tcache = ttr.forward_prefill(tcfg, _carry(jp), _t(
        {"tokens": tok, "positions": pos}))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    _assert_cache_close(jcache, tcache, ATOL)
    batch = {"tokens": tok, "positions": pos, "labels": tok}
    jloss, _ = jtr.forward_train(jcfg, jp, _j(batch), remat="none")
    with torch.no_grad():
        loss, _ = ttr.forward_train(tcfg, _carry(jp), _t(batch),
                                    remat="none")
    np.testing.assert_allclose(loss.item(), float(jloss), atol=ATOL)


# ---------------------------------------------------------------------------
# Inputs, weights, launchers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("train", [True, False], ids=["train", "prefill"])
def test_input_shapes_match_jax(train):
    """The frontend's inputs, names, shapes and dtypes in the JAX order:
    labels, patch embeddings (B, S, d) in the activation dtype, positions
    (B, S, 3) int32; no tokens.  Synthetic positions are the index in
    each stream."""
    jcfg, tcfg = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    shape = ShapeConfig("x", 32, 4, "train" if train else "prefill")
    specs = (japi.train_input_specs if train
             else japi.prefill_input_specs)(jcfg, shape)
    got = tapi.input_shapes(tcfg, 4, 32, train)
    assert list(got) == list(specs)
    for name, sds in specs.items():
        assert got[name][0] == sds.shape, name
        assert str(got[name][1]).removeprefix("torch.") == str(sds.dtype)
    inputs = tapi.synthetic_inputs(tcfg, 4, 32, torch.Generator()
                                   .manual_seed(0), train, device="cpu")
    np.testing.assert_array_equal(
        inputs["positions"].numpy(),
        np.asarray(japi.synthetic_inputs(jcfg, shape, jax.random.key(0))
                   ["positions"]))
    assert inputs["embeddings"].dtype == tcfg.activation_dtype


def test_param_tree_matches_jax():
    """The VLM's weights: the uniform dense tree of the JAX package, leaf
    for leaf, and the parameter counts (smoke and full)."""
    jcfg, tcfg = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    jp = jax.tree.map(np.asarray, jinit(jcfg, jax.random.key(0)))
    tp = tinit(tcfg, torch.Generator().manual_seed(0), "cpu")
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = dict(tp.named_parameters())
    assert len(got) == len(want)
    for path, leaf in want:
        name = ".".join(p.key for p in path)
        assert tuple(got[name].shape) == leaf.shape, name
    assert sum(p.numel() for p in tp.parameters()) == \
        jparams.param_count(jcfg)
    assert tconfigs.get(ARCH).param_count() == \
        jconfigs.get(ARCH).param_count()


def test_launchers_train_and_refuse_serving():
    """``launch/train.py`` builds qwen2-vl on token batches (default
    three-stream positions) and takes a step; the serving engines refuse
    a frontend arch, as the reference's do."""
    cfg, params, opt_state, step = tlaunch.build(
        ARCH, smoke=True, n_micro=1, lr=1e-3, grad_compression=None,
        remat="none", device=torch.device("cpu"))
    tok = torch.randint(0, cfg.vocab_size, (2, 12),
                        generator=torch.Generator().manual_seed(0))
    _, _, metrics = step(params, opt_state, {"tokens": tok, "labels": tok})
    assert np.isfinite(float(metrics["loss"]))
    with pytest.raises(NotImplementedError, match="frontend"):
        ContinuousBatchServer(cfg, params, slots=2, max_prompt=8,
                              device="cpu")
