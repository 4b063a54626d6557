"""Port parity: the encoder-decoder backbone (seamless-m4t-large-v2)
against the JAX package, on the CPU.

The smoke config in float32 with the JAX package's own weights carried
across: the parameter tree and counts (smoke and full), the input shapes,
``encode``, ``forward_prefill`` (logits and every cache leaf, float, int8
and fake-quant int8), ``init_chunk_cache`` and chunks of 1, 4 and 16 then
decode with an idle slot (the cross caches bitwise unchanged), prefill,
``grow_cache`` and decode, ``jax.grad`` of ``forward_train`` for every
leaf (remat none and full), three ``make_train_step`` steps, and the
refusals: a block table, the three engines, both launchers.  Each entry
point is held to its own JAX counterpart, never to another entry point:
under int8 the one-shot prefill attends the unquantized K/V and the
chunks the quantized cross entries, in both packages.  Tolerances: float32
sums in another order, 1e-5; int8 paths 1e-4 (a last-bit difference moves
an activation across a rounding boundary of its quantizer).
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import quantize as jq
from repro.core.arch import ShapeConfig
from repro.data import synthetic as jsyn
from repro.models import api as japi
from repro.models import encdec as jed
from repro.models import params as jparams
from repro.models import transformer as jtr
from repro.models.params import init_params as jinit
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch.core import quantize as tq
from repro_torch.core.tree import leaves
from repro_torch.launch import serve as tlaunch
from repro_torch.launch import train as tlaunch_train
from repro_torch.models import api as tapi
from repro_torch.models import encdec as ted
from repro_torch.models import params as tparams
from repro_torch.models import transformer as ttr
from repro_torch.models.params import params_from_numpy
from repro_torch.serve.server import (ContinuousBatchServer,
                                      PagedBatchServer, StaticBatchServer)
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_train_step

torch.set_num_threads(1)

ARCH = "seamless-m4t-large-v2"
ATOL = 1e-5
INT8_ATOL = 1e-4
FULL_PARAMS = 2_038_556_672


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype="float32")
    jp = jinit(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _weights(setup, precision):
    """(JAX weights, port weights, JAX policy, port policy)."""
    _, _, jp, tp = setup
    if precision == "float":
        return jp, tp, None, None
    jpol, tpol = jq.policy_for(precision), tq.policy_for(precision)
    return (jq.quantize_model_params(jp, jpol),
            tq.quantize_model_params(tp, tpol), jpol, tpol)


def _emb(rng, b, s_enc, d=64):
    return (rng.randn(b, s_enc, d) * 0.1).astype(np.float32)


def _leaves(leaf):
    return list(leaf) if isinstance(leaf, tuple) else [leaf]


def _assert_cache_close(jcache, tcache, atol=ATOL):
    assert sorted(tcache) == sorted(jcache)
    for key, jleaf in jcache.items():
        jl, tl = jax.tree.leaves(jleaf), _leaves(tcache[key])
        assert len(jl) == len(tl), key
        for a, t in zip(jl, tl):
            assert tuple(t.shape) == a.shape, key
            assert str(t.dtype).removeprefix("torch.") == str(a.dtype), key
            if key.endswith("_pos") or t.dtype == torch.int8:
                np.testing.assert_array_equal(t.numpy(), np.asarray(a),
                                              err_msg=key)
            else:
                np.testing.assert_allclose(t.float().numpy(),
                                           np.asarray(a, np.float32),
                                           atol=atol, err_msg=key)


def _clone(leaf):
    return tuple(t.clone() for t in leaf) if isinstance(leaf, tuple) \
        else leaf.clone()


def _assert_same(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# Weights and inputs
# ---------------------------------------------------------------------------
def test_param_tree_and_counts_match_jax(setup):
    """``params_from_numpy`` carries every leaf bit for bit (the encoder's
    ``enc_blocks`` and ``enc_final_norm``, the decoder's ``xattn`` and
    ``xattn_norm``); ``init_params`` gives the JAX tree's shapes; the spec
    trees hold ``param_count`` parameters, 2,038,556,672 at full width."""
    jcfg, tcfg, jp, tp = setup
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jax.tree.map(np.asarray, jp)):
        t = tp
        for key in path:
            t = t[key.key]
        np.testing.assert_array_equal(t.detach().numpy(), leaf)
    init = tparams.init_params(tconfigs.get_smoke(ARCH),
                               torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda a: tuple(a.shape), init.tree()) == shapes
    assert init["blocks"]["xattn"]["wk"].dtype == torch.bfloat16
    assert init["enc_final_norm"].dtype == torch.float32
    assert sum(p.numel() for p in init.parameters()) == \
        jparams.param_count(jcfg)
    full = tconfigs.get(ARCH)
    count = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        tparams.build_specs(full),
        is_leaf=lambda x: isinstance(x, tparams.ParamSpec)))
    assert count == jparams.param_count(jconfigs.get(ARCH)) == FULL_PARAMS


@pytest.mark.parametrize("getter", ["get", "get_smoke"])
def test_input_shapes_match_jax_specs(getter):
    """``api.input_shapes`` is ``train_input_specs`` / ``prefill_input_
    specs`` (names, order, shapes, dtypes); ``synthetic_inputs`` draws
    them, frame embeddings at a tenth of a standard normal."""
    jcfg, tcfg = getattr(jconfigs, getter)(ARCH), getattr(tconfigs,
                                                          getter)(ARCH)
    for kind, fn in (("train", japi.train_input_specs),
                     ("prefill", japi.prefill_input_specs)):
        specs = fn(jcfg, ShapeConfig("x", seq_len=64, global_batch=2,
                                     kind=kind))
        shapes = tapi.input_shapes(tcfg, 2, 64, train=kind == "train")
        assert list(shapes) == list(specs)
        for name, (shape, dtype) in shapes.items():
            assert shape == specs[name].shape, name
            assert str(dtype).removeprefix("torch.") == \
                str(specs[name].dtype), name
    if getter == "get_smoke":
        inputs = tapi.synthetic_inputs(tcfg, 2, 64,
                                       torch.Generator().manual_seed(0),
                                       device="cpu")
        assert inputs["enc_embeddings"].shape == (2, 16, 64)
        assert 0.05 < float(inputs["enc_embeddings"].float().std()) < 0.2
        assert int(inputs["tokens"].max()) < tcfg.vocab_size


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
# the JAX steps compiled once a shape (config and policy static): eager
# dispatch compiles every primitive of every shape anew
_jax_prefill = jax.jit(jed.forward_prefill, static_argnums=(0, 3))
_jax_chunk = jax.jit(jed.forward_prefill_chunk, static_argnums=(0, 5))
_jax_decode = jax.jit(jed.forward_decode, static_argnums=(0,),
                      static_argnames=("policy",))


def test_encode_matches_jax(setup):
    jcfg, tcfg, jp, tp = setup
    emb = _emb(np.random.RandomState(0), 2, 9)
    want = jed.encode(jcfg, jp, jnp.asarray(emb))
    got = ted.encode(tcfg, tp, torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("precision", ["float", "int8", "int8_fakequant"])
def test_forward_prefill_matches_jax(setup, precision):
    """The encoder on 2 x 5 frames, the decoder on 2 x 13 tokens: the
    last-token logits and every cache leaf (``Int8KV`` values bitwise
    under native int8, the round trip under fake-quant)."""
    jcfg, tcfg, _, _ = setup
    jw, tw, jpol, tpol = _weights(setup, precision)
    rng = np.random.RandomState(1)
    emb, tok = _emb(rng, 2, 5), rng.randint(0, 320, (2, 13)).astype(np.int32)
    jl, jcache = _jax_prefill(
        jcfg, jw, {"enc_embeddings": jnp.asarray(emb),
                   "tokens": jnp.asarray(tok)}, jpol)
    tl, tcache = ted.forward_prefill(
        tcfg, tw, {"enc_embeddings": torch.from_numpy(emb),
                   "tokens": torch.from_numpy(tok)}, tpol)
    assert list(tcache) == ["k", "v", "xk", "xv", "full_pos", "enc_pos"]
    atol = ATOL if precision == "float" else INT8_ATOL
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol)
    _assert_cache_close(jcache, tcache, atol)


def _chunk(prompt, p, c):
    real = min(c, len(prompt) - p)
    toks = np.zeros((1, c), np.int32)
    poss = np.full((1, c), -1, np.int32)
    toks[0, :real] = prompt[p:p + real]
    poss[0, :real] = np.arange(p, p + real)
    return toks, poss, np.array([p + c], np.int32), real


def _cat_jax(caches):
    return {key: jax.tree.map(lambda *xs: jnp.concatenate(
        xs, 0 if key.endswith("_pos") else 1), *[c[key] for c in caches])
        for key in caches[0]}


def _cat_port(caches):
    def cat(key, xs):
        axis = 0 if key.endswith("_pos") else 1
        if isinstance(xs[0], tq.Int8KV):
            return tq.Int8KV(*(torch.cat(p, axis) for p in zip(*xs)))
        return torch.cat(xs, axis)
    return {key: cat(key, [c[key] for c in caches]) for key in caches[0]}


@pytest.mark.parametrize("chunk,precision", [
    (1, "float"), (4, "float"), (16, "float"), (4, "int8"),
    (4, "int8_fakequant")])
def test_chunks_then_decode_match_jax(setup, chunk, precision):
    """Three slots, each with its own encoder pass (``init_chunk_cache``,
    capacity 32; 5 frames each); prompts of 13 and 7 tokens prefilled
    in chunks (the last one ragged) into slots 0 and 1; then three decode
    steps with slot 2 idle (``kv_len`` 0).  Every real row's logits and
    every cache leaf against the JAX package; the cross caches ``xk``/
    ``xv`` and ``enc_pos`` bitwise unchanged by every chunk and step, the
    idle slot's and the pad rows' included."""
    jcfg, tcfg, _, _ = setup
    jw, tw, jpol, tpol = _weights(setup, precision)
    atol = ATOL if precision == "float" else INT8_ATOL
    rng = np.random.RandomState(4)
    jcaches, tcaches = [], []
    for _ in range(3):
        emb = _emb(rng, 1, 5)
        jcaches.append(jed.init_chunk_cache(jcfg, jw, jnp.asarray(emb), 32,
                                            jpol))
        tcaches.append(ted.init_chunk_cache(tcfg, tw, torch.from_numpy(emb),
                                            32, tpol))
    _assert_cache_close(_cat_jax(jcaches), _cat_port(tcaches), atol)
    fixed = [{k: _clone(c[k]) for k in ("xk", "xv", "enc_pos")}
             for c in tcaches]
    for slot, n in ((0, 13), (1, 7)):
        prompt = rng.randint(0, jcfg.vocab_size, n).astype(np.int32)
        for p in range(0, n, chunk):
            toks, poss, kvl, real = _chunk(prompt, p, chunk)
            jl, jcaches[slot] = _jax_chunk(
                jcfg, jw, jcaches[slot], jnp.asarray(toks),
                jnp.asarray(poss), jpol, kv_len=jnp.asarray(kvl))
            tl, _ = ted.forward_prefill_chunk(
                tcfg, tw, tcaches[slot], torch.from_numpy(toks),
                torch.from_numpy(poss), tpol, kv_len=torch.from_numpy(kvl))
            np.testing.assert_allclose(tl.numpy()[0, :real],
                                       np.asarray(jl)[0, :real], atol=atol)
    for c, f in zip(tcaches, fixed):
        for k in f:
            _assert_same(c[k], f[k])
    jcache, tcache = _cat_jax(jcaches), _cat_port(tcaches)
    _assert_cache_close(jcache, tcache, atol)
    cross = {k: _clone(tcache[k]) for k in ("xk", "xv", "enc_pos")}
    for t in range(3):
        tok = rng.randint(0, jcfg.vocab_size, 3).astype(np.int32)
        pos = np.array([13 + t, 7 + t, 0], np.int32)
        kvl = np.array([14 + t, 8 + t, 0], np.int32)
        jl, jcache = _jax_decode(jcfg, jw, jcache, jnp.asarray(tok),
                                 jnp.asarray(pos), policy=jpol,
                                 kv_len=jnp.asarray(kvl))
        tl, tcache = ted.forward_decode(tcfg, tw, tcache,
                                        torch.from_numpy(tok),
                                        torch.from_numpy(pos), policy=tpol,
                                        kv_len=torch.from_numpy(kvl))
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2],
                                   atol=atol)
    _assert_cache_close(jcache, tcache, atol)
    for k, leaf in cross.items():
        _assert_same(tcache[k], leaf)


@pytest.mark.parametrize("precision", ["float", "int8"])
def test_prefill_grow_decode_matches_jax(setup, precision):
    """``forward_prefill``, ``grow_cache`` (8 rows: ``k``/``v`` and
    ``full_pos`` grow, ``xk``/``xv``/``enc_pos`` pass through, the same
    tensors) and four decode steps, against the JAX package's."""
    jcfg, tcfg, _, _ = setup
    jw, tw, jpol, tpol = _weights(setup, precision)
    atol = ATOL if precision == "float" else INT8_ATOL
    rng = np.random.RandomState(5)
    emb, tok = _emb(rng, 2, 3), rng.randint(0, 320, (2, 11)).astype(np.int32)
    jl, jcache = _jax_prefill(
        jcfg, jw, {"enc_embeddings": jnp.asarray(emb),
                   "tokens": jnp.asarray(tok)}, jpol)
    tl, tcache = ted.forward_prefill(
        tcfg, tw, {"enc_embeddings": torch.from_numpy(emb),
                   "tokens": torch.from_numpy(tok)}, tpol)
    jcache = jtr.grow_cache(jcfg, jcache, 8)
    grown = ttr.grow_cache(tcfg, tcache, 8)
    for key in ("xk", "xv", "enc_pos"):
        assert grown[key] is tcache[key]
    assert _leaves(grown["k"])[0].shape[2] == 19
    assert grown["full_pos"].shape == (2, 19)
    tcache = grown
    _assert_cache_close(jcache, tcache, atol)
    out_j = np.asarray(jl).argmax(-1).astype(np.int32)
    out_t = tl.argmax(-1).to(torch.int32)
    for t in range(4):
        pos = np.full((2,), 11 + t, np.int32)
        jl, jcache = _jax_decode(jcfg, jw, jcache, jnp.asarray(out_j),
                                 jnp.asarray(pos), policy=jpol)
        tl, tcache = ted.forward_decode(tcfg, tw, tcache, out_t,
                                        torch.from_numpy(pos), policy=tpol)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol)
        out_j = np.asarray(jl).argmax(-1).astype(np.int32)
        out_t = tl.argmax(-1).to(torch.int32)
        assert out_t.tolist() == out_j.tolist()
    _assert_cache_close(jcache, tcache, atol)


def _train_batch(tokens, rng, b=2, s=16, seed=3):
    batch = dict(next(jsyn.lm_batches(tokens, b, s, seed=seed)))
    batch["enc_embeddings"] = _emb(rng, b, s // 4)
    return batch


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


@pytest.mark.parametrize("remat", ["none", "full"])
def test_forward_train_grads_match_jax(setup, remat):
    """Loss (atol 1e-5) and the gradient of every leaf (rtol 1e-4, atol
    1e-6) against ``jax.value_and_grad``; the encoder's leaves take theirs
    through every decoder layer's cross K/V, and none is zero."""
    jcfg, tcfg, jp, _ = setup
    tokens = jsyn.token_stream(5_000, 320, seed=1)
    batch = _train_batch(tokens, np.random.RandomState(6))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jed.forward_train(jcfg, p, jb, remat=remat),
        has_aux=True))(jp)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                               trainable=True)
    loss, metrics = ted.forward_train(
        tcfg, params, {k: torch.from_numpy(v) for k, v in batch.items()},
        remat=remat)
    grads = torch.autograd.grad(loss, leaves(params.tree()))
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    assert int(metrics["tokens"]) == 32
    want = [np.asarray(x) for x in leaves(jax.tree.map(np.asarray, jgrads))]
    names = _paths(params.tree())
    assert len(grads) == len(want) == len(names)
    for name, a, b in zip(names, grads, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    for name in ("enc_blocks/attn/wq", "enc_blocks/mlp/w_down",
                 "enc_final_norm", "blocks/xattn/wk", "blocks/xattn/wv",
                 "blocks/xattn/wq", "blocks/xattn_norm", "embed", "unembed"):
        assert float(grads[names.index(name)].abs().max()) > 0, name


def test_three_train_steps_match_jax(setup):
    """Three ``make_train_step`` steps (AdamW lr 1e-3, remat full) on
    batches with frame embeddings: loss and grad norm at rtol 1e-5, the
    weights at atol 1e-5 (a few ulp of lr)."""
    jcfg, tcfg, jp, _ = setup
    jstep = jax.jit(jmake_train_step(jcfg, remat="full",
                                     opt=jopt.AdamWConfig(lr=1e-3)))
    tstep = make_train_step(tcfg, remat="full",
                            opt=topt.AdamWConfig(lr=1e-3))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                               trainable=True)
    js, ts, jparams_ = jopt.adamw_init(jp), topt.adamw_init(params), jp
    tokens = jsyn.token_stream(5_000, 320, seed=2)
    rng = np.random.RandomState(7)
    for i in range(3):
        batch = _train_batch(tokens, rng, seed=10 + i)
        jparams_, js, jm = jstep(jparams_, js, {k: jnp.asarray(v)
                                                for k, v in batch.items()})
        params, ts, tm = tstep(params, ts, batch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5)
    for a, b in zip(leaves(params.tree()),
                    leaves(jax.tree.map(np.asarray, jparams_))):
        np.testing.assert_allclose(a.detach().numpy(), b, atol=1e-5)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------
def test_block_table_refused(setup):
    """The enc-dec caches are not paged, as in the reference."""
    _, tcfg, _, tp = setup
    cache = ted.init_chunk_cache(tcfg, tp, torch.zeros(1, 2, 64), 8)
    table = torch.zeros((1, 1), dtype=torch.int32)
    one = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="not paged"):
        ted.forward_decode(tcfg, tp, cache, one, one, block_table=table)
    with pytest.raises(NotImplementedError, match="not paged"):
        ted.forward_prefill_chunk(tcfg, tp, cache, one[None], one[None],
                                  kv_len=one + 1, block_table=table)
    assert tapi.model_fns(tcfg) == (ted.forward_train, ted.forward_prefill,
                                    ted.forward_decode,
                                    ted.forward_prefill_chunk)


def test_engines_and_launchers_refuse(setup, monkeypatch, tmp_path):
    """The three engines refuse an enc-dec config, as the JAX
    ``_check_supported``; so does ``launch.serve`` through them, and
    ``launch.train``, whose token stream has no frame embeddings."""
    _, tcfg, _, tp = setup
    kw = dict(max_prompt=8, max_new_tokens=2, prefill_chunk=4, device="cpu")
    for make in (lambda: ContinuousBatchServer(tcfg, tp, slots=1, **kw),
                 lambda: StaticBatchServer(tcfg, tp, batch_size=1, **kw),
                 lambda: PagedBatchServer(tcfg, tp, slots=1, **kw)):
        with pytest.raises(NotImplementedError, match="enc-dec"):
            make()
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", ARCH, "--device", "cpu", "--requests", "1"])
    with pytest.raises(NotImplementedError, match="enc-dec"):
        tlaunch.main()
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", ARCH, "--device", "cpu", "--steps", "1",
        "--ckpt-dir", str(tmp_path / "ck")])
    with pytest.raises(NotImplementedError, match="frame embeddings"):
        tlaunch_train.main()
