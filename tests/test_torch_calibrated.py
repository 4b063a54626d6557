"""Port parity: calibrated int8 activations against the JAX package.

``quant_dynamic`` against a calibrated amax, ``quant_matmul`` with
``PrecisionPolicy(activations="calibrated")`` (the native path's plain
version and fake_quant), ``AmaxObserver``/``calibrate_amax``, the
per-tensor activation helpers, ``attach_act_amax`` on stacked (L, ...)
leaves, the amax through every ``ParamTree`` path that holds a
``QTensor``, and the calibrated serving engines token-exact against the
JAX engines on the float32 smoke config with the same amax.  Quantized
values and scales are bitwise: one correctly rounded f32 division on
both sides and half-to-even rounding.

The JAX engines re-wrap an already quantized stacked ``QTensor``'s
(L, N) scale when they are handed one (``quantize_model_params`` maps over
the tuple's fields; see ROADMAP.md queue 3), so the JAX side here is built
from float weights and gets its amax attached to the engine's own
quantized tree; the port takes the quantized tree at construction.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import quantize as jq
from repro.kernels import ops as jops
from repro.models.params import init_params as jinit
from repro.serve import server as jserver
from repro_torch import configs as tconfigs
from repro_torch.core import quantize as tq
from repro_torch.kernels import ops as tops
from repro_torch.models.params import ParamTree, params_from_numpy
from repro_torch.serve import server as tserver

torch.set_num_threads(1)

ARCH = "internlm2-1.8b"
AMAX = {"wq": 4.0, "wk": 4.0, "wv": 4.0, "wo": 4.0, "w_gate": 4.0,
        "w_up": 4.0, "w_down": 8.0}
J_CAL = dataclasses.replace(jq.INT8, activations="calibrated")
T_CAL = dataclasses.replace(tq.INT8, activations="calibrated")


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype="float32")
    jp = jinit(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("amax", [None, 2.5, "rows"])
def test_quant_dynamic_with_amax_bitwise(amax):
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 32) * 3).astype(np.float32)
    if amax == "rows":
        amax = rng.uniform(0.5, 6.0, (3, 5)).astype(np.float32)
    jqv, js = jq.quant_dynamic(jnp.asarray(x), amax)
    tqv, ts = tq.quant_dynamic(torch.from_numpy(x),
                               None if amax is None else torch.as_tensor(amax))
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts.is_contiguous() and ts.shape == (3, 5)


@pytest.mark.parametrize("compute", ["native", "fake_quant"])
def test_quant_matmul_calibrated_matches_jax(compute):
    """A stacked weight with a per-layer amax, layer 1's slice: the
    calibrated result equals JAX's (plain int8 path on the CPU, bitwise;
    fake_quant within f32 rounding) and differs from the dynamic one; a
    QTensor without amax stays dynamic under the calibrated policy."""
    rng = np.random.RandomState(1)
    w = rng.randn(2, 48, 40).astype(np.float32)
    x = (rng.randn(2, 7, 48) * 2).astype(np.float32)
    jw = jq.attach_act_amax({"mlp": {"w_up": jq._leaf_qtensor(
        jnp.asarray(w))}}, {"w_up": np.asarray([1.5, 3.0], np.float32)})
    tw = tq.attach_act_amax({"mlp": {"w_up": tq._leaf_qtensor(
        torch.from_numpy(w))}}, {"w_up": np.asarray([1.5, 3.0],
                                                    np.float32)})
    jl = jax.tree.map(lambda a: a[1], jw["mlp"]["w_up"])
    tl = tq.QTensor(*(t[1] for t in tw["mlp"]["w_up"]))
    jpol = dataclasses.replace(J_CAL, compute=compute)
    tpol = dataclasses.replace(T_CAL, compute=compute)
    want = np.asarray(jops.quant_matmul(jnp.asarray(x), jl, policy=jpol))
    got = tops.quant_matmul(torch.from_numpy(x), tl, policy=tpol).numpy()
    if compute == "native":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    dynamic = tops.quant_matmul(torch.from_numpy(x), tl,
                                policy=dataclasses.replace(tpol,
                                                           activations=
                                                           "dynamic"))
    assert not torch.equal(dynamic, torch.from_numpy(got))
    no_amax = tops.quant_matmul(torch.from_numpy(x), tl._replace(amax=None),
                                policy=tpol)
    torch.testing.assert_close(no_amax, dynamic, rtol=0, atol=0)


def test_amax_observer_running_max_and_ema():
    for momentum in (None, 0.5, 0.9):
        jo, to = jq.AmaxObserver(momentum), tq.AmaxObserver(momentum)
        rng = np.random.RandomState(2)
        for _ in range(5):
            x = (rng.randn(4, 9) * rng.uniform(0.1, 5)).astype(np.float32)
            assert to.update(torch.from_numpy(x)) == \
                jo.update(jnp.asarray(x))
        batches = [rng.randn(3, 3).astype(np.float32) for _ in range(4)]
        assert tq.calibrate_amax([torch.from_numpy(b) for b in batches],
                                 momentum) == \
            jq.calibrate_amax([jnp.asarray(b) for b in batches], momentum)
    obs = tq.AmaxObserver()
    obs.update(torch.tensor([1.0, -3.0]))
    obs.update(torch.tensor([2.0]))
    assert obs.amax == 3.0
    with pytest.raises(ValueError, match="no calibration batches"):
        tq.calibrate_amax([])


def test_activation_helpers_match_jax():
    rng = np.random.RandomState(3)
    x = (rng.randn(6, 17) * 2 + 0.7).astype(np.float32)
    jc = jq.calibrate_activation(jnp.asarray(x))
    tc = tq.calibrate_activation(torch.from_numpy(x))
    assert tc == jc
    jqa = jq.quant_activation(jnp.asarray(x), jc)
    tqa = tq.quant_activation(torch.from_numpy(x), tc)
    np.testing.assert_array_equal(tqa.numpy(), np.asarray(jqa))
    np.testing.assert_array_equal(
        tq.dequant_activation(tqa, tc).numpy(),
        np.asarray(jq.dequant_activation(jqa, jc)))


def test_attach_act_amax_per_layer_and_by_scope(setup):
    """Stacked (L, K, N) leaves get an (L,) amax, by leaf name or by the
    scope; unmatched sites stay None; a dict keeps its QTensors' values."""
    jcfg, tcfg, jp, tp = setup
    L = tcfg.n_layers
    tqp = tq.quantize_model_params(tp, tq.INT8)
    jqp = jq.quantize_model_params(jp, jq.INT8)
    for spec in ({"wq": 3.0, "w_down": 8.0}, {"attn": 2.0},
                 {"wq": np.arange(1, L + 1, dtype=np.float32)}):
        got = tq.attach_act_amax(tqp, spec)
        want = jq.attach_act_amax(jqp, spec)
        assert isinstance(got, ParamTree)
        for scope in ("attn", "mlp"):
            for name, qt in got["blocks"][scope].tree().items():
                ja = want["blocks"][scope][name].amax
                if ja is None:
                    assert qt.amax is None
                else:
                    assert qt.amax.shape == (L,)
                    np.testing.assert_array_equal(qt.amax.numpy(),
                                                  np.asarray(ja))
                    assert torch.equal(qt.q, tqp["blocks"][scope][name].q)
    w = torch.ones(8, 4)
    qd = {"attn": {"wq": tq._leaf_qtensor(w)}, "norm": torch.ones(4)}
    out = tq.attach_act_amax(qd, {"wq": 3.0})
    assert float(out["attn"]["wq"].amax) == 3.0
    assert out["attn"]["wq"].q is qd["attn"]["wq"].q
    assert out["norm"] is qd["norm"]


def test_amax_survives_every_param_tree_path(setup):
    """QLeaf, ``tree()``, ``__getitem__``, the per-layer views
    (``unstack``/``_slice``), ``.to`` and ``params_from_numpy`` of the
    JAX package's quantized tree with its amax attached."""
    jcfg, tcfg, jp, tp = setup
    L = tcfg.n_layers
    per_layer = np.arange(1, L + 1, dtype=np.float32)
    qp = tq.attach_act_amax(tq.quantize_model_params(tp, tq.INT8),
                            {"wk": per_layer})
    blocks = qp["blocks"]
    np.testing.assert_array_equal(blocks["attn"]["wk"].amax.numpy(),
                                  per_layer)
    assert blocks.tree()["attn"]["wk"].amax.shape == (L,)
    for i, layer in enumerate(blocks.unstack()):
        assert float(layer["attn"]["wk"].amax) == per_layer[i]
        assert layer["attn"]["wq"].amax is None
    moved = qp.to("cpu", torch.float32)
    assert moved["blocks"]["attn"]["wk"].amax is not None
    again = tq.quantize_model_params(qp, T_CAL)
    np.testing.assert_array_equal(again["blocks"]["attn"]["wk"].amax.numpy(),
                                  per_layer)
    jqp = jq.attach_act_amax(jq.quantize_model_params(jp, jq.INT8),
                             {"wk": per_layer})
    carried = params_from_numpy(jax.tree.map(np.asarray, jqp), "cpu")
    wk = carried["blocks"]["attn"]["wk"]
    np.testing.assert_array_equal(wk.amax.numpy(), per_layer)
    np.testing.assert_array_equal(
        wk.q.numpy(), np.swapaxes(np.asarray(jqp["blocks"]["attn"]["wk"].q),
                                  -1, -2))
    assert carried["blocks"]["attn"]["wq"].amax is None


def _prompts(vocab):
    rng = np.random.RandomState(4)
    return ([rng.randint(0, vocab, n).astype(np.int32) for n in (3, 11, 7)],
            [5, 4, 6])


# name: (JAX engine, port engine, keyword arguments)
ENGINES = {
    "continuous": (jserver.ContinuousBatchServer,
                   tserver.ContinuousBatchServer,
                   dict(slots=2, max_prompt=16, prefill_chunk=4,
                        max_new_tokens=8)),
    "static": (jserver.StaticBatchServer, tserver.StaticBatchServer,
               dict(batch_size=2, max_prompt=16, prefill_chunk=4,
                    max_new_tokens=8)),
    "paged": (jserver.PagedBatchServer, tserver.PagedBatchServer,
              dict(slots=2, max_prompt=16, prefill_chunk=4, max_new_tokens=8,
                   block_size=8)),
}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_calibrated_engines_token_exact_vs_jax(setup, engine):
    """The same weights and amax: the port's calibrated engine (handed
    the quantized tree) gives the JAX engine's tokens, which differ from
    the dynamic int8 engine's."""
    jcfg, tcfg, jp, tp = setup
    jeng, teng, kw = ENGINES[engine]
    prompts, budgets = _prompts(tcfg.vocab_size)
    jsrv = jeng(jcfg, jp, precision=J_CAL, **kw)
    jsrv.params = jq.attach_act_amax(jsrv.params, AMAX)
    jreqs = jsrv.submit(prompts, max_new_tokens=budgets)
    jsrv.run()
    qp = tq.attach_act_amax(tq.quantize_model_params(tp, tq.INT8), AMAX)
    tsrv = teng(tcfg, qp, precision=T_CAL, device="cpu", **kw)
    assert tsrv.params["blocks"]["mlp"]["w_down"].amax is not None
    treqs = tsrv.submit(prompts, max_new_tokens=budgets)
    tsrv.run()
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    dyn = teng(tcfg, tp, precision="int8", device="cpu", **kw)
    dreqs = dyn.submit(prompts, max_new_tokens=budgets)
    dyn.run()
    assert [r.tokens for r in dreqs] != [r.tokens for r in treqs]


def test_calibrated_engine_on_float_weights_is_dynamic(setup):
    """Float weights under the calibrated policy are quantized with no
    amax: dynamic everywhere, the int8 engine's tokens."""
    _, tcfg, _, tp = setup
    prompts, budgets = _prompts(tcfg.vocab_size)
    kw = dict(slots=2, max_prompt=16, prefill_chunk=4, max_new_tokens=8,
              device="cpu")
    tokens = []
    for prec in (T_CAL, "int8"):
        srv = tserver.ContinuousBatchServer(tcfg, tp, precision=prec, **kw)
        reqs = srv.submit(prompts, max_new_tokens=budgets)
        srv.run()
        tokens.append([r.tokens for r in reqs])
    assert tokens[0] == tokens[1]
