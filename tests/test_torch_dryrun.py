"""The dry run and its abstract shapes against ``repro.launch.dryrun``,
``repro.models.api``, ``repro.serve.kvcache``, ``repro.core.tuner`` and
``repro.core.estimator``.

* The abstract params (float32 masters), inputs, caches (the prefill's
  cache traced on ``meta``) and optimizer state equal the reference's
  ``ShapeDtypeStruct``s for every full config x shape, leaf for leaf
  (shape and dtype exact); the slot and paged slot axes equal the
  reference's on the smoke configs.
* ``shape_applicable`` and ``default_n_micro`` agree with the reference.
* ``run_cell`` on a smoke config of each family (dense, MoE, hybrid,
  mamba, enc-dec, VLM) at small shapes gives the reference's keys (with
  ``t_trace_s`` for the compile times); its ``argument_bytes`` equal the
  abstract bytes, and its meta trace's counts (FLOPs, bytes, peak live
  bytes, kernel calls) equal a CPU run's of the same step under the
  same ``StepCounter``, exactly.
* ``PodConfigTuner``'s order with a stub evaluator, and
  ``pod_estimate_from_report`` (target named apart), equal the
  reference's; ``maybe_cast_params`` equals the reference's under
  ``bf16_params`` (dtypes exact, values bitwise); the plain attention
  under ``bf16_attn_p`` matches the reference's chunked attention with
  the flag set (bf16: within 2^-7 of the output's largest magnitude,
  about one bf16 rounding of each) and moves with the flag; its
  gradients (the operator's CPU backward) match ``jax.vjp`` of the
  reference's chunked attention with the flag set within 2^-6 of each
  gradient's largest magnitude (readings up to 0.0091: the two round P
  to bf16 at different points, the port after normalising, the
  reference against each chunk's running max, so they agree to the
  rounding of bf16 and no closer).
"""
import dataclasses
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import flags as jflags
from repro.core import estimator as jest
from repro.core import tuner as jtuner
from repro.core.arch import SHAPES as JSHAPES
from repro.core.arch import shape_applicable as jshape_applicable
from repro.core.quantize import INT8 as JINT8
from repro.launch import dryrun as jdryrun
from repro.models import api as japi
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.params import abstract_params as jabstract
from repro.models.params import init_params as jinit
from repro.serve import kvcache as jkv
from repro.serve.serve_step import make_decode_step as jdecode_step
from repro.serve.serve_step import make_prefill_step as jprefill_step
from repro.train.optimizer import abstract_opt_state as jabstract_opt
from repro_torch import configs as tconfigs
from repro_torch import flags as tflags
from repro_torch.core import estimator as test
from repro_torch.core import tuner as ttuner
from repro_torch.core.arch import SHAPES, ShapeConfig, shape_applicable
from repro_torch.core.quantize import INT8
from repro_torch.core.tree import leaves
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.models import api, transformer
from repro_torch.models.params import (abstract_params, init_params,
                                       params_from_numpy)
from repro_torch.roofline.collect import StepCounter
from repro_torch.serve import kvcache as tkv
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.optimizer import abstract_opt_state

torch.set_num_threads(1)


def _port_leaves(tree, path=()):
    """{path: (shape, dtype)} of a port tree: dict keys, NamedTuple
    fields, list indices."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_port_leaves(tree[k], path + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", range(len(tree)))
        out = {}
        for n, x in zip(names, tree):
            out.update(_port_leaves(x, path + (str(n),)))
        return out
    if hasattr(tree, "tree"):
        return _port_leaves(tree.tree(), path)
    return {path: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


def _jax_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(str(getattr(p, "key", getattr(p, "name",
                                                  getattr(p, "idx", p))))
                    for p in path)
        out[key] = (tuple(leaf.shape), str(leaf.dtype))
    return out


def _axis_leaves(tree, jax_tree=False):
    if jax_tree:
        return {tuple(str(getattr(p, "key", getattr(p, "name", p)))
                      for p in path): leaf
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    tree)[0]}
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], path + (str(k),))
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for n, x in zip(t._fields, t):
                walk(x, path + (n,))
        else:
            out[path] = t
    walk(tree, ())
    return out


def test_abstract_params_inputs_caches_and_opt_state():
    """Every full config x applicable shape, leaf for leaf."""
    n = 0
    for arch in tconfigs.ALIASES:
        cfg, jcfg = tconfigs.get(arch), jconfigs.get(arch)
        ap = abstract_params(cfg)
        assert _port_leaves(ap) == _jax_leaves(jabstract(jcfg)), arch
        assert _port_leaves(abstract_opt_state(ap)) == _jax_leaves(
            jabstract_opt(jabstract(jcfg))), arch
        for name in SHAPES:
            if not shape_applicable(cfg, SHAPES[name])[0]:
                continue
            got = _port_leaves(api.input_specs(cfg, SHAPES[name]))
            want = _jax_leaves(japi.input_specs(jcfg, JSHAPES[name]))
            assert got == want, (arch, name)
            assert api.input_logical_axes(cfg, SHAPES[name]) == \
                japi.input_logical_axes(jcfg, JSHAPES[name])
            n += 1
    assert n == 33


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma3-4b",
                                  "zamba2-2.7b", "falcon-mamba-7b"])
def test_slot_axes_equal_the_reference(arch):
    """``abstract_decode_cache``, ``slot_batch_axes`` and
    ``paged_slot_axes`` of the smoke config, float and int8."""
    cfg, jcfg = tconfigs.get_smoke(arch), jconfigs.get_smoke(arch)
    for tp, jp in ((None, None), (INT8, JINT8)):
        assert _port_leaves(tkv.abstract_decode_cache(cfg, 3, 64, tp)) == \
            _jax_leaves(jkv.abstract_decode_cache(jcfg, 3, 64, jp))
        assert _axis_leaves(tkv.slot_batch_axes(cfg, 3, 64, tp)) == \
            _axis_leaves(jkv.slot_batch_axes(jcfg, 3, 64, jp), True)
        assert _axis_leaves(tkv.paged_slot_axes(cfg, 3, 64, 12, tp, 16)) \
            == _axis_leaves(jkv.paged_slot_axes(jcfg, 3, 64, 12, jp, 16),
                            True)


def test_cache_shardings_equal_the_reference():
    """Each decode cache leaf's spec, the smoke configs' caches, on the
    one-device mesh (the reference's on a jax mesh of its one CPU
    device) and on the 16 x 16 shape-only mesh (the reference's rule
    applied through ``logical_to_pspec``: its ``NamedSharding`` needs the
    devices)."""
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    for arch in FAMILIES.values():
        if arch == "seamless-m4t-large-v2":
            continue          # the reference serves no enc-dec cache
        cfg, jcfg = tconfigs.get_smoke(arch), jconfigs.get_smoke(arch)
        cache = tkv.abstract_decode_cache(cfg, 4, 64)
        jcache = jkv.abstract_decode_cache(jcfg, 4, 64)
        for decode in (False, True):
            rules = dryrun.make_rules("tp", decode=decode)
            got = _axis_leaves(dryrun.cache_shardings(
                cfg, cache, Mesh({"data": 1, "model": 1}), rules))
            want = _axis_leaves(jdryrun.cache_shardings(
                jcfg, jcache, jmesh, rules), True)
            assert {k: tuple(v) for k, v in got.items()} == \
                {k: tuple(v.spec) for k, v in want.items()}, arch
            big = _axis_leaves(dryrun.cache_shardings(
                cfg, cache, Mesh({"data": 16, "model": 16}), rules))
            assert set(big) == set(got)


def test_shape_applicable_and_default_n_micro():
    meshes = [({"data": 1, "model": 1}, Mesh({"data": 1, "model": 1})),
              ({"data": 16, "model": 16}, Mesh({"data": 16, "model": 16}))]
    for arch in tconfigs.ALIASES:
        cfg, jcfg = tconfigs.get(arch), jconfigs.get(arch)
        for name in SHAPES:
            assert shape_applicable(cfg, SHAPES[name]) == \
                jshape_applicable(jcfg, JSHAPES[name])
            for jshape, mesh in meshes:
                assert dryrun.default_n_micro(cfg, SHAPES[name], mesh) == \
                    jdryrun.default_n_micro(jcfg, JSHAPES[name],
                                            SimpleNamespace(shape=jshape))
        assert dryrun.default_strategy(arch) == \
            jdryrun.default_strategy(arch)


def test_decode_step_equals_the_reference():
    """``make_decode_step`` after a one-shot prefill, internlm2 smoke in
    float32: next tokens exact, logits within 1e-5."""
    jcfg = dataclasses.replace(jconfigs.get_smoke("internlm2-1.8b"),
                               dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke("internlm2-1.8b"),
                               dtype="float32")
    jp = jinit(jcfg, jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 12),
                                             dtype=np.int32)
    _, _, jcache = jprefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    _, _, cache = make_prefill_step(tcfg)(params,
                                          {"tokens": torch.from_numpy(toks)})
    tok = np.array([3, 7], np.int32)
    pos = np.array([11, 11], np.int32)
    jnext, jlogits, _ = jdecode_step(jcfg)(jp, jcache, jnp.asarray(tok),
                                           jnp.asarray(pos))
    nxt, logits, _ = make_decode_step(tcfg)(
        params, cache, torch.from_numpy(tok), torch.from_numpy(pos))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=0)
    assert nxt.tolist() == np.asarray(jnext).tolist()


SMALL_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 64, 4, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 64, 2, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 64, 2, "decode"),
    "long_500k": ShapeConfig("long_500k", 128, 1, "decode"),
}
FAMILIES = {"dense": "internlm2-1.8b", "moe": "phi3.5-moe-42b-a6.6b",
            "hybrid": "zamba2-2.7b", "mamba": "falcon-mamba-7b",
            "encdec": "seamless-m4t-large-v2", "vlm": "qwen2-vl-72b"}


@pytest.fixture
def smoke_cells(monkeypatch):
    """``run_cell`` on the smoke configs at ``SMALL_SHAPES``."""
    monkeypatch.setattr(dryrun, "configs",
                        SimpleNamespace(get=tconfigs.get_smoke,
                                        ALIASES=tconfigs.ALIASES))
    monkeypatch.setattr(dryrun, "SHAPES", SMALL_SHAPES)


def _reference_row_keys():
    """The reference's row keys: its ``run_cell``'s (read off its code:
    it needs a pod of devices to run) and its roofline row's."""
    rep = jdryrun.RooflineReport(
        arch="a", shape="s", mesh="m", n_chips=1, hlo_flops=1.0,
        hlo_bytes=1.0, collective_bytes=0.0, collective_detail={},
        per_device_hbm=1.0).finalize()
    cfg = jconfigs.get("internlm2-1.8b")
    roofline = set(rep.row()) | set(jdryrun.fused_adjustment(
        cfg, JSHAPES["train_4k"], rep))
    top = {"arch", "shape", "mesh", "strategy", "n_micro", "remat",
           "n_chips", "params", "flags", "status", "t_lower_s",
           "t_compile_s", "memory", "cost", "collectives", "roofline",
           "model_flops"}
    memory = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
              "per_device_hbm_bytes", "per_device_hbm_gib"}
    return top, memory, roofline


def _cpu_inputs(cfg, shape, kind):
    gen = torch.Generator().manual_seed(1)
    b, s = shape.global_batch, shape.seq_len
    if kind == "train":
        params = init_params(cfg, gen, "cpu", trainable=True)
        return params, api.synthetic_inputs(cfg, b, s, gen, device="cpu")
    params = init_params(cfg, gen, "cpu", dtype=torch.float32)
    batch = api.synthetic_inputs(cfg, b, s, gen, train=False, device="cpu")
    if kind == "prefill":
        return params, batch
    _, _, cache = make_prefill_step(cfg)(params, batch)
    return params, {"cache": cache,
                    "token": torch.zeros(b, dtype=torch.int32),
                    "position": torch.full((b,), s - 1, dtype=torch.int32)}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_run_cell_on_each_family(smoke_cells, family):
    arch = FAMILIES[family]
    cfg = tconfigs.get_smoke(arch)
    top, memory, roofline = _reference_row_keys()
    shapes = ["train_4k", "prefill_32k", "decode_32k"] + (
        ["long_500k"] if family in ("hybrid", "mamba") else [])
    for name in shapes:
        row = dryrun.run_cell(arch, name)
        assert row["status"] == "ok", (name, row)
        assert set(row) == top - {"t_lower_s", "t_compile_s"} | {"t_trace_s"}
        assert set(row["memory"]) == memory
        assert set(row["roofline"]) == roofline | {"score_traffic_note"}
        assert row["roofline"]["score_traffic_credit_bytes"] == 0.0
        shape = SMALL_SHAPES[name]
        ap = abstract_params(cfg)
        want = 4 * sum(t.numel() for t in leaves(ap.tree()))
        if shape.kind == "train":
            want *= 3                                   # params, m, v
            want += 4 + sum(t.numel() * t.element_size() for t in
                            api.train_input_specs(cfg, shape).values())
            assert row["n_micro"] == 2
        else:
            specs = api.input_specs(cfg, shape)
            want += sum(t.numel() * t.element_size()
                        for t in leaves(specs))
        assert row["memory"]["argument_bytes"] == want, name
        m = row["memory"]
        assert m["per_device_hbm_bytes"] == m["argument_bytes"] + \
            m["temp_bytes"] + m["output_bytes"] - m["alias_bytes"]
        if shape.kind != "prefill":
            assert m["alias_bytes"] > 0
        # the meta trace counts what a CPU run of the same step counts
        meta, cpu = StepCounter(), StepCounter()
        dryrun.trace_step(cfg, shape, meta, n_micro=row["n_micro"])
        params, inputs = _cpu_inputs(cfg, shape, shape.kind)
        dryrun.trace_step(cfg, shape, cpu, n_micro=row["n_micro"],
                          params=params, inputs=inputs)
        assert meta.costs.flops == cpu.costs.flops == \
            row["cost"]["flops_per_device"], name
        assert meta.costs.bytes_accessed == cpu.costs.bytes_accessed
        assert meta.costs.bytes_min == cpu.costs.bytes_min
        assert meta.peak_bytes == cpu.peak_bytes
        assert dict(meta.launches) == dict(cpu.launches) == \
            row["cost"]["kernel_calls"]
    if family not in ("hybrid", "mamba"):
        assert dryrun.run_cell(arch, "long_500k")["status"] == "skipped"


def test_dryrun_command_line(smoke_cells, tmp_path, capsys):
    dryrun.main(["--arch", "internlm2-1.8b", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    row = json.loads((tmp_path / "internlm2-1.8b_decode_32k_single.json")
                     .read_text())
    assert row["status"] == "ok" and row["mesh"] == "1x1"
    dryrun.main(["--arch", "internlm2-1.8b", "--shape", "decode_32k",
                 "--out", str(tmp_path), "--resume"])
    assert "[resume]" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="512 devices"):
        dryrun.main(["--mesh", "multi", "--out", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="256 devices"):
        dryrun.run_cell("internlm2-1.8b", "decode_32k",
                        mesh=Mesh({"data": 16, "model": 16}))


def _stub(arch, shape, **kw):
    """A deterministic evaluator: a fraction and a memory size from the
    candidate's knobs (one of them too large for either card)."""
    rank = {"tp": 0.3, "tp_sp": 0.2, "cp": 0.1}[kw["strategy"]]
    micro = kw["n_micro"] or 1
    frac = rank + 0.01 * micro + (0.05 if kw["remat"] == "dots" else 0.0)
    gib = 500.0 if micro == 32 and kw["strategy"] == "cp" else 10.0 + micro
    return {"status": "ok", "n_micro": micro,
            "memory": {"per_device_hbm_gib": gib},
            "roofline": {"roofline_fraction": round(frac, 4)}}


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_pod_tuner_order_equals_the_reference(shape):
    for seed in range(3):
        for n in (4, 6, 24):
            ours = ttuner.PodConfigTuner(_stub, arch="a", shape=shape,
                                         hbm_gib=16.0,
                                         seed=seed).search(n_samples=n)
            theirs = jtuner.PodConfigTuner(_stub, arch="a", shape=shape,
                                           seed=seed).search(n_samples=n)
            assert [c.key() for c in ours] == [c.key() for c in theirs]
    # the card's memory by default: the rows of 18 to 42 GiB now fit
    ours = ttuner.PodConfigTuner(_stub, arch="a", shape=shape)
    assert ours.hbm_gib == pytest.approx(79.18, abs=0.01)
    assert all(c.report["memory"]["per_device_hbm_gib"] <= ours.hbm_gib
               for c in ours.search(n_samples=24))


def test_pod_estimate_equals_the_reference():
    row = {"mesh": "1x1", "t_compute_s": 0.5, "t_memory_s": 2.0,
           "t_memory_min_s": 0.8, "t_collective_s": 0.3, "hbm_gib": 12.0,
           "fits_hbm": True}
    got = test.pod_estimate_from_report(row)
    want = jest.pod_estimate_from_report(row)
    assert got.target == "h100-1x1" and want.target == "tpu-v5e-pod-1x1"
    assert dataclasses.asdict(dataclasses.replace(got, target=want.target)) \
        == dataclasses.asdict(want)
    del row["t_memory_min_s"]
    assert test.pod_estimate_from_report(row).nn_latency_ms == \
        jest.pod_estimate_from_report(row).nn_latency_ms


def test_maybe_cast_params_equals_the_reference():
    jcfg = jconfigs.get_smoke("falcon-mamba-7b")
    tcfg = tconfigs.get_smoke("falcon-mamba-7b")
    jp = jinit(jcfg, jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                               trainable=True)
    assert transformer.maybe_cast_params(params, tcfg) is params
    try:
        jflags.set_flags(bf16_params=True)
        tflags.set_flags(bf16_params=True)
        want = jtransformer.maybe_cast_params(jp, jcfg)
        got = transformer.maybe_cast_params(params, tcfg)
    finally:
        jflags.set_flags(bf16_params=False)
        tflags.set_flags(bf16_params=False)
    assert _port_leaves(got) == _jax_leaves(want)
    for (k, a), (_, b) in zip(sorted(_axis_leaves(dict(got)).items()),
                              sorted(_axis_leaves(want, True).items())):
        assert torch.equal(a.detach().float(),
                           torch.from_numpy(np.array(b, np.float32))), k
    # gradients reach the f32 masters
    leaf = got["blocks"]["mamba"]["in_proj"]
    assert leaf.dtype == torch.bfloat16 and leaf.requires_grad
    leaf.float().sum().backward()
    assert params["blocks"]["mamba"]["in_proj"].grad is not None
    with pytest.raises(KeyError):
        tflags.set_flags(kernel_path="ref")


def test_bf16_attn_p_matches_the_reference_chunked_attention():
    rng = np.random.default_rng(3)
    b, s, hq, hkv, d = 2, 256, 4, 2, 64
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for h in (hq, hkv, hkv))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    off = ref.flash_attention_ref(tq, tk, tv).float()
    try:
        jflags.set_flags(bf16_attn_p=True)
        tflags.set_flags(bf16_attn_p=True)
        want = np.array(jlayers.chunked_attention(
            jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos), chunk=64)
            .astype(jnp.float32))
        got = ref.flash_attention_ref(tq, tk, tv).float()
    finally:
        jflags.set_flags(bf16_attn_p=False)
        tflags.set_flags(bf16_attn_p=False)
    scale = float(np.abs(want).max())
    assert float((got - torch.from_numpy(want)).abs().max()) <= \
        2.0 ** -7 * scale
    assert not torch.equal(got, off)


def test_bf16_attn_p_gradients_match_the_reference_chunked_attention():
    rng = np.random.default_rng(4)
    b, s, hq, hkv, d = 2, 256, 4, 2, 64
    q, k, v, do = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                   for h in (hq, hkv, hkv, hq))
    pos = jnp.asarray(np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
                  for x in (q, k, v))
    tdo = torch.from_numpy(do).to(torch.bfloat16)
    jargs = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]

    def chunked(q, k, v):
        return jlayers.chunked_attention(q, k, v, pos, pos, chunk=64)

    off = torch.autograd.grad(ops.flash_attention(tq, tk, tv), (tq, tk, tv),
                              tdo)
    try:
        jflags.set_flags(bf16_attn_p=True)
        tflags.set_flags(bf16_attn_p=True)
        _, vjp = jax.vjp(chunked, *jargs)
        want = [np.array(g.astype(jnp.float32))
                for g in vjp(jnp.asarray(do, jnp.bfloat16))]
        got = torch.autograd.grad(ops.flash_attention(tq, tk, tv),
                                  (tq, tk, tv), tdo)
    finally:
        jflags.set_flags(bf16_attn_p=False)
        tflags.set_flags(bf16_attn_p=False)
    for name, g, w in zip("qkv", got, want):
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= 2.0 ** -6 * float(np.abs(w).max()), name
    assert not torch.equal(got[2], off[2])
