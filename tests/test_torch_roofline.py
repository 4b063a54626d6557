"""The port's roofline against ``repro.roofline``.

* ``RooflineReport.finalize`` with a chip model of the reference's V5E
  figures gives the reference's row (exact: the same float arithmetic);
  ``model_flops``, ``attention_score_traffic`` and ``fused_adjustment``
  equal the reference's for every config x shape (exact).
* ``StepCounter`` counts each kernel operator with its kernel's work (a
  masked tile is not counted) on every device.  On the CPU route (the
  kernels' plain versions, op by op) its FLOPs plus the plain
  attention's work on the masked pairs, which the test reckons from the
  attention calls the counter saw (4·B·Hq·D·(S² - kept pairs) a forward
  call, 2.5 times that a backward call), equal ``repro.roofline.
  collect.analyze_module`` of the reference's compiled step on one CPU
  device, the internlm2 smoke config in float32, for prefill and
  decode.  The train step (remat "full") counts one S x S product a
  layer more than XLA: eager PyTorch runs the recomputed forward whole,
  P·V included, which the backward does not read and XLA drops as dead
  code.  The test reckons it: 2·B·Hq·D·S² a layer.
* The ``meta`` route (the dry run) counts what the CPU route counts,
  exactly.
"""
import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.arch import SHAPES as JSHAPES
from repro.core.arch import ShapeConfig as JShape
from repro.models import api as japi
from repro.models.params import abstract_params as jabstract
from repro.models.params import init_params as jinit
from repro.roofline import hw as jhw
from repro.roofline import model as jmodel
from repro.roofline.collect import analyze_module
from repro.serve.serve_step import make_decode_step as jdecode_step
from repro.serve.serve_step import make_prefill_step as jprefill_step
from repro.train.optimizer import abstract_opt_state as jabstract_opt
from repro.train.train_step import make_train_step as jtrain_step
from repro_torch import configs as tconfigs
from repro_torch.core.arch import SHAPES, ShapeConfig
from repro_torch.core.tree import leaves
from repro_torch.launch import dryrun
from repro_torch.models import api
from repro_torch.models.params import abstract_params, params_from_numpy
from repro_torch.roofline import hw, model
from repro_torch.roofline.collect import (StepCounter, attention_pairs,
                                          kernel_flops)
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import AdamWConfig, adamw_init

torch.set_num_threads(1)

# the reference's V5E figures in the port's chip model (the fields that
# ``roofline/model.py`` reads)
V5E = hw.ChipModel(**{f.name: getattr(jhw.V5E, f.name)
                      for f in dataclasses.fields(hw.ChipModel)})
ARCH = "internlm2-1.8b"
B, S = 2, 64


def _reports(seed):
    rng = np.random.default_rng(seed)
    kw = dict(arch="x", shape="train_4k", mesh="16x16", n_chips=256,
              hlo_flops=float(rng.uniform(1e11, 1e15)),
              hlo_bytes=float(rng.uniform(1e9, 1e13)),
              hlo_bytes_min=float(rng.uniform(1e8, 1e12)),
              collective_bytes=float(rng.uniform(0, 1e11)),
              collective_detail={},
              per_device_hbm=float(rng.uniform(1e9, 4e10)),
              model_flops=float(rng.uniform(1e13, 1e17)))
    return jmodel.RooflineReport(**kw), model.RooflineReport(**kw)


@pytest.mark.parametrize("seed", range(4))
def test_finalize_with_the_v5e_figures_gives_the_reference_row(seed):
    want, got = _reports(seed)
    assert got.finalize(V5E).row() == want.finalize(jhw.V5E).row()
    assert got.useful_flops_ratio == want.useful_flops_ratio


def test_the_h100_model():
    """The port holds no TPU constant; ``finalize`` defaults to H100."""
    assert hw.H100.peak_flops_bf16 == 989e12
    assert hw.H100.hbm_bandwidth == 3.35e12
    assert hw.H100_INT8.peak_flops_bf16 == 1979e12
    assert hw.H100.name == "h100" and hw.H100.ici_bandwidth == 450e9
    assert not any("v5e" in str(v).lower() or "tpu" in str(v).lower()
                   for v in dataclasses.asdict(hw.H100).values())
    _, rep = _reports(0)
    rep.finalize()
    assert rep.t_compute == rep.hlo_flops / 989e12
    assert rep.fits_hbm == (rep.per_device_hbm <= hw.H100.hbm_bytes)


def test_model_flops_traffic_and_fused_equal_the_reference():
    for arch in tconfigs.ALIASES:
        cfg, jcfg = tconfigs.get(arch), jconfigs.get(arch)
        for name in SHAPES:
            shape, jshape = SHAPES[name], JSHAPES[name]
            assert model.model_flops(cfg, shape) == \
                jmodel.model_flops(jcfg, jshape), (arch, name)
            for n_chips in (1, 256):
                assert model.attention_score_traffic(cfg, shape, n_chips) \
                    == jmodel.attention_score_traffic(jcfg, jshape,
                                                      n_chips)
            want, got = _reports(hash((arch, name)) % 1000)
            want.model_flops = got.model_flops = \
                jmodel.model_flops(jcfg, jshape)
            want.finalize(jhw.V5E)
            got.finalize(V5E)
            assert model.fused_adjustment(cfg, shape, got, V5E) == \
                jmodel.fused_adjustment(jcfg, jshape, want, jhw.V5E)


def test_fused_credit_capped_by_the_counted_traffic(monkeypatch):
    """The dry run credits only score traffic its trace counted: none on
    the kernel route, so its fused fields equal the unfused ones where
    the reference's analytic credit would not be 0."""
    shape = ShapeConfig("prefill_32k", S, B, "prefill")
    monkeypatch.setattr(dryrun, "configs",
                        SimpleNamespace(get=tconfigs.get_smoke))
    monkeypatch.setattr(dryrun, "SHAPES", {"prefill_32k": shape})
    row = dryrun.run_cell(ARCH, "prefill_32k")["roofline"]
    assert model.attention_score_traffic(tconfigs.get_smoke(ARCH), shape,
                                         1) > 0
    assert row["score_traffic_credit_bytes"] == 0.0
    assert row["t_memory_min_fused_s"] == row["t_memory_min_s"]
    assert row["roofline_fraction_fused"] == row["roofline_fraction"]


def _configs():
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype="float32")
    return jcfg, tcfg


def _reference_flops(jcfg, kind):
    shape = JShape("smoke", S, B, kind)
    if kind == "train":
        ap = jabstract(jcfg)
        low = jax.jit(jtrain_step(jcfg, n_microbatch=1, remat="full")).lower(
            ap, jabstract_opt(ap), japi.input_specs(jcfg, shape))
    elif kind == "prefill":
        low = jax.jit(jprefill_step(jcfg)).lower(
            jabstract(jcfg), japi.input_specs(jcfg, shape))
    else:
        sp = japi.input_specs(jcfg, shape)
        low = jax.jit(jdecode_step(jcfg)).lower(
            jabstract(jcfg), sp["cache"], sp["token"], sp["position"])
    return analyze_module(low.compile().as_text()).flops


def _count(tcfg, params, kind, counter):
    """Run the smoke step of ``kind`` on ``params``' device under
    ``counter``; the batch from a seeded generator there."""
    dev = leaves(params.tree())[0].device
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev.type).manual_seed(0)
    if kind == "train":
        batch = api.train_input_specs(
            tcfg, ShapeConfig("smoke", S, B, "train")) \
            if dev.type == "meta" else \
            api.synthetic_inputs(tcfg, B, S, gen, train=True, device=dev)
        opt = adamw_init(params)
        plist = leaves(params.tree())
        with counter:
            _, grads = ts.loss_and_grads(tcfg, params, plist, batch, "full")
            ts.apply_grads(params, opt, grads, AdamWConfig())
        return
    shape = ShapeConfig("smoke", S, B, "prefill")
    batch = api.prefill_input_specs(tcfg, shape) if dev.type == "meta" \
        else api.synthetic_inputs(tcfg, B, S, gen, train=False, device=dev)
    if kind == "prefill":
        with counter:
            make_prefill_step(tcfg)(params, batch)
        return
    _, _, cache = make_prefill_step(tcfg)(params, batch)
    tok = torch.zeros(B, dtype=torch.int32, device=dev)
    pos = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
    with counter:
        make_decode_step(tcfg)(params, cache, tok, pos)


def _cpu_params(jcfg, train):
    return params_from_numpy(jax.tree.map(np.asarray,
                                          jinit(jcfg, jax.random.key(0))),
                             device="cpu", trainable=train)


def _masked_attention_flops(tcfg, counter):
    """The plain attention's work on the pairs the causal mask drops, for
    the attention calls ``counter`` saw: the kernels skip it, the plain
    attention (and the reference's compiled step) does it."""
    hq, d = tcfg.n_heads, tcfg.resolved_head_dim
    skipped = 4 * B * hq * d * (S * S - attention_pairs(S, True, 0))
    calls = counter.launches.get("flash_attention", 0) \
        + 2.5 * counter.launches.get("flash_attention_bwd", 0)
    return skipped * calls


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_cpu_route_flops_against_the_reference_hlo(kind):
    jcfg, tcfg = _configs()
    want = _reference_flops(jcfg, kind)
    counter = StepCounter()
    _count(tcfg, _cpu_params(jcfg, kind == "train"), kind, counter)
    extra = 0
    if kind == "train":
        # the recomputed forward's P·V, which XLA drops (module docstring)
        extra = 2 * B * tcfg.n_heads * tcfg.resolved_head_dim * S * S \
            * tcfg.n_layers
    assert counter.launches["flash_attention"] == (
        0 if kind == "decode" else tcfg.n_layers * (
            2 if kind == "train" else 1))
    assert counter.costs.flops + _masked_attention_flops(tcfg, counter) \
        == want + extra
    assert counter.costs.bytes_min <= counter.costs.bytes_accessed


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_meta_route_skips_exactly_the_masked_attention(kind):
    """The meta trace counts the CPU run's FLOPs exactly, and so falls
    short of the reference's compiled step by the masked attention work
    (and, for train, the recomputed P·V that XLA drops)."""
    jcfg, tcfg = _configs()
    cpu = StepCounter()
    _count(tcfg, _cpu_params(jcfg, kind == "train"), kind, cpu)
    meta = StepCounter()
    _count(tcfg, abstract_params(tcfg, trainable=kind == "train"), kind,
           meta)
    assert meta.costs.flops == cpu.costs.flops
    assert dict(meta.launches) == dict(cpu.launches)
    assert meta.launches["flash_attention"] == tcfg.n_layers * (
        2 if kind == "train" else 1)
    extra = 2 * B * tcfg.n_heads * tcfg.resolved_head_dim * S * S \
        * tcfg.n_layers if kind == "train" else 0
    assert _reference_flops(jcfg, kind) + extra - meta.costs.flops == \
        _masked_attention_flops(tcfg, meta)
    # the kernel's own count of one forward call
    hq, d = tcfg.n_heads, tcfg.resolved_head_dim
    q = torch.empty(B, S, hq, d, device="meta")
    k = torch.empty(B, S, tcfg.n_kv_heads, d, device="meta")
    assert kernel_flops("flash_attention", (q, k, k, None, None, True, 0)) \
        == 4 * d * B * hq * S * (S + 1) // 2
