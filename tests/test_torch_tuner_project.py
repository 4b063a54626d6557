"""Port parity: the EON tuner, the Project API and the registry against
the JAX package, on the CPU.

- ``EONTuner``: the same seed samples the same candidates (DSP and model
  kinds and hyperparameters), the screen keeps the same survivors under
  the constraints of ``tests/test_core.py::
  test_eon_tuner_screen_respects_constraints`` with the same estimates,
  and the two tuners draw the same build seeds; ``evaluate`` trains the
  survivors and ranks them by accuracy.
- ``Project``: the workflow of ``tests/test_project_api.py`` on the CPU
  with its thresholds, tuning included, the log persisted; the dataset's
  version id equals the JAX ``Project``'s for the same samples, and the
  int8 deployment reloaded from its file gives the artifact's logits.
- ``registry``: the rows of ``describe()`` for the ported architectures
  equal the JAX package's; every other one names the slice that brings it.
"""
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import registry as jreg
from repro.core.project import Project as JProject
from repro.core.tuner import EONTuner as JTuner
from repro_torch import configs as tconfigs
from repro_torch.core import registry as treg
from repro_torch.core.eon_compiler import CompiledArtifact
from repro_torch.core.project import Project
from repro_torch.core.tuner import DEFAULT_KWS_SPACE, EONTuner
from repro_torch.data.synthetic import keyword_audio

torch.set_num_threads(1)

N_SAMPLES = 4000
# test_core.py's limits, and tighter ones that cut some candidates
LIMITS = {"test_core": dict(max_ram_kb=64, max_flash_kb=256),
          "tight": dict(max_ram_kb=5, max_flash_kb=40)}


def _key(c):
    return (c.dsp_kind, c.dsp_hp, c.model_kind, c.model_hp)


@pytest.mark.parametrize("seed,limits", [(0, "test_core"), (3, "tight")])
def test_tuner_samples_and_screens_as_jax(seed, limits):
    lim = LIMITS[limits]
    jt = JTuner(input_samples=N_SAMPLES, n_classes=3, seed=seed,
                target="nano33ble", **lim)
    tt = EONTuner(input_samples=N_SAMPLES, n_classes=3, seed=seed,
                  target="nano33ble", device="cpu", **lim)
    jc, tc = jt.sample(8), tt.sample(8)
    assert [_key(c) for c in tc] == [_key(c) for c in jc]
    js, ts = jt.screen(jc), tt.screen(tc)
    assert [_key(c) for c in ts] == [_key(c) for c in js]
    assert ts and (limits == "test_core" or len(ts) < len(tc))
    for a, b in zip(tc, jc):
        for field in ("ram_kb", "flash_kb", "dsp_latency_ms",
                      "nn_latency_ms"):
            assert getattr(a.estimate, field) == pytest.approx(
                getattr(b.estimate, field), rel=1e-12), field
        assert a.estimate.fits == b.estimate.fits
    for c in ts:
        assert c.estimate.ram_kb <= lim["max_ram_kb"]
        assert c.estimate.flash_kb <= lim["max_flash_kb"]
    # the builds drew the same seeds: the generators are in step
    assert tt.rng.getstate() == jt.rng.getstate()
    assert tt.space is DEFAULT_KWS_SPACE


def test_tuner_evaluate_ranks_by_accuracy():
    samples = keyword_audio(n_per_class=6, n_classes=3, n_samples=N_SAMPLES,
                            seed=4)
    xs = np.stack([s.data for s in samples])
    ys = np.asarray([s.label for s in samples], np.int32)
    tt = EONTuner(input_samples=N_SAMPLES, n_classes=3, seed=1,
                  device="cpu")
    cands = tt.sample(3)
    ranked = tt.evaluate(cands, (xs, ys), (xs, ys), epochs=1, batch_size=8)
    assert sorted(map(id, ranked)) == sorted(map(id, cands))
    accs = [c.accuracy for c in ranked]
    assert all(c.trained for c in ranked)
    assert accs == sorted(accs, reverse=True)
    assert all(0.0 <= a <= 1.0 for a in accs)
    assert "conv1d-stack(" in ranked[0].describe()


def test_project_full_workflow(tmp_path):
    samples = keyword_audio(n_per_class=24, n_classes=3, n_samples=N_SAMPLES)
    p = Project("kws", tmp_path / "port", device="cpu")
    v = p.ingest(samples)
    assert len(p.dataset.versions()) == 1
    assert v == JProject("kws", tmp_path / "jax").ingest(
        keyword_audio(n_per_class=24, n_classes=3, n_samples=N_SAMPLES))
    p.set_impulse("mfcc", {"n_mels": 32, "n_coeffs": 10},
                  "conv1d-stack", {"n_blocks": 2, "ch_first": 16,
                                   "ch_last": 32})
    p.train(epochs=8)
    res = p.test()
    assert res["accuracy"] >= 0.6
    assert np.asarray(res["confusion"]).sum() == len(p.dataset.split("test"))
    meta = p.quantize()
    assert meta["compression"] > 2
    e = p.estimate("nano33ble")
    assert e.fits
    ranked = p.tune(n_samples=3, epochs=1)
    assert all(c.trained for c in ranked)
    art = p.deploy(tmp_path / "deploy.bin", int8=True)
    assert (tmp_path / "deploy.bin").exists()
    assert art.artifact_bytes > 0 and art.name.endswith("+int8")
    x = torch.from_numpy(p.dataset.arrays("test")[0][:1])
    loaded = CompiledArtifact.load(tmp_path / "deploy.bin")
    assert torch.equal(loaded.rehydrate()(x), art.rehydrate()(x))
    assert torch.equal(art.rehydrate()(x), p.impulse.logits_int8(x))
    stages = p.summary()["stages_run"]
    for s in ("ingest", "set_impulse", "train", "test", "quantize",
              "estimate", "tune", "deploy"):
        assert s in stages
    assert p.summary()["impulse"] == "mfcc+conv1d-stack"
    # the log is persisted (API-driven automation record)
    assert (tmp_path / "port" / "project_log.json").exists()


def test_project_calibrate_postprocessing():
    p = Project("kws", device="cpu")
    rng = np.random.RandomState(0)
    scores = rng.rand(400).astype(np.float32)
    front = p.calibrate_postprocessing(scores, [(100, 110), (300, 305)],
                                       generations=2, population=8)
    assert front and p.log[-1] == {"stage": "calibrate",
                                   "front": float(len(front))}


def test_registry_matches_jax():
    got, want = treg.describe(), jreg.describe()
    assert list(got) == list(want) == treg.list_architectures()
    ported = [a for a in got if tconfigs.comes_with(a) is None]
    assert sorted(ported) == ["dbrx-132b", "falcon-mamba-7b", "gemma3-4b",
                              "granite-3-8b", "internlm2-1.8b", "llama3.2-3b",
                              "phi3.5-moe-42b-a6.6b", "qwen2-vl-72b",
                              "seamless-m4t-large-v2", "zamba2-2.7b"]
    for arch in got:
        if arch in ported:
            assert got[arch] == want[arch], arch
            assert treg.get_arch(arch, smoke=True).n_layers == \
                jconfigs.get_smoke(arch).n_layers
        else:
            assert got[arch]["comes_with"].startswith("slice "), arch
            with pytest.raises(NotImplementedError, match="slice"):
                treg.get_arch(arch)
    assert treg.list_shapes() == jreg.list_shapes()
    assert treg.PAPER_MODELS == jreg.PAPER_MODELS
    assert treg.DSP_BLOCKS == jreg.DSP_BLOCKS
