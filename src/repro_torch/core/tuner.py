"""EON Tuner (paper C3 / §4.7): AutoML over the joint (DSP × NN) space
under hard target-hardware constraints.

The paper's method: **random search + a cheap heuristic screen**.  Sample
configurations, predict their resources with the static estimator (C2),
discard the ones that break a constraint *before* any training, then
train the survivors briefly and rank them.  The counterpart of
``repro.core.tuner.EONTuner``, with its space, its sampling order and its
seeds: ``build`` takes the same ``randrange(2 ** 31)`` from the tuner's
``random.Random`` and seeds a ``torch.Generator`` on the tuner's device
with it, so a seed samples, screens and builds the same candidates in
both packages (the weights differ: torch's generator is not
``jax.random``).  The survivors train with ``Impulse.fit`` on the card,
through the ``mel_frontend`` kernel.

``PodConfigTuner`` runs the same loop over distribution knobs (sharding
strategy x microbatches x remat) for one (arch x shape) cell, scored by
the dry run's roofline (``launch/dryrun.py::run_cell``) under the card's
memory.  On one card a strategy changes no layout, so candidates that
differ only in it tie; the sort is stable, so they keep the shuffle's
order.
"""
from __future__ import annotations

import dataclasses
import itertools
import random as pyrandom
from typing import (Any, Callable, Dict, List, Optional, Sequence,
                    Union)

import torch

from repro_torch import resolve_device
from repro_torch.core import estimator as est
from repro_torch.core.blocks import make_dsp_block, make_learn_block
from repro_torch.core.impulse import Impulse
from repro_torch.roofline.hw import H100


@dataclasses.dataclass
class Candidate:
    dsp_kind: str
    dsp_hp: Dict[str, Any]
    model_kind: str
    model_hp: Dict[str, Any]
    estimate: Optional[est.ResourceEstimate] = None
    accuracy: Optional[float] = None
    trained: bool = False

    def describe(self) -> str:
        d = ", ".join(f"{v}" for v in self.dsp_hp.values())
        m = ", ".join(f"{k}={v}" for k, v in self.model_hp.items()
                      if k != "n_classes")
        return f"{self.dsp_kind}({d}) + {self.model_kind}({m})"


DEFAULT_KWS_SPACE = {
    "dsp": [
        ("mfe", {"frame_s": [0.02, 0.032, 0.05],
                 "stride_s": [0.01, 0.016, 0.02, 0.025],
                 "n_mels": [32, 40]}),
        ("mfcc", {"frame_s": [0.02, 0.05],
                  "stride_s": [0.01, 0.025],
                  "n_mels": [32, 40], "n_coeffs": [10, 13]}),
    ],
    "model": [
        ("conv1d-stack", {"n_blocks": [2, 3, 4],
                          "ch_first": [16, 32],
                          "ch_last": [32, 64, 128, 256]}),
    ],
}


class EONTuner:
    def __init__(self, *, input_samples: int, n_classes: int,
                 target: str = "nano33ble", engine: str = "eon",
                 int8: bool = True,
                 max_ram_kb: Optional[float] = None,
                 max_flash_kb: Optional[float] = None,
                 max_latency_ms: Optional[float] = None,
                 space: Dict = None, seed: int = 0,
                 device: Union[str, torch.device, None] = None):
        self.input_samples = input_samples
        self.n_classes = n_classes
        self.target = target
        self.engine = engine
        self.int8 = int8
        t = est.TARGETS[target]
        self.max_ram_kb = max_ram_kb or t.ram_bytes / 1024
        self.max_flash_kb = max_flash_kb or t.flash_bytes / 1024
        self.max_latency_ms = max_latency_ms
        self.space = space or DEFAULT_KWS_SPACE
        self.rng = pyrandom.Random(seed)
        self.device = resolve_device(device)

    # -- phase 1: random sampling -------------------------------------
    def sample(self, n: int) -> List[Candidate]:
        out = []
        for _ in range(n):
            dsp_kind, dsp_grid = self.rng.choice(self.space["dsp"])
            model_kind, model_grid = self.rng.choice(self.space["model"])
            dsp_hp = {k: self.rng.choice(v) for k, v in dsp_grid.items()}
            model_hp = {k: self.rng.choice(v) for k, v in model_grid.items()}
            model_hp["n_classes"] = self.n_classes
            if model_hp.get("ch_last", 0) < model_hp.get("ch_first", 0):
                model_hp["ch_last"] = model_hp["ch_first"]
            out.append(Candidate(dsp_kind, dsp_hp, model_kind, model_hp))
        return out

    def build(self, cand: Candidate) -> Impulse:
        imp = Impulse(make_dsp_block(cand.dsp_kind, **cand.dsp_hp),
                      make_learn_block(cand.model_kind, **cand.model_hp),
                      input_shape=self.input_samples, device=self.device)
        seed = self.rng.randrange(2 ** 31)
        return imp.init(torch.Generator(device=self.device).manual_seed(seed))

    # -- phase 2: heuristic screen (the paper's cheap estimate) --------
    def screen(self, cands: Sequence[Candidate]) -> List[Candidate]:
        keep = []
        for c in cands:
            imp = self.build(c)
            c.estimate = est.estimate_impulse(imp, self.target,
                                              engine=self.engine,
                                              int8=self.int8)
            ok = (c.estimate.ram_kb <= self.max_ram_kb
                  and c.estimate.flash_kb <= self.max_flash_kb)
            if self.max_latency_ms is not None:
                ok = ok and c.estimate.total_latency_ms <= self.max_latency_ms
            if ok:
                keep.append(c)
        return keep

    # -- phase 3: train survivors + rank -------------------------------
    def evaluate(self, cands: Sequence[Candidate], train_data, val_data, *,
                 epochs: int = 3, batch_size: int = 32) -> List[Candidate]:
        for c in cands:
            imp = self.build(c)
            imp.fit(train_data, epochs=epochs, batch_size=batch_size)
            c.accuracy = imp.evaluate(imp.params, *val_data)
            c.trained = True
        return sorted(cands, key=lambda c: -(c.accuracy or 0.0))

    def search(self, train_data, val_data, *, n_samples: int = 12,
               epochs: int = 3) -> List[Candidate]:
        cands = self.sample(n_samples)
        survivors = self.screen(cands)
        return self.evaluate(survivors, train_data, val_data, epochs=epochs)


# ---------------------------------------------------------------------------
# Pod-scale instantiation: the same loop over distribution knobs
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PodCandidate:
    strategy: str
    n_micro: Optional[int]
    remat: str
    report: Optional[Dict[str, Any]] = None

    def key(self):
        return (self.strategy, self.n_micro, self.remat)


class PodConfigTuner:
    """Random search + screen over (strategy x microbatch x remat) for one
    (arch x shape) cell on ``mesh`` (None: the dry run's one-card mesh),
    scored by ``roofline_fraction`` under the memory constraint
    (``hbm_gib``: the H100 model's).  ``evaluator`` is
    ``launch.dryrun.run_cell``; the shuffle is the reference's
    ``random.Random(seed)``, so a seed gives its candidate order."""

    def __init__(self, evaluator: Callable, *, arch: str, shape: str,
                 mesh=None, hbm_gib: float = H100.hbm_bytes / 2**30,
                 seed: int = 0):
        self.evaluator = evaluator
        self.arch = arch
        self.shape = shape
        self.mesh = mesh
        self.hbm_gib = hbm_gib
        self.rng = pyrandom.Random(seed)

    def space(self, train: bool) -> List[PodCandidate]:
        strategies = ["tp", "tp_sp", "cp"]
        micros = [None, 8, 16, 32] if train else [None]
        remats = ["full", "dots"] if train else ["none"]
        cands = [PodCandidate(s, m, r) for s, m, r
                 in itertools.product(strategies, micros, remats)]
        self.rng.shuffle(cands)
        return cands

    def search(self, *, n_samples: int = 8) -> List[PodCandidate]:
        train = self.shape.startswith("train")
        cands = self.space(train)[:n_samples]
        scored = []
        for c in cands:
            try:
                res = self.evaluator(self.arch, self.shape, mesh=self.mesh,
                                     strategy=c.strategy, n_micro=c.n_micro,
                                     remat=c.remat)
            except Exception as e:   # an illegal combination is a miss
                res = {"status": "error", "error": str(e)[:300]}
            c.report = res
            scored.append(c)
        ok = [c for c in scored
              if c.report.get("status") == "ok"
              and c.report["memory"]["per_device_hbm_gib"] <= self.hbm_gib]
        return sorted(
            ok, key=lambda c: -c.report["roofline"]["roofline_fraction"])
