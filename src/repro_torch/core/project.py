"""Project façade (paper §4.9): the programmatic API surface.

Edge Impulse exposes every platform stage via REST so pipelines can be
automated without the Studio GUI.  ``Project`` is that surface in
Python: one object owning the dataset, the impulse, tuning, deployment
and calibration; each method maps 1:1 onto a platform stage, so
``examples/`` and third-party code never reach into internals.  The
counterpart of ``repro.core.project``, on the card unless the caller
passes ``device="cpu"``.

    p = Project("kws-demo", workdir)
    p.ingest(samples)                 # data acquisition
    p.set_impulse("mfcc", {...}, "conv1d-stack", {...})
    p.train(epochs=5)                 # ML design & training
    p.test()                          # evaluation
    p.quantize()                      # compression (C5)
    p.estimate("nano33ble")           # estimation (C2)
    p.tune(n_samples=8)               # AutoML (C3)
    p.deploy(out_path)                # conversion & compilation (C4)
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import estimator as est
from repro_torch.core.blocks import make_dsp_block, make_learn_block
from repro_torch.core.calibration import calibrate
from repro_torch.core.eon_compiler import CompiledArtifact, compile_impulse
from repro_torch.core.impulse import Impulse
from repro_torch.core.tuner import EONTuner
from repro_torch.data.dataset import Dataset, Sample


class Project:
    def __init__(self, name: str, workdir: Optional[Path] = None,
                 n_classes: int = 0, seed: int = 0,
                 device: Union[str, torch.device, None] = None):
        self.name = name
        self.workdir = Path(workdir) if workdir else None
        self.dataset = Dataset(self.workdir / "data" if self.workdir
                               else None)
        self.n_classes = n_classes
        self.impulse: Optional[Impulse] = None
        self.seed = seed
        self.device = resolve_device(device)
        self.log: List[Dict[str, Any]] = []

    # -- data acquisition ------------------------------------------------
    def ingest(self, samples: Iterable[Sample], message: str = "") -> str:
        ids = self.dataset.add_many(samples)
        self.n_classes = max(self.n_classes,
                             max((s.label for s in
                                  self.dataset.samples.values()),
                                 default=-1) + 1)
        version = self.dataset.commit(message or f"ingest {len(ids)}")
        self._log("ingest", n=len(ids), version=version)
        return version

    # -- impulse design ----------------------------------------------------
    def set_impulse(self, dsp_kind: str, dsp_hp: Dict, learn_kind: str,
                    learn_hp: Dict) -> Impulse:
        any_sample = next(iter(self.dataset.samples.values()))
        input_shape = (any_sample.data.shape[0]
                       if any_sample.data.ndim == 1
                       else tuple(any_sample.data.shape))
        learn_hp = dict(learn_hp)
        learn_hp.setdefault("n_classes", self.n_classes)
        self.impulse = Impulse(make_dsp_block(dsp_kind, **dsp_hp),
                               make_learn_block(learn_kind, **learn_hp),
                               input_shape=input_shape, device=self.device)
        self.impulse.init(
            torch.Generator(device=self.device).manual_seed(self.seed))
        self._log("set_impulse", dsp=dsp_kind, model=learn_kind)
        return self.impulse

    # -- train / evaluate --------------------------------------------------
    def train(self, epochs: int = 5, batch_size: int = 16,
              lr: float = 2e-3) -> Dict[str, Any]:
        xs, ys = self.dataset.arrays("train")
        out = self.impulse.fit((np.asarray(xs), np.asarray(ys)),
                               epochs=epochs, batch_size=batch_size, lr=lr)
        self._log("train", **out["final"])
        return out

    def test(self) -> Dict[str, Any]:
        xs, ys = self.dataset.arrays("test")
        acc = self.impulse.evaluate(self.impulse.params,
                                    np.asarray(xs), np.asarray(ys))
        cm = self.impulse.confusion_matrix(np.asarray(xs), np.asarray(ys),
                                           self.n_classes)
        self._log("test", acc=acc)
        return {"accuracy": acc, "confusion": cm.tolist()}

    # -- compression / estimation / deployment ------------------------------
    def quantize(self) -> Dict[str, Any]:
        xs, _ = self.dataset.arrays("train")
        self.impulse.quantize(np.asarray(xs[:16]))
        meta = self.impulse.qparams.meta
        self._log("quantize", compression=meta["compression"])
        return meta

    def estimate(self, target: str, engine: str = "eon",
                 int8: bool = True) -> est.ResourceEstimate:
        e = est.estimate_impulse(self.impulse, target, engine=engine,
                                 int8=int8)
        self._log("estimate", target=target, ram_kb=e.ram_kb,
                  flash_kb=e.flash_kb, latency_ms=e.total_latency_ms)
        return e

    def tune(self, n_samples: int = 8, target: str = "nano33ble",
             epochs: int = 2) -> List:
        any_sample = next(iter(self.dataset.samples.values()))
        tuner = EONTuner(input_samples=int(any_sample.data.shape[0]),
                         n_classes=self.n_classes, target=target,
                         seed=self.seed, device=self.device)
        xtr, ytr = self.dataset.arrays("train")
        xva, yva = self.dataset.arrays("val")
        ranked = tuner.search((np.asarray(xtr), np.asarray(ytr)),
                              (np.asarray(xva), np.asarray(yva)),
                              n_samples=n_samples, epochs=epochs)
        self._log("tune", candidates=n_samples, survivors=len(ranked))
        return ranked

    def deploy(self, path: Optional[Path] = None,
               int8: bool = False) -> CompiledArtifact:
        art = compile_impulse(self.impulse, batch_size=1, int8=int8)
        if path:
            art.save(Path(path))
        self._log("deploy", bytes=art.artifact_bytes, int8=int8)
        return art

    def calibrate_postprocessing(self, scores: np.ndarray,
                                 event_spans, **kw) -> List[Dict]:
        front = calibrate(scores, event_spans, **kw)
        self._log("calibrate", front=len(front))
        return front

    # -- bookkeeping ---------------------------------------------------------
    def _log(self, stage: str, **kw) -> None:
        rec = {"stage": stage, **{k: (float(v) if isinstance(v, (int, float))
                                      else v) for k, v in kw.items()}}
        self.log.append(rec)
        if self.workdir:
            self.workdir.mkdir(parents=True, exist_ok=True)
            (self.workdir / "project_log.json").write_text(
                json.dumps(self.log, indent=1, default=str))

    def summary(self) -> Dict[str, Any]:
        return {"name": self.name, "samples": len(self.dataset),
                "classes": self.n_classes,
                "impulse": (f"{self.impulse.dsp.name}+"
                            f"{self.impulse.learn.name}"
                            if self.impulse else None),
                "stages_run": [r["stage"] for r in self.log]}
