"""The training loop: metrics, checkpoint cadence, fault tolerance,
straggler watchdog, best-model restoration (paper §4.3).

The counterpart of ``repro.train.trainer``.  Fault model (exercised in
the tests with injected failures):

* **crash/restart**: the trainer resumes from the latest *valid*
  checkpoint (atomic writes make partially written ones invisible);
* **step watchdog**: a step longer than ``watchdog_factor`` x the median
  step time is a straggler event; after ``max_stragglers`` consecutive
  events the trainer requests an elastic rescale;
* **best-model restoration**: track the loss, restore the best
  checkpoint at the end.

A step's time ends when its loss is read on the host, which waits for
the device (where the JAX package calls ``jax.block_until_ready``).
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.tree import leaves


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    log_every: int = 10
    keep_checkpoints: int = 3
    watchdog_factor: float = 3.0
    max_stragglers: int = 5
    restore_best: bool = True


class Trainer:
    """Runs ``train_step`` on ``params`` and ``opt_state``, which live on
    ``device`` (``cuda`` unless named; raises without a GPU)."""

    def __init__(self, train_step: Callable, params, opt_state, *,
                 ckpt_dir: Path, config: TrainerConfig = TrainerConfig(),
                 device: Union[str, torch.device, None] = None):
        self.device = resolve_device(device)
        for leaf in leaves(params.tree()) + leaves(opt_state):
            if leaf.device != self.device:
                raise ValueError(f"a weight or optimizer leaf is on"
                                 f" {leaf.device}, the trainer on"
                                 f" {self.device}")
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.cfg = config
        self.ckpt = Checkpointer(ckpt_dir, keep=config.keep_checkpoints)
        self.history: List[Dict[str, float]] = []
        self.step = 0
        self.best = {"loss": float("inf"), "step": -1}
        self.straggler_events = 0
        self.rescale_requested = False

    # ------------------------------------------------------------------
    def maybe_resume(self) -> bool:
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        _, extra = self.ckpt.restore((self.params, self.opt_state), latest)
        self.step = extra.get("step", latest)
        self.best = extra.get("best", self.best)
        return True

    # ------------------------------------------------------------------
    def run(self, batches: Iterator[Dict[str, np.ndarray]],
            fail_at: Optional[int] = None) -> Dict[str, Any]:
        """``fail_at`` simulates a node failure at that step (tests)."""
        step_times: List[float] = []
        while self.step < self.cfg.total_steps:
            batch = next(batches)
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self.train_step(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])           # waits for the device
            dt = time.perf_counter() - t0
            self.step += 1

            if fail_at is not None and self.step == fail_at:
                raise RuntimeError(f"injected node failure at step "
                                   f"{self.step}")

            # straggler watchdog
            if len(step_times) >= 5:
                med = float(np.median(step_times[-20:]))
                if dt > self.cfg.watchdog_factor * med:
                    self.straggler_events += 1
                    if self.straggler_events >= self.cfg.max_stragglers:
                        self.rescale_requested = True
                else:
                    self.straggler_events = 0
            step_times.append(dt)

            rec = {"step": self.step, "loss": loss,
                   "grad_norm": float(metrics.get("grad_norm", 0.0)),
                   "step_time_s": dt}
            self.history.append(rec)
            if loss < self.best["loss"]:
                self.best = {"loss": loss, "step": self.step}
            if self.cfg.log_every and self.step % self.cfg.log_every == 0:
                print(f"step {self.step}: loss={rec['loss']:.4f} "
                      f"gnorm={rec['grad_norm']:.3f} {dt*1e3:.0f}ms")
            if (self.cfg.checkpoint_every
                    and self.step % self.cfg.checkpoint_every == 0):
                self.ckpt.save(self.step, (self.params, self.opt_state),
                               extra={"step": self.step, "best": self.best})
        # final checkpoint + optional best restore
        self.ckpt.save(self.step, (self.params, self.opt_state),
                       extra={"step": self.step, "best": self.best})
        result = {"history": self.history, "best": self.best,
                  "final_loss": self.history[-1]["loss"],
                  "rescale_requested": self.rescale_requested}
        if (self.cfg.restore_best and self.best["step"] > 0
                and self.best["step"] in self.ckpt.all_steps()):
            self.ckpt.restore((self.params, self.opt_state),
                              self.best["step"])
            result["restored_step"] = self.best["step"]
        return result
