"""Performance calibration (paper C6 / §4.4, Situnayake 2022).

For streaming event detection, raw per-window model scores must pass a
post-processing chain (score smoothing → threshold → suppression) before
becoming detections.  The paper tunes that chain with a genetic
algorithm and presents configurations trading FAR (false accepts / hour)
against FRR (missed events / events).  Implemented bit-for-bit in that
spirit: NSGA-ish GA with Pareto ranking over (FAR, FRR).

The port's own copy of ``repro.core.calibration`` (numpy and the standard
library only): the same scores, spans and seed give the same front.
"""
from __future__ import annotations

import dataclasses
import random as pyrandom
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class PostProcessConfig:
    smooth_window: int        # moving-average over per-window scores
    threshold: float          # detection threshold on smoothed score
    suppression: int          # windows to suppress after a detection

    def mutate(self, rng: pyrandom.Random) -> "PostProcessConfig":
        sw = max(1, self.smooth_window + rng.choice([-2, -1, 0, 1, 2]))
        th = float(np.clip(self.threshold + rng.gauss(0, 0.08), 0.05, 0.99))
        sp = max(0, self.suppression + rng.choice([-3, -1, 0, 1, 3]))
        return PostProcessConfig(sw, th, sp)

    @staticmethod
    def crossover(a: "PostProcessConfig", b: "PostProcessConfig",
                  rng: pyrandom.Random) -> "PostProcessConfig":
        return PostProcessConfig(
            rng.choice([a.smooth_window, b.smooth_window]),
            rng.choice([a.threshold, b.threshold]),
            rng.choice([a.suppression, b.suppression]))


def apply_postprocess(scores: np.ndarray, cfg: PostProcessConfig
                      ) -> np.ndarray:
    """scores: (T,) per-window positive-class probability.
    Returns detection indicator (T,) after smoothing/threshold/suppress."""
    if cfg.smooth_window > 1:
        kernel = np.ones(cfg.smooth_window) / cfg.smooth_window
        sm = np.convolve(scores, kernel, mode="same")
    else:
        sm = scores
    det = np.zeros_like(scores, dtype=bool)
    cooldown = 0
    for t in range(len(scores)):
        if cooldown > 0:
            cooldown -= 1
            continue
        if sm[t] >= cfg.threshold:
            det[t] = True
            cooldown = cfg.suppression
    return det


def far_frr(scores: np.ndarray, event_spans: Sequence[Tuple[int, int]],
            cfg: PostProcessConfig, *, windows_per_hour: float
            ) -> Tuple[float, float]:
    """FAR = false accepts per hour; FRR = fraction of events missed."""
    det = apply_postprocess(scores, cfg)
    in_event = np.zeros(len(scores), dtype=bool)
    for a, b in event_spans:
        in_event[a:b] = True
    false_accepts = int(np.sum(det & ~in_event))
    hits = sum(bool(det[a:b].any()) for a, b in event_spans)
    frr = 1.0 - hits / max(len(event_spans), 1)
    hours = len(scores) / windows_per_hour
    return false_accepts / max(hours, 1e-9), frr


def pareto_front(points: List[Tuple[float, float, PostProcessConfig]]
                 ) -> List[Tuple[float, float, PostProcessConfig]]:
    front = []
    for p in sorted(points, key=lambda p: (p[0], p[1])):
        while front and front[-1][1] >= p[1]:
            front.pop()
        if not front or p[1] < front[-1][1]:
            front.append(p)
    return front


def calibrate(scores: np.ndarray, event_spans: Sequence[Tuple[int, int]], *,
              windows_per_hour: float = 3600.0, generations: int = 12,
              population: int = 24, seed: int = 0
              ) -> List[Dict]:
    """GA search; returns the Pareto-optimal post-processing configs."""
    rng = pyrandom.Random(seed)
    pop = [PostProcessConfig(rng.randint(1, 9),
                             rng.uniform(0.2, 0.95),
                             rng.randint(0, 20))
           for _ in range(population)]
    seen: Dict[PostProcessConfig, Tuple[float, float]] = {}

    def fitness(cfg):
        if cfg not in seen:
            seen[cfg] = far_frr(scores, event_spans, cfg,
                                windows_per_hour=windows_per_hour)
        return seen[cfg]

    for _ in range(generations):
        scored = [(fitness(c), c) for c in pop]
        # Pareto-rank selection: non-dominated first, then crowded tail
        def dominated(a, b):
            return (b[0][0] <= a[0][0] and b[0][1] <= a[0][1]
                    and b[0] != a[0])
        ranked = sorted(
            scored, key=lambda s: (sum(dominated(s, o) for o in scored),
                                   s[0][0] + s[0][1]))
        parents = [c for _, c in ranked[:population // 2]]
        children = []
        while len(children) < population - len(parents):
            a, b = rng.sample(parents, 2)
            child = PostProcessConfig.crossover(a, b, rng)
            if rng.random() < 0.6:
                child = child.mutate(rng)
            children.append(child)
        pop = parents + children

    pts = [(far, frr, cfg) for cfg, (far, frr) in
           ((c, fitness(c)) for c in set(pop) | set(seen))]
    front = pareto_front(pts)
    return [{"far_per_hour": far, "frr": frr,
             "config": dataclasses.asdict(cfg)}
            for far, frr, cfg in front]
