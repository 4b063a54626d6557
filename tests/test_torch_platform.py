"""Port parity: performance calibration (paper C6) and the active-learning
loop (paper C7) against the JAX package, on the CPU.

Both are host code; the port keeps its own copies.  The same scores,
event spans and seed give the same Pareto front of post-processing
configurations; the same embeddings give the same proposed labels,
confidence, projection and explained variance.  ``embed_dataset`` also
takes an embedding function that returns tensors (from the card, in
use), and the properties of ``tests/test_core.py`` hold on the port's
side.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import active_learning as jal
from repro.core import calibration as jcal
from repro_torch.core import active_learning as tal
from repro_torch.core import calibration as tcal
from repro_torch.data import synthetic as tsyn


@pytest.mark.parametrize("seed", [0, 5])
def test_calibrate_front_matches_jax(seed):
    scores, spans = tsyn.event_stream(n_windows=6000, n_events=25, seed=3)
    kw = dict(generations=6, population=16, seed=seed)
    got = tcal.calibrate(scores, spans, **kw)
    assert got == jcal.calibrate(scores, spans, **kw)
    fars = [p["far_per_hour"] for p in got]
    frrs = [p["frr"] for p in got]
    assert fars == sorted(fars)
    assert all(frrs[i] >= frrs[i + 1] for i in range(len(frrs) - 1))
    assert min(frrs) <= 0.2


def test_postprocess_and_far_frr_match_jax():
    scores, spans = tsyn.event_stream(n_windows=4000, n_events=15, seed=1)
    fars = []
    for sw, th, sp in ((1, 0.5, 0), (3, 0.3, 5), (5, 0.7, 2), (3, 0.9, 5)):
        tc, jc = tcal.PostProcessConfig(sw, th, sp), \
            jcal.PostProcessConfig(sw, th, sp)
        np.testing.assert_array_equal(tcal.apply_postprocess(scores, tc),
                                      jcal.apply_postprocess(scores, jc))
        got = tcal.far_frr(scores, spans, tc, windows_per_hour=3600)
        assert got == jcal.far_frr(scores, spans, jc, windows_per_hour=3600)
        if (sw, sp) == (3, 5):
            fars.append(got[0])
    assert fars[0] >= fars[1]          # raising the threshold cannot raise FAR


def test_config_moves_match_jax():
    import random
    a, b = tcal.PostProcessConfig(3, 0.5, 4), tcal.PostProcessConfig(7, 0.2, 9)
    ja, jb = (jcal.PostProcessConfig(**dataclasses.asdict(c)) for c in (a, b))
    r1, r2 = random.Random(11), random.Random(11)
    for _ in range(20):
        got = dataclasses.asdict(tcal.PostProcessConfig.crossover(a, b, r1)
                                 .mutate(r1))
        want = dataclasses.asdict(jcal.PostProcessConfig.crossover(ja, jb, r2)
                                  .mutate(r2))
        assert got == want
    points = [(1.0, 0.5, a), (0.5, 0.7, b), (2.0, 0.1, a), (1.5, 0.5, b)]
    assert [p[:2] for p in tcal.pareto_front(points)] == \
        [p[:2] for p in jcal.pareto_front(points)]


def _clusters():
    rng = np.random.RandomState(0)
    n_per, d, classes = 60, 16, 3
    centers = rng.randn(classes, d) * 6
    xs = np.concatenate([centers[c] + rng.randn(n_per, d)
                         for c in range(classes)])
    ys = np.repeat(np.arange(classes), n_per)
    labeled = np.concatenate([np.where(ys == c)[0][:8]
                              for c in range(classes)])
    return xs, ys, labeled, classes


@pytest.mark.parametrize("embed", ["numpy", "tensor"])
def test_active_learning_round_matches_jax(embed):
    xs, ys, labeled, classes = _clusters()
    w = np.random.RandomState(1).randn(16, 8)
    if embed == "numpy":
        fn = lambda x: np.tanh(x @ w)                          # noqa: E731
    else:
        fn = lambda x: torch.from_numpy(np.tanh(x @ w))        # noqa: E731
    got = tal.active_learning_round(fn, xs, labeled, ys, classes)
    want = jal.active_learning_round(lambda x: np.tanh(x @ w), xs, labeled,
                                     ys, classes)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    mask = got["confident"] & (got["proposed"] >= 0)
    assert (got["proposed"][mask] == ys[mask]).mean() >= 0.95
    assert mask.mean() > 0.5
    assert got["projection"].shape == (len(xs), 2)


def test_labeler_and_pca_match_jax():
    xs, ys, labeled, classes = _clusters()
    tl = tal.ProximityLabeler.fit(xs[labeled], ys[labeled], classes, 0.8)
    jl = jal.ProximityLabeler.fit(xs[labeled], ys[labeled], classes, 0.8)
    np.testing.assert_array_equal(tl.centroids, jl.centroids)
    np.testing.assert_array_equal(tl.radii, jl.radii)
    for a, b in zip(tl.propose(xs), jl.propose(xs)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tal.pca_2d(xs), jal.pca_2d(xs)):
        np.testing.assert_array_equal(a, b)
    out = tal.embed_dataset(lambda x: torch.from_numpy(x).float(), xs,
                            batch=50)
    assert out.shape == xs.shape and out.dtype == np.float32
