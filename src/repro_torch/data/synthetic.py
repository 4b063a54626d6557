"""Synthetic data generators: classifiable keyword audio, event streams
for performance calibration, and LM token streams.  The port's own copy
of ``repro.data.synthetic`` (numpy only): the same seed gives the same
samples bit for bit.

Keyword classes are distinct multi-tone chirps in noise — hard enough
that the DSP + model choice matters (the Table 3 sweep separates), easy
enough to train in seconds on CPU.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.data.dataset import Sample


def keyword_audio(n_per_class: int = 40, n_classes: int = 4,
                  n_samples: int = 16_000, sample_rate: int = 16_000,
                  snr_db: float = 8.0, seed: int = 0) -> List[Sample]:
    rng = np.random.RandomState(seed)
    out: List[Sample] = []
    base_freqs = 300.0 * (1.7 ** np.arange(n_classes))
    t = np.arange(n_samples) / sample_rate
    for c in range(n_classes):
        for i in range(n_per_class):
            f0 = base_freqs[c] * rng.uniform(0.9, 1.1)
            sweep = rng.uniform(-0.3, 0.3)
            sig = np.zeros(n_samples, np.float32)
            # keyword = 3 harmonics with class-specific AM pattern
            env_rate = 2.0 + c * 1.5
            env = 0.5 * (1 + np.sin(2 * np.pi * env_rate * t
                                    + rng.uniform(0, 2 * np.pi)))
            for h, amp in ((1, 1.0), (2, 0.5), (3, 0.25)):
                freq = f0 * h * (1 + sweep * t)
                sig += amp * np.sin(2 * np.pi * freq * t).astype(np.float32)
            sig *= env.astype(np.float32)
            noise = rng.randn(n_samples).astype(np.float32)
            snr = 10 ** (snr_db / 20)
            sig = sig / (np.std(sig) + 1e-6) * snr + noise
            sig /= np.abs(sig).max() + 1e-6
            out.append(Sample(sig.astype(np.float32), c,
                              {"source": "synthetic", "class": int(c),
                               "seed": int(seed), "idx": int(i)}))
    return out


def event_stream(n_windows: int = 20_000, n_events: int = 60,
                 event_len: int = 12, noise: float = 0.18, seed: int = 0
                 ) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """Per-window detector scores with ground-truth event spans — the
    performance-calibration input (score ~ high during events + noise)."""
    rng = np.random.RandomState(seed)
    scores = np.clip(rng.rand(n_windows) * noise * 2.4, 0, 1)
    spans = []
    for _ in range(n_events):
        a = rng.randint(0, n_windows - event_len)
        spans.append((a, a + event_len))
        ramp = np.hanning(event_len) * rng.uniform(0.55, 1.0)
        scores[a:a + event_len] = np.maximum(scores[a:a + event_len], ramp)
    # sprinkle confusable distractors
    for _ in range(n_events // 2):
        a = rng.randint(0, n_windows - 4)
        scores[a:a + 3] = np.maximum(scores[a:a + 3],
                                     rng.uniform(0.4, 0.75))
    return scores.astype(np.float32), spans


def token_stream(n_tokens: int, vocab_size: int, seed: int = 0,
                 order: int = 2) -> np.ndarray:
    """Markov token stream — a learnable LM target (loss drops below
    the unigram entropy only if the model actually fits the chain)."""
    rng = np.random.RandomState(seed)
    ctx = vocab_size
    # sparse transition structure: each context prefers 4 successors
    prefer = rng.randint(0, vocab_size, size=(ctx, 4))
    out = np.empty(n_tokens, np.int32)
    state = rng.randint(vocab_size)
    for i in range(n_tokens):
        if rng.rand() < 0.85:
            state = int(prefer[state, rng.randint(4)])
        else:
            state = int(rng.randint(vocab_size))
        out[i] = state
    return out


def lm_batches(tokens: np.ndarray, batch: int, seq: int, seed: int = 0):
    """Yield {tokens, labels} windows forever."""
    rng = np.random.RandomState(seed)
    n = len(tokens) - seq - 1
    while True:
        idx = rng.randint(0, n, size=batch)
        x = np.stack([tokens[i:i + seq] for i in idx])
        y = np.stack([tokens[i + 1:i + seq + 1] for i in idx])
        yield {"tokens": x, "labels": y}
