"""Active learning loop (paper C7 / §4.8, Moreau 2022).

The paper's four steps: (1) train on a small labeled subset,
(2) embed all samples with an intermediate layer, (3) reduce to 2D for
the data explorer, (4) label/clean by proximity to labeled clusters.
PCA stands in for UMAP/t-SNE (same role: the explorer projection);
labeling uses distance-to-labeled-centroid with an abstention radius.

The port's counterpart of ``repro.core.active_learning``: the loop runs
in numpy on the host, as there; ``embed_dataset`` takes an embedding
function that returns numpy arrays or tensors on any device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch


def pca_2d(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) -> (N, 2) projection + explained-variance ratios."""
    mu = x.mean(axis=0)
    xc = x - mu
    u, s, vt = np.linalg.svd(xc, full_matrices=False)
    proj = xc @ vt[:2].T
    var = (s ** 2) / max((s ** 2).sum(), 1e-12)
    return proj, var[:2]


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def embed_dataset(apply_embed: Callable, xs, batch: int = 64) -> np.ndarray:
    """``apply_embed`` over ``xs`` in batches, gathered on the host."""
    outs = []
    for i in range(0, xs.shape[0], batch):
        outs.append(_to_numpy(apply_embed(xs[i:i + batch])))
    return np.concatenate(outs, axis=0)


@dataclasses.dataclass
class ProximityLabeler:
    """Nearest-labeled-centroid labeling with abstention."""
    centroids: np.ndarray          # (C, D)
    radii: np.ndarray              # (C,) per-class abstention radius

    @staticmethod
    def fit(emb: np.ndarray, labels: np.ndarray, n_classes: int,
            radius_quantile: float = 0.9) -> "ProximityLabeler":
        cents, radii = [], []
        for c in range(n_classes):
            pts = emb[labels == c]
            ctr = pts.mean(axis=0)
            d = np.linalg.norm(pts - ctr, axis=1)
            cents.append(ctr)
            radii.append(np.quantile(d, radius_quantile) + 1e-9)
        return ProximityLabeler(np.stack(cents), np.asarray(radii))

    def propose(self, emb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (labels (N,), confident mask (N,)); label -1 = abstain."""
        d = np.linalg.norm(emb[:, None, :] - self.centroids[None], axis=2)
        nearest = d.argmin(axis=1)
        conf = d[np.arange(len(emb)), nearest] <= self.radii[nearest]
        labels = np.where(conf, nearest, -1)
        return labels, conf


def active_learning_round(apply_embed: Callable, xs, labeled_idx: np.ndarray,
                          labels: np.ndarray, n_classes: int
                          ) -> Dict[str, np.ndarray]:
    """One loop iteration: embed everything, fit on the labeled subset,
    propose labels for the rest, and return the 2D explorer view."""
    emb = embed_dataset(apply_embed, xs)
    labeler = ProximityLabeler.fit(emb[labeled_idx], labels[labeled_idx],
                                   n_classes)
    proposed, confident = labeler.propose(emb)
    proposed[labeled_idx] = labels[labeled_idx]
    proj, var = pca_2d(emb)
    return {"proposed": proposed, "confident": confident,
            "projection": proj, "explained_variance": var,
            "embeddings": emb}
