"""SC3's consensus similarity of the cells on arrays (counterpart:
dance_tpu/transforms/sc3_feature.py, ``normalized_laplacian`` :19 and
``SC3Feature`` :25-69).

Three distance matrices (Euclidean, Pearson, Spearman), each projected by
PCA and by its normalised Laplacian; k-means on every prefix of the chosen
columns of each projection; the consensus is the mean over those
clusterings of the cells' co-membership. The distances, projections,
k-means runs and the consensus run on ``device`` (the CUDA card unless the
CPU is named); the choice of columns is numpy's ``default_rng(seed).choice``,
JAX's draw bit for bit. The JAX transform writes the consensus to ``uns``;
the port returns it (float64). The k-means starts are torch draws, not
``jax.random`` ones (:func:`~dance_tpu_torch.ops.cluster.kmeans`).
"""

import math
from typing import List, Optional

import numpy as np
import scipy.sparse as sp
import torch

from dance_tpu_torch.ops.cluster import kmeans
from dance_tpu_torch.ops.linalg import pca
from dance_tpu_torch.utils import resolve_device
from dance_tpu_torch.utils.matrix import pairwise_distance


def normalized_laplacian(adj):
    """``I - D^-1/2 A D^-1/2`` with the row sums of ``A`` (at least 1e-12)
    as degrees (counterpart: sc3_feature.py:19). A tensor stays a tensor on
    its device (float64); an array gives a float64 array."""
    if not isinstance(adj, torch.Tensor):
        return normalized_laplacian(torch.from_numpy(np.asarray(adj, np.float64))).numpy()
    adj = adj.to(torch.float64)
    r_sqrt = 1.0 / torch.sqrt(adj.sum(1).clamp(min=1e-12))
    eye = torch.eye(adj.shape[0], dtype=torch.float64, device=adj.device)
    return eye - (r_sqrt[:, None] * adj) * r_sqrt[None, :]


def sc3_columns(n_cells: int, d: Optional[int] = None, seed: int = 9) -> List[int]:
    """The projection columns SC3 clusters on (counterpart:
    sc3_feature.py:44-51): ``d`` defaults to ``ceil(0.07 n) - floor(0.04
    n)``; above 15, 15 of ``range(d)`` drawn without replacement by
    ``np.random.default_rng(seed)`` and sorted, else ``range(max(d, 1))``."""
    if d is None:
        d = math.ceil(n_cells * 0.07) - math.floor(n_cells * 0.04)
    if d > 15:
        rng = np.random.default_rng(seed)
        return sorted(rng.choice(range(d), 15, replace=False))
    return list(range(max(d, 1)))


class SC3Feature:
    """SC3's cluster-based similarity partitioning (counterpart:
    sc3_feature.py:25). ``__call__(x)`` returns the (cells, cells) float64
    consensus of ``n_cluster``-means clusterings."""

    def __init__(self, n_cluster: int = 3, d: Optional[int] = None, seed: int = 9,
                 device="auto"):
        self.n_cluster = n_cluster
        self.d = d
        self.seed = seed
        self.device = device

    def __call__(self, x) -> np.ndarray:
        device = resolve_device(self.device)
        feat = np.asarray(x.toarray() if sp.issparse(x) else x, np.float32)
        n = feat.shape[0]
        choices = sc3_columns(n, self.d, self.seed)
        mats = []
        for dist in ("euclidean", "pearson", "spearman"):
            dm = torch.from_numpy(pairwise_distance(feat, dist_func=dist, device=device))
            dm = dm.to(device)
            emb = pca(dm, min(n - 1, max(choices) + 1)).embedding
            mats.append(emb[:, [c for c in choices if c < emb.shape[1]]])
            lap = normalized_laplacian(dm)
            mats.append(lap[:, [c for c in choices if c < lap.shape[1]]])
        consensus = torch.zeros((n, n), dtype=torch.float64, device=device)
        count = 0
        for mat in mats:
            for i in range(mat.shape[1]):
                labels = kmeans(mat[:, :i + 1], self.n_cluster, n_init=1, seed=self.seed).labels
                consensus += (labels[:, None] == labels[None, :]).to(torch.float64)
                count += 1
        return (consensus / count).cpu().numpy()


__all__ = ["SC3Feature", "normalized_laplacian", "sc3_columns"]
