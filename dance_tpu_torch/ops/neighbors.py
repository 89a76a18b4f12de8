"""Exact k-nearest neighbours and neighbour graphs (counterpart:
dance_tpu/ops/neighbors.py:46-129).

Host numpy in, host scipy out, computed on the CPU. Two branches, as in the
JAX package: a KD-tree (scipy) for 2-3-D coordinates, which gives the same
graphs bit for bit, and a blocked torch distance matrix plus ``topk`` for
high-dimensional features (``method="device"`` keeps the JAX name). The
TPU's two-stage top-k (neighbors.py:26-40) works round a full sort on the TPU
and is not carried over.
"""

from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from dance_tpu_torch.utils.matrix import pairwise_distance


def _knn_block(q: torch.Tensor, x: torch.Tensor, k: int):
    d2 = (q ** 2).sum(1)[:, None] + (x ** 2).sum(1)[None, :] - 2 * (q @ x.T)
    neg, idx = torch.topk(-d2, k, dim=1)
    return torch.sqrt((-neg).clamp(min=0.0)), idx


def knn(x, k: int, *, include_self: bool = True, block_size: int = 4096,
        method: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
    """Exact kNN over the rows of ``x``: ``(distances, indices)``, each (n, k),
    float32 and int64 (counterpart: neighbors.py:46). ``method`` is
    ``"kdtree"``, ``"device"`` or ``"auto"`` (KD-tree iff dim <= 3)."""
    n = x.shape[0]
    kq = k if include_self else k + 1
    if kq > n:
        raise ValueError(
            f"knn: k={k} (include_self={include_self}) needs at least {kq} points but only "
            f"{n} are available; clamp k at the call site (e.g. k=min(k, n-1)) to keep the "
            f"(n, k) result contract")
    if method == "auto":
        method = "kdtree" if x.shape[1] <= 3 else "device"
    if method == "kdtree":
        from scipy.spatial import cKDTree

        xh = np.asarray(x, np.float32)
        d, i = cKDTree(xh).query(xh, k=kq)
        d, i = d.astype(np.float32), i.astype(np.int64)
        if kq == 1:
            d, i = d[:, None], i[:, None]
    elif method == "device":
        xd = torch.as_tensor(np.asarray(x, np.float32))
        blocks = [_knn_block(xd[s:s + block_size], xd, kq) for s in range(0, n, block_size)]
        d = torch.cat([b[0] for b in blocks]).numpy()
        i = torch.cat([b[1] for b in blocks]).numpy()
    else:
        raise ValueError(f"Unknown method {method!r}")
    if not include_self:
        # drop the self column; where a row's own index is missing, the farthest
        self_col = i == np.arange(n)[:, None]
        keep = ~self_col
        keep[~self_col.any(1), kq - 1] = False
        d = d[keep].reshape(n, kq - 1)
        i = i[keep].reshape(n, kq - 1)
    return d, i


def knn_graph(x, k: int, *, mode: str = "connectivity", include_self: bool = False,
              symmetrize: bool = True) -> sp.csr_matrix:
    """kNN graph as scipy CSR (counterpart: neighbors.py:97). ``mode`` is
    ``"connectivity"`` (0/1), ``"distance"`` or ``"gauss"``."""
    d, i = knn(x, k, include_self=include_self)
    n = x.shape[0]
    rows = np.repeat(np.arange(n), i.shape[1])
    cols = i.ravel()
    if mode == "connectivity":
        vals = np.ones_like(cols, dtype=np.float32)
    elif mode == "distance":
        vals = d.ravel().astype(np.float32)
    elif mode == "gauss":
        sigma = np.maximum(d[:, -1:], 1e-12)
        vals = np.exp(-((d / sigma) ** 2)).ravel().astype(np.float32)
    else:
        raise ValueError(f"Unknown mode {mode!r}")
    g = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    if symmetrize:
        g = g.maximum(g.T)
    return g


def radius_graph(coords, radius: float) -> sp.csr_matrix:
    """All pairs within ``radius``, without self-loops (counterpart:
    neighbors.py:123)."""
    d = pairwise_distance(np.asarray(coords, np.float32))
    mask = (d <= radius) & ~np.eye(d.shape[0], dtype=bool)
    return sp.csr_matrix(mask.astype(np.float32))


__all__ = ["knn", "knn_graph", "radius_graph"]
