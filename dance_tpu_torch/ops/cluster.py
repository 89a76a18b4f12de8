"""k-means with k-means++ initialisation on a device (counterpart:
``kmeans``, dance_tpu/ops/cluster.py:18-123).

The JAX package runs the ``n_init`` restarts as one vmapped program; here they
run one after another, and only the choice of the best restart waits for the
device. Random picks come from a CPU ``torch.Generator`` seeded with
``seed + restart`` (as JAX keys restart i with ``seed + i``), so a run on the
card and on the CPU draw the same numbers; they are not JAX's numbers.
Louvain and Leiden (:126-218) are not ported yet (ROADMAP Queue 1).
"""

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F


class KMeansResult(NamedTuple):
    labels: torch.Tensor   # (n,) int64
    centers: torch.Tensor  # (n_clusters, dim)
    inertia: torch.Tensor  # () sum of squared distances to the assigned centers


def _sq_dists(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    xx = (x ** 2).sum(1)[:, None]
    cc = (centers ** 2).sum(1)[None, :]
    return (xx + cc - 2 * (x @ centers.T)).clamp(min=0.0)


def _kmeans_pp_init(x: torch.Tensor, n_clusters: int, generator: torch.Generator):
    """k-means++ (counterpart: cluster.py:25): the first center uniformly,
    each next one with probability proportional to the squared distance to
    the nearest center so far, drawn by inverse CDF from one uniform each."""
    n = x.shape[0]
    first = int(torch.randint(n, (), generator=generator))
    u = torch.rand(n_clusters, generator=generator, dtype=torch.float64).to(x.device)
    centers = x.new_zeros((n_clusters, x.shape[1]))
    centers[0] = x[first]
    for i in range(1, n_clusters):
        dmin = _sq_dists(x, centers[:i]).min(1).values.double()
        cdf = torch.cumsum(dmin, 0)
        idx = torch.searchsorted(cdf, (u[i] * cdf[-1]).reshape(1), right=True)
        centers[i] = x.index_select(0, idx.clamp(max=n - 1))[0]
    return centers


def _lloyd_step(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """One Lloyd update (counterpart: cluster.py:55); an empty cluster keeps
    its center. The sums are a one-hot matmul, as in JAX, not atomics."""
    labels = _sq_dists(x, centers).argmin(1)
    onehot = F.one_hot(labels, centers.shape[0]).to(x.dtype)
    counts = onehot.sum(0)
    new = (onehot.T @ x) / counts.clamp(min=1.0)[:, None]
    return torch.where(counts[:, None] > 0, new, centers)


def _lloyd(x: torch.Tensor, centers: torch.Tensor, n_iter: int, tol: float = 0.0):
    """``n_iter`` Lloyd steps, or with ``tol > 0`` until the squared shift of
    the centers is at most ``tol`` times the mean per-feature variance, as
    sklearn stops (counterpart: cluster.py:67). Returns (labels, centers,
    inertia)."""
    if tol > 0.0:
        tol_ = float(tol * x.var(0, unbiased=False).mean())
        shift2, i = float("inf"), 0
        while i < n_iter and shift2 > tol_:
            new = _lloyd_step(x, centers)
            shift2 = float(((new - centers) ** 2).sum())
            centers, i = new, i + 1
    else:
        for _ in range(n_iter):
            centers = _lloyd_step(x, centers)
    d2 = _sq_dists(x, centers)
    labels = d2.argmin(1)
    return labels, centers, d2.gather(1, labels[:, None]).sum()


def kmeans(x, n_clusters: int, *, n_init: int = 5, n_iter: int = 100, seed: int = 0,
           tol: float = 0.0, device: Optional[torch.device] = None) -> KMeansResult:
    """k-means, the best inertia of ``n_init`` k-means++ restarts (counterpart:
    cluster.py:110). ``x`` is a tensor (run where it lies, or on ``device``)
    or an array (run on ``device``, default the CPU); float32."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.float32))
    x = x.to(device=device or x.device, dtype=torch.float32)
    runs = [_lloyd(x, _kmeans_pp_init(x, n_clusters, torch.Generator().manual_seed(seed + i)),
                   n_iter, tol) for i in range(n_init)]
    best = int(torch.stack([inertia for _, _, inertia in runs]).argmin())
    return KMeansResult(*runs[best])


__all__ = ["KMeansResult", "kmeans"]
