"""Matrix normalization, pairwise distances and the RBF affinity
(counterpart: ``normalize``, ``dist_to_rbf``, ``pairwise_distance`` and its
``_euclidean_pdist``, ``_pearson_pdist``, ``_rankdata`` and
``_spearman_pdist``, and the single-pair distances, dance_tpu/utils/
matrix.py:19-153).

``normalize`` takes a tensor and returns one on the same device, or a numpy
array or scipy matrix and returns a numpy array (computed on the CPU), as the
JAX version returns what it was given. ``pairwise_distance`` takes and
returns host numpy, as in the JAX package. Its Euclidean, Pearson and
Spearman metrics (the names or the codes 0, 1 and 2) are computed in float32
as JAX computes them (it pins ``Precision.HIGHEST`` for the full-precision
products): the Pearson norms are clamped at 1e-12, so a constant row is at
distance 1, and Spearman correlates average-tie ranks. The ``"cosine"`` and
``"correlation"`` metrics are scikit-learn's ``pairwise_distances`` ones, in
float64 (a constant row gives NaN there), which the JAX package's EfNST
calls (EfNST.py:214-272). The arithmetic runs on the CPU unless a
``device`` is named. ``euclidean_distance``, ``pearson_distance``,
``mean_rank_data`` and ``spearman_distance`` are the host numpy helpers of
one pair of vectors.
"""

import numpy as np
import scipy.sparse as sp
import torch

NORM_MODES = ("normalize", "standardize", "minmax", "l2")


def normalize(mat, *, mode: str = "normalize", axis: int = 0, eps: float = -1.0):
    """Normalize a 2-d float32 matrix along ``axis`` (counterpart: matrix.py:19):
    ``normalize`` divides by the sum, ``standardize`` centres and divides by
    the standard deviation (over n, as ``jnp.std``), ``minmax`` rescales to
    [0, 1], ``l2`` divides by the L2 norm. A zero divisor becomes 1; with
    ``eps > 0`` the divisor is at least ``eps``."""
    if mode not in NORM_MODES:
        raise ValueError(f"Unknown normalization mode {mode!r}")
    as_numpy = not isinstance(mat, torch.Tensor)
    if as_numpy:
        mat = torch.from_numpy(np.asarray(mat.todense() if sp.issparse(mat) else mat,
                                          np.float32))
    mat = mat.to(torch.float32)
    if mode == "normalize":
        denom = mat.sum(dim=axis, keepdim=True)
    elif mode == "standardize":
        denom = mat.std(dim=axis, keepdim=True, correction=0)
        mat = mat - mat.mean(dim=axis, keepdim=True)
    elif mode == "minmax":
        mat = mat - mat.amin(dim=axis, keepdim=True)
        denom = mat.amax(dim=axis, keepdim=True)
    else:
        denom = torch.sqrt((mat ** 2).sum(dim=axis, keepdim=True))
    denom = torch.where(denom == 0, 1.0, denom)
    if eps > 0:
        denom = denom.clamp(min=eps)
    out = mat / denom
    return out.numpy() if as_numpy else out


def dist_to_rbf(dist, denom: float = 1.0) -> np.ndarray:
    """The RBF affinity ``exp(-d² / σ²)`` of a distance matrix, ``σ²`` the
    mean of ``d²`` times ``denom`` (floored at 1e-12), in float32 on the CPU;
    numpy in, numpy out (counterpart: matrix.py:70)."""
    d2 = torch.as_tensor(np.asarray(dist, np.float32)) ** 2
    sigma2 = torch.clamp(d2.mean() * denom, min=1e-12)
    return torch.exp(-d2 / sigma2).numpy()


def _pearson_pdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``1 - xn ynᵀ`` of the centred rows over their norms clamped at 1e-12
    (counterpart: matrix.py:75)."""
    def unit(m):
        m = m - m.mean(1, keepdim=True)
        return m / torch.clamp(torch.linalg.vector_norm(m, dim=1, keepdim=True), min=1e-12)
    return 1.0 - unit(x) @ unit(y).T


def _rankdata(x: torch.Tensor) -> torch.Tensor:
    """Average-tie ranks along each row, 1-based, float32: ``(#{< v} +
    #{<= v} + 1) / 2`` (counterpart: matrix.py:84)."""
    sx = torch.sort(x, dim=1).values
    lo = torch.searchsorted(sx, x.contiguous(), side="left")
    hi = torch.searchsorted(sx, x.contiguous(), side="right")
    return (lo + hi + 1).to(torch.float32) / 2.0


def pairwise_distance(x, y=None, dist_func="euclidean", *, device=None) -> np.ndarray:
    """(n, m) distances between the rows of ``x`` and of ``y`` (default ``x``):
    ``"euclidean"`` (0) as ``sqrt(max(|a|² + |b|² - 2 a·b, 0))``, ``"pearson"``
    (1) as one less the correlation of the rows, ``"spearman"`` (2) as that of
    their average-tie ranks, all in float32; ``"cosine"`` as ``1 - a·b /
    (|a| |b|)`` clipped to [0, 2] (a zero row taken as norm 1) and
    ``"correlation"`` as ``1 - ac·bc / (|ac| |bc|)`` of the rows less their
    means (NaN for a constant row, as scipy gives it), both in float64 with
    the diagonal set to 0 when ``y`` is None, as scikit-learn's
    ``pairwise_distances`` gives them."""
    if dist_func in ("euclidean", 0, "pearson", 1, "spearman", 2):
        x = torch.as_tensor(np.asarray(x, np.float32), device=device)
        y = x if y is None else torch.as_tensor(np.asarray(y, np.float32), device=device)
        if dist_func in ("pearson", 1):
            return _pearson_pdist(x, y).cpu().numpy()
        if dist_func in ("spearman", 2):
            return _pearson_pdist(_rankdata(x), _rankdata(y)).cpu().numpy()
        d2 = (x ** 2).sum(1)[:, None] + (y ** 2).sum(1)[None, :] - 2 * (x @ y.T)
        return torch.sqrt(d2.clamp(min=0.0)).cpu().numpy()
    if dist_func not in ("cosine", "correlation"):
        raise ValueError(f"Unknown dist_func {dist_func!r}, options: euclidean|pearson|"
                         f"spearman|cosine|correlation")
    same = y is None
    a = torch.as_tensor(np.asarray(x, np.float64), device=device)
    b = a if same else torch.as_tensor(np.asarray(y, np.float64), device=device)
    cosine = dist_func == "cosine"
    if not cosine:
        a, b = a - a.mean(1, keepdim=True), b - b.mean(1, keepdim=True)

    def unit(m):
        norm = torch.linalg.vector_norm(m, dim=1, keepdim=True)
        return m / (torch.where(norm == 0, 1.0, norm) if cosine else norm)
    d = 1.0 - unit(a) @ unit(b).T
    d = d.clamp(0.0, 2.0) if cosine else d
    if same:
        d.fill_diagonal_(0.0)
    return d.cpu().numpy()


def euclidean_distance(t1, t2) -> float:
    """Euclidean distance of two vectors (counterpart: matrix.py:127)."""
    return float(np.sqrt(np.sum((np.asarray(t1) - np.asarray(t2)) ** 2)))


def pearson_distance(a, b) -> float:
    """One less the Pearson correlation, in float64 (counterpart: matrix.py:132)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ac, bc = a - a.mean(), b - b.mean()
    denom = np.sqrt((ac ** 2).sum() * (bc ** 2).sum())
    return float(1.0 - (ac @ bc) / max(denom, 1e-300))


def mean_rank_data(x) -> np.ndarray:
    """Average-tie ranks, 1-based, scipy's ``"average"`` (counterpart: matrix.py:140)."""
    x = np.asarray(x)
    sx = np.sort(x)
    lo = np.searchsorted(sx, x, side="left")
    hi = np.searchsorted(sx, x, side="right")
    return (lo + hi + 1) / 2.0


def spearman_distance(x, y) -> float:
    """One less the Spearman rank correlation (counterpart: matrix.py:149)."""
    if len(x) != len(y):
        raise ValueError("x and y must have the same length")
    return pearson_distance(mean_rank_data(x), mean_rank_data(y))


__all__ = ["NORM_MODES", "dist_to_rbf", "euclidean_distance", "mean_rank_data", "normalize",
           "pairwise_distance", "pearson_distance", "spearman_distance"]
