"""Matrix normalization, pairwise distances and the RBF affinity
(counterpart: ``normalize``, ``dist_to_rbf``, ``pairwise_distance`` and
``_euclidean_pdist``, dance_tpu/utils/matrix.py:19-74, 64-118).

``normalize`` takes a tensor and returns one on the same device, or a numpy
array or scipy matrix and returns a numpy array (computed on the CPU), as the
JAX version returns what it was given. ``pairwise_distance`` takes and
returns host numpy, as in the JAX package. Its Euclidean metric is computed
in float32 (the JAX package pins ``Precision.HIGHEST`` for the same
full-precision product); its ``"cosine"`` and ``"correlation"`` metrics are
scikit-learn's ``pairwise_distances`` ones, in float64, which the JAX
package's EfNST calls (EfNST.py:214-272). The Pearson and Spearman metrics
(:75-101) are not ported yet and raise. The arithmetic runs on the CPU unless
a ``device`` is named.
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


def pairwise_distance(x, y=None, dist_func="euclidean", *, device=None) -> np.ndarray:
    """(n, m) distances between the rows of ``x`` and of ``y`` (default ``x``):
    ``"euclidean"`` as ``sqrt(max(|a|² + |b|² - 2 a·b, 0))`` in float32;
    ``"cosine"`` as ``1 - a·b / (|a| |b|)`` clipped to [0, 2] (a zero row
    taken as norm 1) and ``"correlation"`` as ``1 - ac·bc / (|ac| |bc|)`` of
    the rows less their means (NaN for a constant row, as scipy gives it),
    both in float64 with the diagonal set to 0 when ``y`` is None, as
    scikit-learn's ``pairwise_distances`` gives them."""
    if dist_func in ("euclidean", 0):
        x = torch.as_tensor(np.asarray(x, np.float32), device=device)
        y = x if y is None else torch.as_tensor(np.asarray(y, np.float32), device=device)
        d2 = (x ** 2).sum(1)[:, None] + (y ** 2).sum(1)[None, :] - 2 * (x @ y.T)
        return torch.sqrt(d2.clamp(min=0.0)).cpu().numpy()
    if dist_func not in ("cosine", "correlation"):
        raise NotImplementedError(f"dist_func {dist_func!r} is not ported yet; 'euclidean', "
                                  f"'cosine' and 'correlation' are (ROADMAP Queue 1)")
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


__all__ = ["NORM_MODES", "dist_to_rbf", "normalize", "pairwise_distance"]
