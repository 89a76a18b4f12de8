"""scanpy-style preprocessing on arrays: the cores of ``normalize_total``,
``log1p`` and ``highly_variable_genes(flavor="seurat_v3")`` with its loess
trend (counterparts: dance_tpu/sc/pp.py:118-149, 171-185, 209-249, 347-380).

The JAX package's versions read and write an ``AnnData`` (pandas frames);
the card has no pandas, so these take a cells x genes numpy or scipy matrix
and return new arrays. The arithmetic is the JAX package's, in the same
order, so the results agree bit for bit. Other HVG flavours, batches and
``normalize_per_cell``/``scale`` are not ported yet (ROADMAP Queue 1).
"""

from typing import Dict, Optional

import numpy as np
import scipy.sparse as sp

from dance_tpu_torch.settings import logger


def _dense(x):
    return x.toarray() if sp.issparse(x) else np.asarray(x)


def _row_sums(x) -> np.ndarray:
    return np.asarray(x.sum(axis=1)).ravel()


def normalize_total(x, *, target_sum: Optional[float] = None,
                    exclude_highly_expressed: bool = False, max_fraction: float = 0.05):
    """Scale each cell to ``target_sum`` counts (the median of the cell totals
    when None); float32, sparse stays sparse (counterpart: pp.py:118)."""
    counts = _row_sums(x)
    if exclude_highly_expressed:
        # genes taking > max_fraction of any cell's counts are left out of the
        # size factors (but still scaled)
        if sp.issparse(x):
            frac = x.multiply(1.0 / np.maximum(counts, 1e-12)[:, None]).tocsc()
            hi = np.asarray((frac > max_fraction).sum(axis=0)).ravel() > 0
            counts = _row_sums(x[:, np.nonzero(~hi)[0]])
        else:
            frac = np.asarray(x) / np.maximum(counts, 1e-12)[:, None]
            hi = (frac > max_fraction).any(axis=0)
            counts = _row_sums(x[:, ~hi])
        logger.info("normalize_total excluded %d highly-expressed genes", int(hi.sum()))
    tsum = np.median(counts[counts > 0]) if target_sum is None else target_sum
    scale = np.divide(tsum, counts, out=np.ones_like(counts, dtype=np.float64),
                      where=counts > 0)
    if sp.issparse(x):
        return (sp.diags(scale) @ x).tocsr().astype(np.float32)
    return (np.asarray(x, dtype=np.float64) * scale[:, None]).astype(np.float32)


def log1p(x, *, base: Optional[float] = None):
    """``log(1 + x)``, divided by ``log(base)`` when given (counterpart: pp.py:171)."""
    if sp.issparse(x):
        x = x.copy()
        x.data = np.log1p(x.data)
        if base is not None:
            x.data /= np.log(base)
        return x
    out = np.log1p(np.asarray(x))
    if base is not None:
        out /= np.log(base)
    return out.astype(np.float32)


def _loess(x: np.ndarray, y: np.ndarray, *, span: float = 0.3, degree: int = 2,
           block: int = 2048) -> np.ndarray:
    """Loess smoother, local weighted polynomial regression with tricube
    weights over the ``span`` nearest points (counterpart: pp.py:209). For
    sorted x those are a window found by a two-pointer sweep; the weighted
    least-squares solves run in batches of normal equations centred on each
    query point, whose intercept is the prediction."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = len(x)
    k = min(max(int(np.ceil(span * n)), degree + 2), n)
    order = np.argsort(x, kind="stable")
    xs, ys = x[order], y[order]
    starts = np.empty(n, np.int64)
    lo = 0
    for i in range(n):
        while lo + k < n and xs[lo + k] - xs[i] < xs[i] - xs[lo]:
            lo += 1
        starts[i] = lo
    idx = starts[:, None] + np.arange(k)[None]
    out = np.empty(n)
    eye = 1e-10 * np.eye(degree + 1)
    for s in range(0, n, block):
        sl = slice(s, min(s + block, n))
        xw, yw = xs[idx[sl]], ys[idx[sl]]
        xc = xw - xs[sl, None]
        dist = np.abs(xc)
        dmax = dist.max(1, keepdims=True)
        dmax[dmax == 0] = 1.0
        w = (1 - np.minimum(dist / dmax, 1.0) ** 3) ** 3
        a = np.stack([xc ** p for p in range(degree + 1)], axis=-1)
        aw = a * w[..., None]
        gram = np.einsum("bki,bkj->bij", aw, a) + eye
        rhs = np.einsum("bki,bk->bi", aw, yw)
        out[sl] = np.linalg.solve(gram, rhs[..., None])[:, 0, 0]
    res = np.empty(n)
    res[order] = out
    return res


def highly_variable_genes(x, *, flavor: str = "seurat_v3", n_top_genes: Optional[int] = None,
                          span: float = 0.3, check_values: bool = True) -> Dict[str, np.ndarray]:
    """Highly variable genes of raw counts by scanpy's ``seurat_v3`` rule
    (counterpart: pp.py:347-380): a loess trend of log10 variance on log10
    mean, then each gene's variance of counts standardised by that trend and
    clipped at sqrt(n); the ``n_top_genes`` largest (default 2000) are kept.

    Returns ``highly_variable``, ``means``, ``variances`` and
    ``variances_norm``, each (n_genes,). Densifies ``x`` in float64, as the
    JAX package does (about 5 x 8 bytes per entry at the peak)."""
    if flavor != "seurat_v3":
        raise NotImplementedError(f"HVG flavor {flavor!r} is not ported yet; only "
                                  f"'seurat_v3' (ROADMAP Queue 1)")
    if n_top_genes is None:
        n_top_genes = 2000
    if check_values:
        sample = x.data[:100] if sp.issparse(x) else np.asarray(x).ravel()[:1000]
        if not np.allclose(sample, np.round(sample)):
            logger.warning("`flavor='seurat_v3'` expects raw count data, but non-integers "
                           "were found.")
    mean = np.asarray(x.mean(axis=0)).ravel()
    if sp.issparse(x):
        mean_sq = np.asarray(x.multiply(x).mean(axis=0)).ravel()
    else:
        mean_sq = np.asarray((np.asarray(x) ** 2).mean(axis=0)).ravel()
    n = x.shape[0]
    var = (mean_sq - mean ** 2) * (n / max(n - 1, 1))
    not_const = var > 0
    est_var = np.zeros_like(var)
    est_var[not_const] = 10 ** _loess(np.log10(mean[not_const]), np.log10(var[not_const]),
                                      span=span, degree=2)
    std_expect = np.sqrt(est_var)
    clip = np.sqrt(n)
    with np.errstate(divide="ignore", invalid="ignore"):
        xd = _dense(x).astype(np.float64)
        zs = np.where(std_expect > 0, (xd - mean) / np.where(std_expect == 0, 1, std_expect),
                      0.0)
        std_var = (np.clip(zs, -clip, clip) ** 2).sum(0) / (n - 1)
    rank = np.argsort(np.argsort(-std_var))
    return {"highly_variable": rank < n_top_genes, "means": mean, "variances": var,
            "variances_norm": std_var}


__all__ = ["highly_variable_genes", "log1p", "normalize_total"]
