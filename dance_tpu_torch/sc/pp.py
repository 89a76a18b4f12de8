"""scanpy-style preprocessing on arrays: the cores of ``filter_cells``,
``filter_genes``, ``normalize_total``, ``normalize_per_cell``, ``log1p``,
``scale`` and ``highly_variable_genes`` with the ``cell_ranger`` and
``seurat_v3`` flavours (counterparts: dance_tpu/sc/pp.py:33-92, 118-169,
171-203, 209-249, 298-380), and ``normalized_counts``, the chain of them that
scTAG's and scDSC's pipelines share.

The JAX package's versions read and write an ``AnnData`` (pandas frames);
the card has no pandas, so these take a cells x genes numpy or scipy matrix
and return masks and new arrays. The arithmetic is the JAX package's, in the
same order, so the results agree bit for bit; ``pd.cut`` and the per-bin
``groupby`` medians of cell_ranger are written out in numpy. Where the JAX
version writes a column to ``obs`` or ``var`` (``n_counts``, ``mean``,
``std``), the port returns it. The ``seurat`` flavour and batches are not
ported yet (ROADMAP Queue 1).
"""

from typing import Dict, Optional

import numpy as np
import scipy.sparse as sp

from dance_tpu_torch.settings import logger


def _dense(x):
    return x.toarray() if sp.issparse(x) else np.asarray(x)


def _row_sums(x) -> np.ndarray:
    return np.asarray(x.sum(axis=1)).ravel()


def _col_sums(x) -> np.ndarray:
    return np.asarray(x.sum(axis=0)).ravel()


def _one_threshold(names, values):
    if sum(v is not None for v in values) != 1:
        raise ValueError(f"Provide exactly one of {'/'.join(names)}")


def filter_cells(x, *, min_counts: Optional[int] = None, min_genes: Optional[int] = None,
                 max_counts: Optional[int] = None, max_genes: Optional[int] = None):
    """Cells passing one count or gene-number threshold (counterpart:
    pp.py:33, ``inplace=False``). Returns ``(mask, metric)``: the kept cells
    and each cell's total counts or number of expressed genes."""
    _one_threshold(("min_counts", "min_genes", "max_counts", "max_genes"),
                   (min_counts, min_genes, max_counts, max_genes))
    if min_counts is not None or max_counts is not None:
        metric = _row_sums(x)
    else:
        metric = _row_sums(x > 0) if sp.issparse(x) else (np.asarray(x) > 0).sum(1)
    if min_counts is not None:
        return metric >= min_counts, metric
    if max_counts is not None:
        return metric <= max_counts, metric
    if min_genes is not None:
        return metric >= min_genes, metric
    return metric <= max_genes, metric


def filter_genes(x, *, min_counts: Optional[int] = None, min_cells: Optional[int] = None,
                 max_counts: Optional[int] = None, max_cells: Optional[int] = None):
    """Genes passing one count or cell-number threshold (counterpart:
    pp.py:65, ``inplace=False``). Returns ``(mask, metric)``."""
    _one_threshold(("min_counts", "min_cells", "max_counts", "max_cells"),
                   (min_counts, min_cells, max_counts, max_cells))
    if min_counts is not None or max_counts is not None:
        metric = _col_sums(x)
    else:
        metric = _col_sums(x > 0) if sp.issparse(x) else (np.asarray(x) > 0).sum(0)
    if min_counts is not None:
        return metric >= min_counts, metric
    if max_counts is not None:
        return metric <= max_counts, metric
    if min_cells is not None:
        return metric >= min_cells, metric
    return metric <= max_cells, metric


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


def normalize_per_cell(x, *, counts_per_cell_after: Optional[float] = None,
                       min_counts: Optional[int] = 1):
    """Legacy scanpy ``normalize_per_cell`` (counterpart: pp.py:152): drop the
    cells under ``min_counts`` counts, then scale each cell to
    ``counts_per_cell_after`` counts (the mean of the kept cells' totals when
    None); float32, sparse stays sparse. Returns ``(x, kept, n_counts)``: the
    scaled matrix of the kept cells, the mask of the kept cells and their
    totals (``obs["n_counts"]`` in JAX)."""
    counts = _row_sums(x)
    kept = np.ones(x.shape[0], dtype=bool)
    if min_counts is not None and (counts < min_counts).any():
        kept = counts >= min_counts
        x = x[np.nonzero(kept)[0]]
        counts = counts[kept]
    target = counts_per_cell_after if counts_per_cell_after is not None else counts.mean()
    scale_ = target / np.maximum(counts, 1e-12)
    if sp.issparse(x):
        return (sp.diags(scale_) @ x).tocsr().astype(np.float32), kept, counts
    return (np.asarray(x) * scale_[:, None]).astype(np.float32), kept, counts


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


def scale(x, *, zero_center: bool = True, max_value: Optional[float] = None):
    """Per-gene standardization, dense (counterpart: pp.py:188): centre (with
    ``zero_center``), divide by the ``ddof=1`` standard deviation (1 where it
    is 0) and clip at ``max_value``, in float64. Returns ``(x, mean, std)``:
    float32 and the float64 ``var["mean"]`` and ``var["std"]``."""
    xd = _dense(x).astype(np.float64)
    mean = xd.mean(axis=0)
    std = xd.std(axis=0, ddof=1)
    std[std == 0] = 1.0
    if zero_center:
        xd = xd - mean
    xd /= std
    if max_value is not None:
        xd = np.clip(xd, -max_value if zero_center else None, max_value)
    return xd.astype(np.float32), mean, std


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


def _group_median(values: np.ndarray, groups: np.ndarray) -> np.ndarray:
    """Each element's group median (pandas ``groupby(...).transform("median")``
    over the observed groups; every value here is finite)."""
    out = np.empty_like(values)
    for grp in np.unique(groups):
        sel = groups == grp
        out[sel] = np.median(values[sel])
    return out


def _cell_ranger(x, n_top_genes: Optional[int], min_mean: float, max_mean: float,
                 min_disp: float, max_disp: float) -> Dict[str, np.ndarray]:
    """cell_ranger dispersions of log data (counterpart: pp.py:298-346): the
    dispersion var/mean of ``expm1(x)`` is normalised by the median and MAD
    of its bin of means; the bins are the 10th, 15th, ..., 100th percentiles
    with -inf and +inf at the ends, right-closed as ``pd.cut`` cuts them."""
    xe = x.copy()
    if sp.issparse(xe):
        xe.data = np.expm1(xe.data)
    else:
        xe = np.expm1(np.asarray(xe, dtype=np.float64))
    mean = np.asarray(xe.mean(axis=0)).ravel()
    if sp.issparse(xe):
        mean_sq = np.asarray(xe.multiply(xe).mean(axis=0)).ravel()
    else:
        mean_sq = np.asarray((xe ** 2).mean(axis=0)).ravel()
    n = x.shape[0]
    var = (mean_sq - mean ** 2) * (n / max(n - 1, 1))
    mean[mean == 0] = 1e-12
    dispersion = var / mean
    edges = np.r_[-np.inf, np.percentile(mean, np.arange(10, 105, 5)), np.inf]
    if not (np.diff(edges) > 0).all():
        raise ValueError(f"Bin edges must be unique: {edges!r}")
    bins = np.searchsorted(edges, mean, side="left") - 1  # (e_i, e_i+1] -> i
    bin_median = _group_median(dispersion, bins)
    bin_mad = _group_median(np.abs(dispersion - bin_median), bins)
    with np.errstate(divide="ignore", invalid="ignore"):
        disp_norm = (dispersion - bin_median) / np.where(bin_mad == 0, np.nan, bin_mad)
    disp_norm = np.where(np.isnan(disp_norm), 0.0, disp_norm).astype(dispersion.dtype)
    if n_top_genes is not None:
        cut = np.sort(disp_norm[~np.isnan(disp_norm)])[::-1][
            min(n_top_genes, np.isfinite(disp_norm).sum()) - 1]
        hv = disp_norm >= cut
    else:
        hv = ((mean > min_mean) & (mean < max_mean)
              & (disp_norm > min_disp) & (disp_norm < max_disp))
    return {"highly_variable": hv, "means": mean, "dispersions": dispersion,
            "dispersions_norm": disp_norm}


def highly_variable_genes(x, *, flavor: str = "seurat_v3", n_top_genes: Optional[int] = None,
                          min_mean: float = 0.0125, max_mean: float = 3.0,
                          min_disp: float = 0.5, max_disp: float = np.inf, span: float = 0.3,
                          check_values: bool = True) -> Dict[str, np.ndarray]:
    """Highly variable genes of a cells x genes matrix (counterpart:
    pp.py:252-390), each result (n_genes,).

    - ``seurat_v3`` (raw counts): a loess trend of log10 variance on log10
      mean, then each gene's variance of counts standardised by that trend
      and clipped at sqrt(n); the ``n_top_genes`` largest (default 2000) are
      kept. Returns ``highly_variable``, ``means``, ``variances`` and
      ``variances_norm``. Densifies ``x`` in float64, as the JAX package does
      (about 5 x 8 bytes per entry at the peak).
    - ``cell_ranger`` (log data): see :func:`_cell_ranger`; the genes at or
      above the ``n_top_genes``-th normalised dispersion, or without
      ``n_top_genes`` those inside the mean and dispersion cut-offs. Returns
      ``highly_variable``, ``means``, ``dispersions`` and ``dispersions_norm``.

    The JAX package's default flavour ``seurat`` is not ported yet."""
    if flavor == "cell_ranger":
        return _cell_ranger(x, n_top_genes, min_mean, max_mean, min_disp, max_disp)
    if flavor != "seurat_v3":
        raise NotImplementedError(f"HVG flavor {flavor!r} is not ported yet; only "
                                  f"'seurat_v3' and 'cell_ranger' (ROADMAP Queue 1)")
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


def normalized_counts(counts, n_top_genes: int):
    """The count processing that scTAG's and scDSC's pipelines share
    (sctag.py:93-105, scdsc.py:120-131): genes under 3 counts and cells
    without counts dropped, ``normalize_per_cell``, ``log1p``, the
    ``n_top_genes`` cell_ranger HVGs kept, genes and cells without counts
    dropped; that matrix is the ZINB target (``SaveRaw``), and the features are
    it after ``normalize_total``, ``log1p`` and ``scale``. Returns ``(x, x_raw,
    n_counts, cells)``: dense float32 features and target, the cells' totals
    as the last ``filter_cells`` writes them (``obs["n_counts"]``), and the
    indices of the kept cells."""
    x = sp.csr_matrix(counts, dtype=np.float32) if sp.issparse(counts) \
        else np.asarray(counts, np.float32)
    genes, _ = filter_genes(x, min_counts=3)
    x = x[:, np.nonzero(genes)[0]]
    kept, _ = filter_cells(x, min_counts=1)
    cells = np.nonzero(kept)[0]
    x, kept, _ = normalize_per_cell(x[cells])
    cells = cells[kept]
    x = log1p(x)
    hv = highly_variable_genes(x, flavor="cell_ranger", n_top_genes=n_top_genes,
                               min_mean=0.0125, max_mean=4, min_disp=0.5)["highly_variable"]
    x = x[:, np.nonzero(hv)[0]]
    genes, _ = filter_genes(x, min_counts=1)
    x = x[:, np.nonzero(genes)[0]]
    kept, n_counts = filter_cells(x, min_counts=1)
    x, cells, n_counts = x[np.nonzero(kept)[0]], cells[kept], n_counts[kept]
    x_raw = np.asarray(x.toarray() if sp.issparse(x) else x, np.float32)
    x, _, _ = scale(log1p(normalize_total(x)))
    return x, x_raw, n_counts, cells


__all__ = ["filter_cells", "filter_genes", "highly_variable_genes", "log1p",
           "normalize_per_cell", "normalize_total", "normalized_counts", "scale"]
