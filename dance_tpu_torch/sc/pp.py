"""scanpy-style preprocessing on arrays (counterpart: dance_tpu/sc/pp.py):
the filters, ``normalize_total``, ``normalize_per_cell``, ``log1p``,
``scale``, ``highly_variable_genes`` with its three flavours and batches,
``calculate_qc_metrics``, ``neighbors``, ``pca``, ``regress_out``,
``combat``, ``scrublet`` and ``subsample``, and ``normalized_counts``, the
chain that scTAG's and scDSC's pipelines share.

The JAX package's versions read and write an ``AnnData`` (pandas frames);
the card has no pandas, so these take a cells x genes numpy or scipy matrix
(and label arrays where JAX reads ``obs``) and return masks, dicts and new
arrays. The host steps keep the JAX package's arithmetic in the same order,
so the results agree bit for bit; ``pd.cut`` and the per-bin ``groupby``
statistics are written out in numpy. Where the JAX version writes a column
to ``obs`` or ``var`` (``n_counts``, ``mean``, ``std``), the port returns it.
``combat``, ``regress_out``, the PCA, the kNN and Scrublet's arithmetic run
on ``device`` (the CUDA card unless the CPU is named), in float64 where JAX
computes in float64; the random draws stay numpy draws with JAX's seeds.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from dance_tpu_torch.settings import logger
from dance_tpu_torch.utils import resolve_device


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


def size_factors(x, *, target_sum: Optional[float] = None,
                 exclude_highly_expressed: bool = False,
                 max_fraction: float = 0.05) -> Tuple[np.ndarray, float]:
    """:func:`normalize_total`'s cell totals and the total it scales them to:
    ``(counts, tsum)``; ``counts / tsum`` is JAX's ``obs[key_added]``."""
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
    return counts, (np.median(counts[counts > 0]) if target_sum is None else target_sum)


def normalize_total(x, *, target_sum: Optional[float] = None,
                    exclude_highly_expressed: bool = False, max_fraction: float = 0.05):
    """Scale each cell to ``target_sum`` counts (the median of the cell totals
    when None); float32, sparse stays sparse (counterpart: pp.py:118)."""
    counts, tsum = size_factors(x, target_sum=target_sum,
                                exclude_highly_expressed=exclude_highly_expressed,
                                max_fraction=max_fraction)
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


def _dispersions(x) -> Tuple[np.ndarray, np.ndarray]:
    """Mean and dispersion var/mean (``ddof=1``) of ``expm1(x)`` per gene, a
    zero mean set to 1e-12 first (counterpart: pp.py:298-312)."""
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
    return mean, var / mean


def _select(disp_norm, mean, n_top_genes, min_mean, max_mean, min_disp, max_disp):
    """The genes at or above the ``n_top_genes``-th normalised dispersion, or
    without ``n_top_genes`` those inside the cut-offs (counterpart:
    pp.py:337-344)."""
    if n_top_genes is not None:
        cut = np.sort(disp_norm[~np.isnan(disp_norm)])[::-1][
            min(n_top_genes, np.isfinite(disp_norm).sum()) - 1]
        return disp_norm >= cut
    return ((mean > min_mean) & (mean < max_mean)
            & (disp_norm > min_disp) & (disp_norm < max_disp))


def _cell_ranger(x, n_top_genes: Optional[int], min_mean: float, max_mean: float,
                 min_disp: float, max_disp: float) -> Dict[str, np.ndarray]:
    """cell_ranger dispersions of log data (counterpart: pp.py:298-346): the
    dispersion var/mean of ``expm1(x)`` is normalised by the median and MAD
    of its bin of means; the bins are the 10th, 15th, ..., 100th percentiles
    with -inf and +inf at the ends, right-closed as ``pd.cut`` cuts them."""
    mean, dispersion = _dispersions(x)
    edges = np.r_[-np.inf, np.percentile(mean, np.arange(10, 105, 5)), np.inf]
    if not (np.diff(edges) > 0).all():
        raise ValueError(f"Bin edges must be unique: {edges!r}")
    bins = np.searchsorted(edges, mean, side="left") - 1  # (e_i, e_i+1] -> i
    bin_median = _group_median(dispersion, bins)
    bin_mad = _group_median(np.abs(dispersion - bin_median), bins)
    with np.errstate(divide="ignore", invalid="ignore"):
        disp_norm = (dispersion - bin_median) / np.where(bin_mad == 0, np.nan, bin_mad)
    disp_norm = np.where(np.isnan(disp_norm), 0.0, disp_norm).astype(dispersion.dtype)
    hv = _select(disp_norm, mean, n_top_genes, min_mean, max_mean, min_disp, max_disp)
    return {"highly_variable": hv, "means": mean, "dispersions": dispersion,
            "dispersions_norm": disp_norm}


def _cut(values: np.ndarray, n_bins: int) -> np.ndarray:
    """Each value's bin under ``pd.cut(values, bins=n_bins)``: ``n_bins``
    equal-width bins over [min, max], the left edge lowered by 0.1 % of the
    range (by 0.1 % of each end when the range is empty), right-closed."""
    mn, mx = np.nanmin(values), np.nanmax(values)
    if mn == mx:
        mn -= 0.001 * abs(mn) if mn != 0 else 0.001
        mx += 0.001 * abs(mx) if mx != 0 else 0.001
        edges = np.linspace(mn, mx, n_bins + 1, endpoint=True)
    else:
        edges = np.linspace(mn, mx, n_bins + 1, endpoint=True)
        edges[0] -= (mx - mn) * 0.001
    return np.searchsorted(edges, values, side="left") - 1  # (e_i, e_i+1] -> i


def _group_mean_std(values: np.ndarray, groups: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Each element's group mean and ``ddof=1`` std over the group's non-NaN
    values, as pandas' ``groupby(...).transform("mean"/"std")`` computes them
    (a compensated sum in the values' dtype; Welford's updates in float64):
    NaN for a group without values, the std NaN for a group of one."""
    dt = values.dtype.type
    mean = np.full_like(values, np.nan)
    std = np.full_like(values, np.nan)
    for grp in np.unique(groups):
        sel = groups == grp
        vals = values[sel]
        vals = vals[~np.isnan(vals)]
        total, comp = dt(0), dt(0)
        n, run, m2 = 0, 0.0, 0.0
        for v in vals:
            y = v - comp
            t = total + y
            comp = (t - total) - y
            total = t
            n += 1
            old = run
            run += (float(v) - old) / n
            m2 += (float(v) - run) * (float(v) - old)
        if n:
            mean[sel] = total / dt(n)
        if n > 1:
            std[sel] = np.sqrt(m2 / (n - 1))
    return mean, std


def _seurat(x, n_top_genes: Optional[int], min_mean: float, max_mean: float, min_disp: float,
            max_disp: float, n_bins: int) -> Dict[str, np.ndarray]:
    """seurat dispersions of log data (counterpart: pp.py:298-327): the log
    dispersion of ``expm1(x)`` (a zero dispersion is NaN) z-scored within
    ``n_bins`` equal-width bins of the log1p means; where a bin's std is 0
    or NaN (one gene), the dispersion less the bin's mean."""
    mean, dispersion = _dispersions(x)
    dispersion[dispersion == 0] = np.nan
    with np.errstate(divide="ignore", invalid="ignore"):
        dispersion = np.log(dispersion)
    mean = np.log1p(mean)
    bin_mean, bin_std = _group_mean_std(dispersion, _cut(mean, n_bins))
    bin_std = np.where(np.isnan(bin_std), 0.0, bin_std)
    centred = dispersion - bin_mean
    with np.errstate(divide="ignore", invalid="ignore"):
        disp_norm = centred / np.where(bin_std == 0, np.nan, bin_std)
    disp_norm = np.where(np.isnan(disp_norm), centred, disp_norm)
    with np.errstate(invalid="ignore"):
        hv = _select(disp_norm, mean, n_top_genes, min_mean, max_mean, min_disp, max_disp)
    return {"highly_variable": hv, "means": mean, "dispersions": dispersion,
            "dispersions_norm": disp_norm}


def _seurat_v3(x, n_top_genes: Optional[int], span: float,
               check_values: bool) -> Dict[str, np.ndarray]:
    """seurat_v3 standardised variances of counts (counterpart: pp.py:347-380)."""
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


def highly_variable_genes(x, *, flavor: str = "seurat", n_top_genes: Optional[int] = None,
                          min_mean: float = 0.0125, max_mean: float = 3.0,
                          min_disp: float = 0.5, max_disp: float = np.inf, n_bins: int = 20,
                          span: float = 0.3, batch_key=None,
                          check_values: bool = True) -> Dict[str, np.ndarray]:
    """Highly variable genes of a cells x genes matrix (counterpart:
    pp.py:252-390), each result (n_genes,).

    - ``seurat`` (the default; log data): see :func:`_seurat`. Returns
      ``highly_variable``, ``means``, ``dispersions`` and
      ``dispersions_norm``; the genes at or above the ``n_top_genes``-th
      normalised dispersion, or without ``n_top_genes`` those inside the mean
      (of log1p) and dispersion cut-offs.
    - ``cell_ranger`` (log data): see :func:`_cell_ranger`; the same keys and
      selection.
    - ``seurat_v3`` (raw counts): a loess trend of log10 variance on log10
      mean, then each gene's variance of counts standardised by that trend
      and clipped at sqrt(n); the ``n_top_genes`` largest (default 2000) are
      kept. Returns ``highly_variable``, ``means``, ``variances`` and
      ``variances_norm``. Densifies ``x`` in float64, as the JAX package does
      (about 5 x 8 bytes per entry at the peak).

    ``batch_key`` is the cells' batch labels (what JAX reads from
    ``obs[batch_key]``): the flavour runs on each batch alone, the genes are
    ranked by the number of batches that keep them, then by their summed
    normalised dispersion (NaN as 0; ``np.lexsort``, ties by gene index),
    and the first ``n_top_genes`` (without it, every gene some batch keeps)
    are kept. Returns ``highly_variable`` and ``highly_variable_nbatches``."""
    if batch_key is not None:
        batches = np.asarray(batch_key)
        n_batches_hv = np.zeros(x.shape[1])
        disp_sum = np.zeros(x.shape[1])
        for b in np.unique(batches):
            res = highly_variable_genes(x[np.nonzero(batches == b)[0]], flavor=flavor,
                                        n_top_genes=n_top_genes, min_mean=min_mean,
                                        max_mean=max_mean, min_disp=min_disp,
                                        max_disp=max_disp, n_bins=n_bins, span=span)
            n_batches_hv += res["highly_variable"].astype(float)
            key = "dispersions_norm" if "dispersions_norm" in res else "variances_norm"
            disp_sum += np.nan_to_num(res[key])
        order = np.lexsort((-disp_sum, -n_batches_hv))
        hv = np.zeros(x.shape[1], dtype=bool)
        k = n_top_genes if n_top_genes is not None else int((n_batches_hv > 0).sum())
        hv[order[:k]] = True
        return {"highly_variable": hv, "highly_variable_nbatches": n_batches_hv}
    if flavor == "seurat":
        return _seurat(x, n_top_genes, min_mean, max_mean, min_disp, max_disp, n_bins)
    if flavor == "cell_ranger":
        return _cell_ranger(x, n_top_genes, min_mean, max_mean, min_disp, max_disp)
    if flavor == "seurat_v3":
        return _seurat_v3(x, n_top_genes, span, check_values)
    raise ValueError(f"Unknown flavor {flavor!r}")


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


# --------------------------------------------------------------------------
# QC, graphs, batch correction, doublets, subsampling (counterpart:
# pp.py:397-555)
# --------------------------------------------------------------------------

def calculate_qc_metrics(x, *, percent_top=(50, 100, 200, 500), device="auto"):
    """Per-cell and per-gene QC (counterpart: pp.py:397). Returns ``(obs,
    var)``, dicts of (n_cells,) and (n_genes,) arrays: ``n_genes_by_counts``,
    ``total_counts`` and ``pct_counts_in_top_{N}_genes`` (the share of a
    cell's counts in its N largest genes, in percent, for each N of
    ``percent_top`` up to the gene count); ``n_cells_by_counts``,
    ``total_counts`` and ``mean_counts``. The counts are the JAX package's
    host sums; the top-N shares sort each cell's genes on ``device`` and
    sum them in float64 (JAX: float32 cumulative sums)."""
    obs = {"n_genes_by_counts": np.asarray((x > 0).sum(axis=1)).ravel(),
           "total_counts": _row_sums(x)}
    tops = sorted(int(t) for t in percent_top or () if t <= x.shape[1])
    if tops:
        dense = torch.as_tensor(np.asarray(_dense(x))).to(resolve_device(device))
        part = torch.topk(dense, max(tops), dim=1).values.to(torch.float64)
        csum = torch.cumsum(part, dim=1).cpu().numpy()
        denom = np.maximum(obs["total_counts"], 1e-12)
        for t in tops:
            obs[f"pct_counts_in_top_{t}_genes"] = csum[:, t - 1] / denom * 100.0
    total = _col_sums(x)
    var = {"n_cells_by_counts": np.asarray((x > 0).sum(axis=0)).ravel(),
           "total_counts": total, "mean_counts": total / x.shape[0]}
    return obs, var


def neighbors(rep, *, n_neighbors: int = 15, n_pcs: Optional[int] = None,
              device="auto") -> Tuple[sp.csr_matrix, sp.csr_matrix]:
    """The kNN graph of the rows of ``rep`` (the PCA where JAX finds
    ``X_pca``; counterpart: pp.py:421), self included: ``(distances,
    connectivities)``, (n, n) scipy CSR. The connectivities are
    ``exp(-(d / d_k)²)`` over each cell's k-th distance ``d_k``, symmetrised
    by the maximum, without the diagonal. ``n_pcs`` keeps the first columns
    (JAX computes a PCA of that width when it has none:
    ``neighbors(pca(x, n_comps=n_pcs)[0])``). The kNN runs on ``device``."""
    from dance_tpu_torch.ops.neighbors import knn

    rep = np.asarray(_dense(rep))
    if n_pcs is not None:
        rep = rep[:, :n_pcs]
    d, i = knn(rep.astype(np.float32), n_neighbors, include_self=True,
               device=resolve_device(device))
    n = rep.shape[0]
    rows = np.repeat(np.arange(n), i.shape[1])
    dist = sp.csr_matrix((d.ravel(), (rows, i.ravel())), shape=(n, n))
    sigma = np.maximum(d[:, -1:], 1e-12)
    conn = sp.csr_matrix((np.exp(-((d / sigma) ** 2)).ravel(), (rows, i.ravel())), shape=(n, n))
    conn = conn.maximum(conn.T)
    conn.setdiag(0)
    conn.eliminate_zeros()
    return dist, conn


def pca(x, *, n_comps: int = 50, zero_center: bool = True, random_state: int = 0,
        device="auto"):
    """PCA of a cells x genes matrix in float32 on ``device`` (counterpart:
    pp.py:456): ``(X_pca, PCs, variance)``, the (n, k) embedding, the (genes,
    k) loadings and the (k,) explained variance, ``k = min(n_comps,
    min(x.shape) - 1)``; without ``zero_center`` the truncated SVD's
    embedding, and ``variance`` None."""
    from dance_tpu_torch.ops.linalg import pca as _pca, svd_embedding

    xt = torch.as_tensor(np.asarray(_dense(x), np.float32)).to(resolve_device(device))
    n_comps = min(n_comps, min(xt.shape) - 1)
    if zero_center:
        res = _pca(xt, n_comps, seed=random_state)
        return (res.embedding.cpu().numpy(), res.components.T.cpu().numpy(),
                res.explained_variance.cpu().numpy())
    emb, comps = svd_embedding(xt, n_comps, seed=random_state)
    return emb.cpu().numpy(), comps.T.cpu().numpy(), None


def _regress_out(xt: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``x - a β + β₀`` of :func:`regress_out`, in ``xt``'s dtype and device."""
    beta = torch.linalg.pinv(a) @ xt
    return xt - a @ beta + beta[0]


def regress_out(x, covariates, *, device="auto") -> np.ndarray:
    """Each gene with the least-squares fit on an intercept and the
    ``covariates`` removed (one (n_cells,) array, a list of them, or the
    columns of an (n_cells, p) array), the intercept kept (counterpart:
    pp.py:472, where the columns are ``obs`` keys), in float64 on
    ``device``; float32 out. The coefficients are the minimum-norm solution
    through the pseudo-inverse, as numpy's ``lstsq`` gives it, so a
    covariate collinear with the intercept (a constant) is handled as in
    JAX."""
    device = resolve_device(device)
    xt = torch.as_tensor(np.asarray(_dense(x), np.float64)).to(device)
    covs = covariates if isinstance(covariates, (list, tuple)) else [covariates]
    a = np.column_stack([np.ones(len(xt))] + [np.asarray(c, np.float64) for c in covs])
    return _regress_out(xt, torch.as_tensor(a).to(device)).cpu().numpy().astype(np.float32)


def _combat(xt: torch.Tensor, batches: np.ndarray) -> torch.Tensor:
    """:func:`combat` in ``xt``'s dtype and device."""
    grand_mean = xt.mean(0)
    grand_std = xt.std(0, correction=0)
    grand_std[grand_std == 0] = 1
    out = xt.clone()
    for b in np.unique(batches):
        m = torch.as_tensor(np.nonzero(batches == b)[0]).to(xt.device)
        xb = xt[m]
        bs = xb.std(0, correction=0)
        bs[bs == 0] = 1
        out[m] = (xb - xb.mean(0)) / bs * grand_std + grand_mean
    return out


def combat(x, batches, *, device="auto") -> np.ndarray:
    """Location/scale batch correction (counterpart: pp.py:484, JAX's
    simplified ComBat without empirical-Bayes shrinkage): each gene
    standardised within each batch (population std, 0 set to 1) and moved to
    the pooled mean and std (0 set to 1), in float64 on ``device``; float32
    out. ``batches`` is the cells' batch labels."""
    xt = torch.as_tensor(np.asarray(_dense(x), np.float64)).to(resolve_device(device))
    return _combat(xt, np.asarray(batches)).cpu().numpy().astype(np.float32)


def scrublet_pairs(n_cells: int, sim_doublet_ratio: float = 2.0,
                   random_state: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """The cell pairs whose sums are Scrublet's simulated doublets, numpy's
    draws from ``random_state`` as JAX makes them (pp.py:518-524)."""
    rng = np.random.default_rng(random_state)
    n_sim = int(n_cells * sim_doublet_ratio)
    return rng.integers(0, n_cells, n_sim), rng.integers(0, n_cells, n_sim)


def _scrublet_embedding(xt: torch.Tensor, i1: np.ndarray, i2: np.ndarray) -> torch.Tensor:
    """The observed cells (float64 counts ``xt``) and the doublets of the
    pairs ``(i1, i2)``, each normalised to 10⁴ and log1p'd in float64, in the
    observed cells' 30-d PCA (float32; the doublets projected), stacked."""
    from dance_tpu_torch.ops.linalg import pca as _pca, pca_transform

    norm = torch.log1p(xt / xt.sum(1, keepdim=True).clamp(min=1e-12) * 1e4)
    sim = xt[torch.as_tensor(i1).to(xt.device)] + xt[torch.as_tensor(i2).to(xt.device)]
    sim = torch.log1p(sim / sim.sum(1, keepdim=True).clamp(min=1e-12) * 1e4)
    res = _pca(norm.to(torch.float32), min(30, min(norm.shape) - 1))
    return torch.cat([res.embedding, pca_transform(sim.to(torch.float32), res)])


def _scrublet_knn(x, sim_doublet_ratio: float, n_neighbors: Optional[int], random_state: int,
                  device) -> Tuple[np.ndarray, int]:
    """The neighbours :func:`scrublet` scores by: each observed cell's
    ``k_adj`` nearest of the observed cells and the doublets of
    :func:`scrublet_pairs` in :func:`_scrublet_embedding`, besides itself,
    on ``device``. Returns ``(idx, k_adj)``, ``idx`` (cells, k_adj)."""
    from dance_tpu_torch.ops.neighbors import knn

    xt = torch.as_tensor(np.asarray(_dense(x), np.float64)).to(device)
    n = xt.shape[0]
    emb = _scrublet_embedding(xt, *scrublet_pairs(n, sim_doublet_ratio, random_state))
    k = max(n_neighbors or int(round(0.5 * np.sqrt(n))), 3)
    k_adj = int(round(k * (1 + sim_doublet_ratio)))
    _, idx = knn(emb.cpu().numpy(), min(k_adj, len(emb) - 1), include_self=False,
                 device=device)
    return idx[:n], k_adj


def scrublet(x, *, sim_doublet_ratio: float = 2.0, n_neighbors: Optional[int] = None,
             expected_doublet_rate: float = 0.05, threshold: Optional[float] = None,
             random_state: int = 0, device="auto"):
    """Doublet scores of raw counts (counterpart: pp.py:506): the doublets of
    :func:`scrublet_pairs` and the observed cells in the observed cells' PCA
    (:func:`_scrublet_embedding`), each observed cell's ``k_adj`` nearest
    of both besides itself (:func:`_scrublet_knn`: ``k = n_neighbors`` or
    round(sqrt(n) / 2), at least 3, ``k_adj = round(k (1 + ratio))``), the
    Bayesian-smoothed share of doublets among them turned into a doublet
    probability. Everything but the draws runs on ``device``. Returns
    ``(doublet_score, predicted_doublet, threshold)``, the threshold the
    90th percentile of the scores, at least 0.3, unless given. JAX queries
    ``k_adj + 1`` neighbours and drops the first as the cell itself; the
    port drops the cell's own index (the farthest where it is missing),
    which is the same unless a point coincides with the cell (a doublet with
    a partner without counts) and comes first, where JAX drops that point
    instead."""
    idx, k_adj = _scrublet_knn(x, sim_doublet_ratio, n_neighbors, random_state,
                               resolve_device(device))
    nbr_is_sim = (idx >= len(idx)).mean(axis=1)
    rho, rate = sim_doublet_ratio, expected_doublet_rate
    q = (nbr_is_sim * k_adj + 1) / (k_adj + 2)  # Bayesian smoothing
    score = np.clip(q * rate / rho / (1 - rate - q * (1 - rate - rate / rho)), 0, 1)
    thr = threshold if threshold is not None else max(np.percentile(score, 90), 0.3)
    return score, score > thr, float(thr)


def subsample(x, *, fraction: Optional[float] = None, n_obs: Optional[int] = None,
              random_state: int = 0):
    """A random subset of the cells without replacement, numpy's draw from
    ``random_state`` as JAX makes it (counterpart: pp.py:548): ``(idx,
    x[idx])``, the kept rows in order."""
    rng = np.random.default_rng(random_state)
    n = x.shape[0]
    size = n_obs if n_obs is not None else int(n * fraction)
    idx = np.sort(rng.choice(n, size=size, replace=False))
    return idx, x[idx]


__all__ = ["calculate_qc_metrics", "combat", "filter_cells", "filter_genes",
           "highly_variable_genes", "log1p", "neighbors", "normalize_per_cell", "normalize_total",
           "normalized_counts", "pca", "regress_out", "scale", "scrublet", "scrublet_pairs",
           "size_factors", "subsample"]
