"""Cell and gene filters on arrays (counterpart:
dance_tpu/transforms/filter.py): the scanpy threshold filters
(``FilterScanpy`` and its cell and gene forms :33-155, the ``*ScanpyOrder``
pair :569-622, the ratio thresholds ``_get_count`` :26), the cells common to
two modalities (``FilterCellsCommonMod`` :158), the genes common to several
groups (``FilterGenesCommon`` :177), the name filter (``FilterGenesMatch``
:211), the summary-statistic filters (``FilterGenes``,
``FilterGenesPercentile``, ``FilterGenesTopK`` :241-354), marker genes by
log fold change (``FilterGenesMarker`` :357) and by Giotto's Gini scores
(``gini_func``, ``FilterGenesMarkerGini`` :480-566,
``get_marker_genes_giotto`` :826), the regression filters
(``FilterGenesRegression`` :404), the HVG fronts (:625-659), the
placeholders (:662-715), ``FilterCellsType`` (:718), the QC outlier filter
(``FilterCellTransform`` :746) and ``ScrubletTransform`` (:788).

The JAX transforms read a ``Data`` container, write columns into it and
subset it; the port takes the matrix (and names, labels or profiles where
JAX reads them) and returns the masks or indices of what is kept and the
columns JAX writes. The summary filters return the kept genes in
**sorted-name order**, as the JAX transform does: it subsets its container
by ``sorted(selected names)`` (filter.py:291-297), so "g10" comes before
"g2". They take the gene names beside the matrix for that reason. Handed
a port ``Data`` instead, they act on it as JAX's do, and they are
registered under JAX's keys in the port's own registry; so are
``FilterGenesScanpyOrder``, ``HighlyVariableGenesRawCount`` and the two
gene placeholders, which the tuning configs name.

A gene is a marker of a type when its log fold change against the mean of
the other types' profiles passes ``threshold``; the filter keeps the genes
that mark any type. ``FilterGenesRegression`` takes its per-gene means,
variances and dropout rates on ``device`` (the CUDA card unless the CPU is
named) in float64; its least squares and ``argpartition``, the Gini scores,
the QC statistics and medians are host numpy, as in JAX. The port's
``get_count`` is JAX's ``_get_count`` (filter.py:26); JAX's strict
``get_count`` (filter.py:807) has no port. ``FilterGenesRegression`` always
warns on input that is not counts (JAX's ``skip_count_check`` silences it).
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch
from scipy.stats import median_abs_deviation, rankdata

from dance_tpu_torch.data import Frame
from dance_tpu_torch.data.base import BaseData
from dance_tpu_torch.registry import register_preprocessor
from dance_tpu_torch.settings import logger
from dance_tpu_torch.transforms.base import BaseTransform
from dance_tpu_torch.transforms.interface import AnnDataTransform
from dance_tpu_torch.utils import resolve_device


def get_count(value, basis: int):
    """A float in (0, 1) as that ratio of ``basis``, rounded down; any other
    value as it is (counterpart: filter.py:26)."""
    if isinstance(value, float) and 0 < value < 1:
        return int(value * basis)
    return value


class FilterScanpy(BaseTransform):
    """One count or nonzero-number threshold pass over cells or genes
    (counterpart: filter.py:33). A float threshold in (0, 1) is a ratio: of
    the totals' percentile for ``*_counts``, of the other axis's length for
    ``*_genes_or_cells``. ``__call__(x)`` returns ``(keep, n_counts,
    n_nonzero)``: the mask and each cell's or gene's total and nonzero
    count, the columns JAX writes under ``key_n_counts`` and
    ``key_n_genes_or_cells``. ``__call__(data)`` filters a port ``Data``'s
    ``X`` in place, as JAX's does with its default channel (its other
    channels, splits, key columns and ``inplace=False`` have no port: no
    ported pipeline sets them)."""

    _FILTER_TARGET: Optional[str] = None
    _DISPLAY_ATTRS = ("min_counts", "min_genes_or_cells", "max_counts", "max_genes_or_cells")

    def __init__(self, min_counts=None, min_genes_or_cells=None, max_counts=None,
                 max_genes_or_cells=None, **kwargs):
        super().__init__(**kwargs)
        self.min_counts = min_counts
        self.min_genes_or_cells = min_genes_or_cells
        self.max_counts = max_counts
        self.max_genes_or_cells = max_genes_or_cells
        if self._FILTER_TARGET not in ("cells", "genes"):
            if type(self) is FilterScanpy:
                raise NotImplementedError("Use FilterCellsScanpy or FilterGenesScanpy")
            raise ValueError(f"Unknown filter target {self._FILTER_TARGET!r}")

    def _thresholds(self, x):
        axis = 1 if self._FILTER_TARGET == "cells" else 0
        n_counts = np.asarray(x.sum(axis=axis)).ravel()
        n_nonzero = np.asarray((x > 0).sum(axis=axis)).ravel()
        min_counts, max_counts = self.min_counts, self.max_counts
        if isinstance(min_counts, float) and 0 < min_counts < 1:
            min_counts = np.percentile(n_counts, min_counts * 100)
        if isinstance(max_counts, float) and 0 < max_counts < 1:
            max_counts = np.percentile(n_counts, max_counts * 100)
        basis = x.shape[1 - axis]
        return (n_counts, n_nonzero, min_counts, max_counts,
                get_count(self.min_genes_or_cells, basis),
                get_count(self.max_genes_or_cells, basis))

    def __call__(self, x):
        if isinstance(x, BaseData):
            return self._filter_data(x)
        n_counts, n_nonzero, min_c, max_c, min_o, max_o = self._thresholds(x)
        keep = np.ones(len(n_counts), dtype=bool)
        if min_c is not None:
            keep &= n_counts >= min_c
        if max_c is not None:
            keep &= n_counts <= max_c
        if min_o is not None:
            keep &= n_nonzero >= min_o
        if max_o is not None:
            keep &= n_nonzero <= max_o
        if not keep.all():
            self.logger.info("Removing %d %s", int((~keep).sum()), self._FILTER_TARGET)
        return keep, n_counts, n_nonzero

    def _filter_data(self, data):
        """Counterpart: filter.py:81-118."""
        keep, _, _ = self(data.get_feature(return_type="numpy", channel_type="X"))
        if keep.all():
            return data
        if self._FILTER_TARGET == "genes":
            data.data._inplace_subset_var(keep)
        else:
            data.filter_by_mask(keep)
        return data


@register_preprocessor("filter", "cell")
class FilterCellsScanpy(FilterScanpy):
    """:class:`FilterScanpy` over cells (counterpart: filter.py:120)."""

    _FILTER_TARGET = "cells"

    def __init__(self, min_counts=None, min_genes=None, max_counts=None, max_genes=None,
                 **kwargs):
        super().__init__(min_counts=min_counts, min_genes_or_cells=min_genes,
                         max_counts=max_counts, max_genes_or_cells=max_genes, **kwargs)


@register_preprocessor("filter", "gene")
class FilterGenesScanpy(FilterScanpy):
    """:class:`FilterScanpy` over genes (counterpart: filter.py:139)."""

    _FILTER_TARGET = "genes"

    def __init__(self, min_counts=None, min_cells=None, max_counts=None, max_cells=None,
                 **kwargs):
        super().__init__(min_counts=min_counts, min_genes_or_cells=min_cells,
                         max_counts=max_counts, max_genes_or_cells=max_cells, **kwargs)


def _in_order(filters, x, axis: int):
    """Apply the filters one after the other, each on what the ones before
    kept; the indices of what is left and the last filter's columns."""
    idx = np.arange(x.shape[axis])
    cols = None
    for f in filters:
        sub = x[idx] if axis == 0 else x[:, idx]
        keep, n_counts, n_nonzero = f(sub)
        cols = (n_counts[keep], n_nonzero[keep])
        idx = idx[keep]
    return idx, cols


@register_preprocessor("filter", "gene")
class FilterGenesScanpyOrder(BaseTransform):
    """The gene thresholds applied one at a time in ``order`` (counterpart:
    filter.py:569). ``__call__(x)`` returns the kept genes' indices; on a
    port ``Data``, each step filters its genes in place, as JAX's."""

    _DISPLAY_ATTRS = ("order",)

    def __init__(self, order: Optional[List[str]] = None, min_counts=None, min_cells=None,
                 max_counts=None, max_cells=None, **kwargs):
        super().__init__(**kwargs)
        self.order = order if order is not None else ["min_counts", "min_cells", "max_counts",
                                                      "max_cells"]
        params = {"min_counts": min_counts, "min_cells": min_cells, "max_counts": max_counts,
                  "max_cells": max_cells}
        if not set(self.order).issubset(params):
            raise KeyError(f"Order entries must be in {sorted(params)}")
        self.steps = [FilterGenesScanpy(**{key: params[key]}) for key in self.order]

    def __call__(self, x):
        if isinstance(x, BaseData):
            for step in self.steps:
                step(x)
            return x
        return _in_order(self.steps, x, axis=1)[0]


class FilterCellsScanpyOrder:
    """The cell thresholds applied one at a time in ``order`` (counterpart:
    filter.py:595). ``__call__(x)`` returns the kept cells' indices and the
    ``obs`` columns JAX leaves (``n_counts``, ``n_genes``: the last step's,
    of the kept cells)."""

    def __init__(self, order: Optional[List[str]] = None, min_counts=None, min_genes=None,
                 max_counts=None, max_genes=None):
        self.order = order if order is not None else ["min_counts", "min_genes", "max_counts",
                                                      "max_genes"]
        params = {"min_counts": min_counts, "min_genes": min_genes, "max_counts": max_counts,
                  "max_genes": max_genes}
        if not set(self.order).issubset(params):
            raise KeyError(f"Order entries must be in {sorted(params)}")
        self.steps = [FilterCellsScanpy(**{key: params[key]}) for key in self.order]

    def __call__(self, x) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        idx, (n_counts, n_genes) = _in_order(self.steps, x, axis=0)
        return idx, {"n_counts": n_counts, "n_genes": n_genes}


class FilterCellsCommonMod:
    """The cells present in both modalities (counterpart: filter.py:158).
    ``__call__(names1, names2, sol_names=None)`` returns, for each list of
    cell names given, the indices of the common cells in sorted-name order,
    as JAX subsets each modality by them."""

    def __call__(self, names1, names2, sol_names=None) -> List[np.ndarray]:
        common = sorted(set(np.asarray(names1).tolist()) & set(np.asarray(names2).tolist()))
        out = []
        for names in (names1, names2, sol_names):
            if names is not None:
                pos = {n: i for i, n in enumerate(np.asarray(names).tolist())}
                out.append(np.asarray([pos[c] for c in common], dtype=np.int64))
        return out


@register_preprocessor("filter", "gene")
class FilterGenesMarker(BaseTransform):
    """Marker genes of a (genes x types) profile (counterpart: filter.py:358).
    ``__call__(ct_profile)`` returns the boolean mask of the genes kept.
    ``__call__(data)`` reads the profile ``Frame`` in
    ``varm["CellTopicProfile"]``, writes the (genes x types) indicator to
    ``varm[out]`` and keeps the marker genes in gene order, as JAX's does
    with its defaults (the port keeps ``ct_profile_channel`` and ``subset``
    as class constants, printed in the digest: no pipeline sets another)."""

    _DISPLAY_ATTRS = ("ct_profile_channel", "subset", "threshold", "eps")
    ct_profile_channel, subset = "CellTopicProfile", True

    def __init__(self, *, threshold: float = 1.25, eps: float = 1e-6, **kwargs):
        super().__init__(**kwargs)
        self.threshold = threshold
        self.eps = eps

    @staticmethod
    def get_marker_genes(ct_profile: np.ndarray, cell_types: Sequence[str],
                         genes: Optional[Sequence[str]] = None, *, threshold: float = 1.25,
                         eps: float = 1e-6, logger=logger) -> Tuple[List, np.ndarray]:
        """``(markers, ind)``: the names (or, without ``genes``, the indices)
        of the genes that mark any type, in gene order, and the (genes x
        types) boolean indicator (counterpart: filter.py:377)."""
        if len(cell_types) < 2:
            raise ValueError("Need at least two cell types to find marker genes")
        ct_profile = np.asarray(ct_profile)
        ind = np.zeros((ct_profile.shape[0], len(cell_types)), dtype=bool)
        for i, ct in enumerate(cell_types):
            others = [j for j in range(len(cell_types)) if j != i]
            log_fc = (np.log(ct_profile[:, i] + eps)
                      - np.log(ct_profile[:, others].mean(1) + eps))
            ind[:, i] = log_fc > threshold
            logger.info("Found %d marker genes for cell type %r", int(ind[:, i].sum()), ct)
        keep = np.nonzero(ind.any(1))[0]
        markers = [genes[k] for k in keep] if genes is not None else keep.tolist()
        return markers, ind

    def __call__(self, ct_profile, cell_types: Optional[Sequence[str]] = None):
        if isinstance(ct_profile, BaseData):
            return self._filter_data(ct_profile)
        cell_types = cell_types if cell_types is not None else range(ct_profile.shape[1])
        _, ind = self.get_marker_genes(ct_profile, list(cell_types), threshold=self.threshold,
                                       eps=self.eps)
        return ind.any(1)

    def _filter_data(self, data):
        """Counterpart: filter.py:399-410."""
        profile = data.get_feature(channel=self.ct_profile_channel, channel_type="varm",
                                   return_type="default")
        genes = list(profile.index)
        markers, ind = self.get_marker_genes(profile.to_numpy(), profile.columns, genes,
                                             threshold=self.threshold, eps=self.eps,
                                             logger=self.logger)
        data.data.varm[self.out] = Frame(ind, index=profile.index, columns=profile.columns)
        data.data._inplace_subset_var(np.asarray(markers))
        return data


@register_preprocessor("filter", "gene")
class FilterGenesMatch(BaseTransform):
    """Drop the genes whose names start with one of ``prefixes`` or end with
    one of ``suffixes`` (counterpart: filter.py:212). With ``case_sensitive``
    the patterns and the names are upper-cased before matching, as the JAX
    transform does (the flag's name says the opposite of what it does).
    ``select(gene_names)`` is the boolean mask of the genes kept,
    ``__call__(x, gene_names)`` returns the kept columns and names in gene
    order, and ``__call__(data)`` keeps those genes of a port ``Data``."""

    _DISPLAY_ATTRS = ("prefixes", "suffixes")

    def __init__(self, prefixes: Optional[List[str]] = None,
                 suffixes: Optional[List[str]] = None, case_sensitive: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.prefixes = list(prefixes or [])
        self.suffixes = list(suffixes or [])
        self.case_sensitive = case_sensitive
        if case_sensitive:
            self.prefixes = [i.upper() for i in self.prefixes]
            self.suffixes = [i.upper() for i in self.suffixes]

    def select(self, gene_names: Sequence) -> np.ndarray:
        names = [str(n) for n in gene_names]
        check = [n.upper() for n in names] if self.case_sensitive else names
        remove = np.array([n.startswith(tuple(self.prefixes)) or n.endswith(tuple(self.suffixes))
                           for n in check], dtype=bool).reshape(len(names))
        self.logger.info("Removing %d genes by name match", int(remove.sum()))
        return ~remove

    def __call__(self, x, gene_names: Sequence = None):
        if isinstance(x, BaseData):
            x.data._inplace_subset_var(self.select(x.data.var_names))
            return x
        keep = np.nonzero(self.select(gene_names))[0]
        return x[:, keep], np.asarray(gene_names)[keep]


@register_preprocessor("filter", "gene")
class FilterGenesCommon(BaseTransform):
    """The genes expressed in every group of cells (counterpart:
    filter.py:178). ``select(groups)`` takes each group as a ``(matrix,
    gene_names)`` pair, so the groups may name different genes, and returns
    the names with a nonzero absolute sum in every group, in sorted-name
    order as the JAX transform subsets by them; ``__call__(groups)``
    returns each group's ``(columns, names)`` of those genes in that order.
    ``__call__(data)`` groups a port ``Data``'s cells by the splits
    ``split_keys`` and keeps the common genes in that order. JAX's
    ``batch_key`` grouping has no port (no pipeline sets it): it is a class
    constant, printed in the digest."""

    _DISPLAY_ATTRS = ("batch_key", "split_keys")
    batch_key = None

    def __init__(self, split_keys: Optional[List[str]] = None, **kwargs):
        super().__init__(**kwargs)
        self.split_keys = split_keys

    @staticmethod
    def select(groups: Sequence[Tuple[object, Sequence]]) -> np.ndarray:
        keep_sets = []
        for i, (x, names) in enumerate(groups):
            x = abs(x) if sp.issparse(x) else np.abs(np.asarray(x))
            abs_sum = np.asarray(x.sum(0)).ravel()
            keep_sets.append(set(np.asarray(names)[abs_sum > 0].tolist()))
            logger.info("%d genes found in group %d", len(keep_sets[-1]), i)
        common = sorted(set.intersection(*keep_sets))
        logger.info("Found %d common genes", len(common))
        return np.asarray(common)

    def __call__(self, groups):
        if isinstance(groups, BaseData):
            return self._filter_data(groups)
        common = self.select(groups)
        out = []
        for x, names in groups:
            col = {g: j for j, g in enumerate(np.asarray(names).tolist())}
            idx = np.asarray([col[g] for g in common.tolist()], dtype=np.int64)
            out.append((x[:, idx], common))
        return out

    def _filter_data(self, data):
        """Counterpart: filter.py:192-208, the ``split_keys`` branch."""
        if self.split_keys is None:
            raise ValueError("FilterGenesCommon on a Data needs split_keys")
        adata = data.data
        groups = [(adata.X[np.asarray(data.get_split_idx(k, error_on_miss=True))],
                   adata.var_names) for k in self.split_keys]
        data.data._inplace_subset_var(self.select(groups))
        return data


GENE_SUMMARY_MODES = ("sum", "var", "cv", "rv")


class FilterGenes(BaseTransform):
    """A gene filter on a per-gene summary statistic of a cells x genes
    matrix (counterpart: filter.py:241). ``mode`` is ``"sum"``, ``"var"``
    (the biased ``E[x²] - E[x]²``), ``"cv"`` (``sqrt(max(var, 0)) / mean``)
    or ``"rv"`` (``var / mean``), non-finite ratios read as 0, in the
    matrix's dtype as numpy computes them. ``__call__(x, gene_names)``
    returns the kept columns and names in sorted-name order. ``__call__``
    on a port ``Data`` is JAX's with its default channel: the summary of
    ``X``, ``var["n_counts"]``/``var["n_cells"]`` with
    ``add_n_counts``/``add_n_cells``, ``uns["gene_summary"]``, then the
    container cut to the kept genes in sorted-name order. JAX's ``layers``
    channel, ``whitelist_indicators``, ``inplace=False`` and ``mod`` have
    no port: no ported pipeline sets them."""

    def __init__(self, *, mode: str = "sum", add_n_counts: bool = True,
                 add_n_cells: bool = True, **kwargs):
        super().__init__(**kwargs)
        if mode not in GENE_SUMMARY_MODES:
            raise ValueError(f"Unknown summarization mode {mode!r}")
        self.mode = mode
        self.add_n_counts = add_n_counts
        self.add_n_cells = add_n_cells

    def _get_preserve_mask(self, gene_summary: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def summarize(self, x) -> np.ndarray:
        """The per-gene summary (counterpart: filter.py:266)."""
        x = np.asarray(x)
        if self.mode == "sum":
            return np.asarray(x.sum(0)).ravel()
        mean = np.asarray(x.mean(0)).ravel()
        msq = np.asarray((x ** 2).mean(0)).ravel()
        var = msq - mean ** 2
        if self.mode == "var":
            return var
        with np.errstate(divide="ignore", invalid="ignore"):
            if self.mode == "cv":
                return np.nan_to_num(np.sqrt(np.maximum(var, 0)) / mean, posinf=0, neginf=0)
            return np.nan_to_num(var / mean, posinf=0, neginf=0)

    def select(self, x, gene_names: Sequence) -> np.ndarray:
        """Column indices of the kept genes, in sorted-name order."""
        names = np.asarray(gene_names)
        if len(set(names.tolist())) != len(names):
            raise ValueError("gene names must be unique: the kept genes are ordered by name")
        kept = np.nonzero(self._get_preserve_mask(self.summarize(x)))[0]
        logger.info("%d genes removed", names.size - kept.size)
        return kept[sorted(range(kept.size), key=lambda i: names[kept[i]])]

    def __call__(self, x, gene_names: Sequence = None):
        if isinstance(x, BaseData):
            return self._filter_data(x)
        idx = self.select(x, gene_names)
        return np.asarray(x)[:, idx], np.asarray(gene_names)[idx]

    def _filter_data(self, data):
        """Counterpart: filter.py:279-303."""
        x = data.get_feature(return_type="numpy", channel_type="X")
        if self.add_n_counts:
            data.data.var["n_counts"] = np.asarray(x.sum(0)).ravel()
        if self.add_n_cells:
            data.data.var["n_cells"] = np.asarray((x > 0).sum(0)).ravel()
        gene_summary = self.summarize(x)
        mask = self._get_preserve_mask(gene_summary)
        selected = np.asarray(sorted(set(np.asarray(data.data.var_names)[mask])), dtype=object)
        data.data.uns["gene_summary"] = gene_summary
        self.logger.info("%d genes removed", data.shape[1] - len(selected))
        data.data._inplace_subset_var(selected)
        return data


@register_preprocessor("filter", "gene")
class FilterGenesPercentile(FilterGenes):
    """Keep the genes whose summary lies between its ``min_val`` and
    ``max_val`` percentiles, both bounds included (counterpart:
    filter.py:306)."""

    _DISPLAY_ATTRS = ("min_val", "max_val", "mode")

    def __init__(self, min_val: Optional[float] = 1, max_val: Optional[float] = 99, **kwargs):
        super().__init__(**kwargs)
        self.min_val = min_val
        self.max_val = max_val

    def _get_preserve_mask(self, gene_summary):
        lo = np.percentile(gene_summary, self.min_val) if self.min_val is not None else -np.inf
        hi = np.percentile(gene_summary, self.max_val) if self.max_val is not None else np.inf
        return (gene_summary >= lo) & (gene_summary <= hi)


@register_preprocessor("filter", "gene")
class FilterGenesTopK(FilterGenes):
    """Keep the ``num_genes`` genes of the largest summary (``top``) or the
    smallest (counterpart: filter.py:327). Ties are broken as numpy's default
    ``argsort`` breaks them, which is the JAX transform's call. On a
    ``Data`` it writes no ``var`` counts unless asked, as in JAX."""

    _DISPLAY_ATTRS = ("num_genes", "top", "mode")

    def __init__(self, num_genes: int = 1000, top: bool = True, *, mode: str = "cv",
                 add_n_counts: bool = False, add_n_cells: bool = False, **kwargs):
        super().__init__(mode=mode, add_n_counts=add_n_counts, add_n_cells=add_n_cells,
                         **kwargs)
        self.num_genes = num_genes
        self.top = top

    def _get_preserve_mask(self, gene_summary):
        k = min(self.num_genes, gene_summary.size)
        if k < self.num_genes:
            logger.warning("num_genes=%d > total genes %d", self.num_genes, gene_summary.size)
        order = gene_summary.argsort()
        mask = np.zeros(gene_summary.size, dtype=bool)
        mask[order[-k:] if self.top else order[:k]] = True
        return mask


class FilterGenesRegression:
    """The ``num_genes`` genes farthest above a fitted trend (counterpart:
    filter.py:404): ``"enclasc"`` (log mean on dropout rate), ``"seurat3"``
    (log variance on a quadratic of log mean) or ``"scmap"`` (log2 dropout
    on log2 mean). ``__call__(x)`` returns their indices, in
    ``np.argpartition``'s order as JAX takes them (compare as a set)."""

    METHODS = ("enclasc", "seurat3", "scmap")

    def __init__(self, method: str = "enclasc", num_genes: int = 1000, *, device="auto"):
        if method not in self.METHODS:
            raise ValueError(f"Unknown method {method!r}, options: {sorted(self.METHODS)}")
        self.method = method
        self.num_genes = num_genes
        self.device = device

    def __call__(self, x) -> np.ndarray:
        xt = torch.from_numpy(np.asarray(x.toarray() if sp.issparse(x) else x, np.float64))
        xt = xt.to(resolve_device(self.device))
        if bool(torch.remainder(xt, 1).sum() != 0):
            logger.warning("Input does not appear to be count data")
        mean = xt.mean(0)
        stats = {"mean": mean, "drop": (xt == 0).to(torch.float64).mean(0),
                 "var": ((xt - mean) ** 2).mean(0)}
        stats = {k: v.cpu().numpy() for k, v in stats.items()}
        k = min(self.num_genes, xt.shape[1])
        return getattr(self, "_" + self.method)(stats, k)

    @staticmethod
    def _fit_resid(x, y):
        a = np.column_stack([np.ones_like(x), x])
        beta, *_ = np.linalg.lstsq(a, y, rcond=None)
        return y - a @ beta

    def _enclasc(self, st, k):
        mean, drop = st["mean"], st["drop"]
        scores = np.full(mean.shape[0], -100.0)
        sel = (drop > 0) & (drop < 1)
        y = np.log(mean + 1)[sel]
        scores[sel] = y + self._fit_resid(drop[sel], y) - mean[sel]
        return np.argpartition(scores, -k)[-k:]

    def _seurat3(self, st, k):
        mean_log = np.log(st["mean"] + 1)
        var_log = np.log(st["var"] + 1)
        a = np.column_stack([np.ones_like(mean_log), mean_log, mean_log ** 2])
        beta, *_ = np.linalg.lstsq(a, var_log, rcond=None)
        return np.argpartition(var_log - a @ beta, -k)[-k:]

    def _scmap(self, st, k):
        mean, drop = st["mean"], st["drop"]
        scores = np.full(mean.shape[0], -100.0)
        sel = (drop > 0) & (drop < 1)
        scores[sel] = self._fit_resid(np.log2(mean[sel] + 1), np.log2(drop[sel] * 100))
        return np.argpartition(scores, -k)[-k:]


def gini_func(x, weights=None) -> float:
    """The weighted Gini coefficient with the RSV correction for negative
    values (counterpart: filter.py:480)."""
    x = np.asarray(x, dtype=np.float64)
    weights = np.ones(len(x)) if weights is None else np.asarray(weights, np.float64)
    order = np.argsort(x)
    x, weights = x[order], weights[order]
    n = weights.sum()
    xw = x * weights
    c = np.cumsum(weights)
    g_num = (2 / n ** 2) * np.sum(xw * c) - (1 / n) * np.sum(xw) - (1 / n ** 2) * np.sum(
        xw * weights)
    t_neg = np.sum(xw[xw <= 0])
    t_pos = np.sum(xw) + abs(t_neg)
    mean_rsv = (t_pos + abs(t_neg)) / n
    return g_num / mean_rsv if mean_rsv != 0 else 0.0


def _pair_gini(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """:func:`gini_func` of each pair ``[a[i], b[i]]``, vectorised in the
    same floating-point operations."""
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    s = lo + hi
    g_num = 0.5 * (lo + 2 * hi) - 0.5 * s - 0.25 * s
    t_neg = np.where(hi <= 0, s, np.where(lo <= 0, lo, 0.0))
    mean_rsv = (s + np.abs(t_neg) + np.abs(t_neg)) / 2
    return np.where(mean_rsv != 0, g_num / np.where(mean_rsv != 0, mean_rsv, 1.0), 0.0)


def _score_pair(g1, g2, d1, d2, genes, min_expr_gini=0.2, min_det_gini=0.2, rank_score=1,
                min_genes=5) -> Dict[str, np.ndarray]:
    """Giotto's marker scores of one group against the rest (counterpart:
    ``FilterGenesMarkerGini._score_pair``, filter.py:513). Returns the
    columns of JAX's frame for the selected genes, ``index`` their row
    indices."""
    g1, g2, d1, d2 = (np.asarray(a, np.float64) for a in (g1, g2, d1, d2))
    expr_gini, det_gini = _pair_gini(g1, g2), _pair_gini(d1, d2)

    def rank01(a, b):
        r = rankdata(np.column_stack([a, b]), axis=1).T
        rmin, rmax = r.min(), r.max()
        return 0.1 + (r - rmin) / max(rmax - rmin, 1e-12) * 0.9

    rank_e, rank_d = rank01(g1, g2)[0], rank01(d1, d2)[0]
    score = det_gini * expr_gini * rank_e * rank_d
    order_rank = np.argsort(np.argsort(-score)) + 1
    first = (order_rank <= min_genes) | ((rank_e <= rank_score) & (rank_d <= rank_score))
    keep = first & ((order_rank <= min_genes) | ((g1 > min_expr_gini) & (d1 > min_det_gini)))
    idx = np.nonzero(keep)[0]
    return {"index": idx, "ans_score": score[idx], "ans_rank": order_rank[idx],
            "expression": g1[idx], "detection": d1[idx], "expression_gini": expr_gini[idx],
            "detection_gini": det_gini[idx], "gene_name": np.asarray(genes)[idx]}


class FilterGenesMarkerGini:
    """Giotto's Gini marker genes (counterpart: filter.py:497): each type's
    expression and detection profiles against the others' averaged with
    the types' cell counts as weights (equal without them), scored by
    :func:`get_marker_genes_giotto`. ``__call__(prof, det, nums=None,
    genes=None, cell_types=None)`` takes the (genes, types) profiles of
    ``CellGiottoTopicProfile`` and returns ``(keep, ind, frames)``: the
    markers' mask, the (genes, types) indicator and each type's selected
    scores (``cellType`` added), JAX's ``uns`` frame split by type."""

    def __call__(self, prof, det, nums=None, genes=None, cell_types=None):
        prof, det = np.asarray(prof, np.float64), np.asarray(det, np.float64)
        n_genes, n_types = prof.shape
        genes = np.arange(n_genes) if genes is None else np.asarray(genes)
        cts = list(range(n_types)) if cell_types is None else list(cell_types)
        weights = (np.asarray(nums, np.float64) if nums is not None else np.ones(n_types))
        ind = np.zeros((n_genes, n_types), dtype=bool)
        frames = []
        for i, ct in enumerate(cts):
            others = [j for j in range(n_types) if j != i]
            w = weights[others] / weights[others].sum()
            top = _score_pair(prof[:, i], (prof[:, others] * w).sum(1), det[:, i],
                              (det[:, others] * w).sum(1), genes)
            top["cellType"] = np.full(len(top["index"]), ct, dtype=object)
            frames.append(top)
            ind[top["index"], i] = True
        return ind.any(1), ind, frames


def get_marker_genes_giotto(group1, group2, group_detection_1, group_detection_2,
                            min_expr_gini_score=0.2, min_det_gini_score=0.2, rank_score=1,
                            min_genes=5, genes=None) -> Dict[str, np.ndarray]:
    """Giotto's marker scores of one pair of groups (counterpart:
    filter.py:826): the selected genes' columns as a dict of arrays."""
    n = np.asarray(group1).shape[0]
    return _score_pair(group1, group2, group_detection_1, group_detection_2,
                       np.arange(n) if genes is None else genes,
                       min_expr_gini=min_expr_gini_score, min_det_gini=min_det_gini_score,
                       rank_score=rank_score, min_genes=min_genes)


@register_preprocessor("filter", "gene")
class HighlyVariableGenesRawCount(AnnDataTransform):
    """seurat_v3 HVGs of raw counts (counterpart: filter.py:625):
    ``__call__(x)`` returns :func:`~dance_tpu_torch.sc.pp.
    highly_variable_genes`' dict; its ``highly_variable`` is what JAX
    subsets by. On a port ``Data`` it is JAX's ``AnnDataTransform`` of
    ``sc.pp.highly_variable_genes`` (the ``var`` columns, then the genes
    kept)."""

    def __init__(self, n_top_genes: Optional[int] = 1000, span: float = 0.3, **kwargs):
        super().__init__("sc.pp.highly_variable_genes", n_top_genes=n_top_genes, span=span,
                         subset=True, inplace=True, flavor="seurat_v3", **kwargs)
        self.n_top_genes = n_top_genes
        self.span = span

    def __call__(self, x):
        if isinstance(x, BaseData):
            return super().__call__(x)
        from dance_tpu_torch.sc import pp

        return pp.highly_variable_genes(x, flavor="seurat_v3", n_top_genes=self.n_top_genes,
                                        span=self.span)


@register_preprocessor("filter", "gene")
class HighlyVariableGenesLogarithmizedByTopGenes(AnnDataTransform):
    """seurat or cell_ranger HVGs of log data by the top ``n_top_genes``
    (counterpart: filter.py:636). On an array, ``__call__(x)`` returns
    :func:`~dance_tpu_torch.sc.pp.highly_variable_genes`' dict; on a port
    ``Data`` it is JAX's ``AnnDataTransform`` of ``sc.pp.highly_variable_genes``
    (the ``var`` columns, then the genes kept with ``subset``)."""

    def __init__(self, n_top_genes: Optional[int] = 1000, n_bins: int = 20,
                 flavor: str = "seurat", **kwargs):
        super().__init__("sc.pp.highly_variable_genes", n_top_genes=n_top_genes, n_bins=n_bins,
                         flavor=flavor, subset=True, inplace=True, **kwargs)
        self.n_top_genes = n_top_genes
        self.n_bins = n_bins
        self.flavor = flavor

    def __call__(self, x):
        if isinstance(x, BaseData):
            return super().__call__(x)
        from dance_tpu_torch.sc import pp

        return pp.highly_variable_genes(x, flavor=self.flavor, n_top_genes=self.n_top_genes,
                                        n_bins=self.n_bins)


class HighlyVariableGenesLogarithmizedByMeanAndDisp:
    """seurat HVGs of log data by mean and dispersion cut-offs (counterpart:
    filter.py:649)."""

    def __init__(self, min_disp: float = 0.5, max_disp: float = np.inf,
                 min_mean: float = 0.0125, max_mean: float = 3, n_bins: int = 20):
        self.min_disp, self.max_disp = min_disp, max_disp
        self.min_mean, self.max_mean = min_mean, max_mean
        self.n_bins = n_bins

    def __call__(self, x) -> Dict[str, np.ndarray]:
        from dance_tpu_torch.sc import pp

        return pp.highly_variable_genes(x, min_disp=self.min_disp, max_disp=self.max_disp,
                                        min_mean=self.min_mean, max_mean=self.max_mean,
                                        n_bins=self.n_bins)


@register_preprocessor("filter", "gene")
class FilterGenesPlaceHolder(BaseTransform):
    """No filter: ``(n_counts, n_cells)`` of each gene, the ``var`` columns
    JAX writes (counterpart: filter.py:662); on a port ``Data``, written to
    ``var``."""

    def __call__(self, x):
        if isinstance(x, BaseData):
            x.data.var["n_counts"], x.data.var["n_cells"] = self(
                x.get_feature(return_type="numpy", channel_type="X"))
            return x
        return np.asarray(x.sum(0)).ravel(), np.asarray((x > 0).sum(0)).ravel()


@register_preprocessor("filter", "gene")
class FilterGenesNumberPlaceHolder(BaseTransform):
    """The identity (counterpart: filter.py:682), of an array or a port
    ``Data``."""

    def __call__(self, x):
        return x


class FilterCellsPlaceHolder:
    """No filter: ``(n_counts, n_genes)`` of each cell, the ``obs`` columns
    JAX writes (counterpart: filter.py:694)."""

    def __call__(self, x) -> Tuple[np.ndarray, np.ndarray]:
        return np.asarray(x.sum(1)).ravel(), np.asarray((x > 0).sum(1)).ravel()


@register_preprocessor("filter", "cell")
class FilterCellsType(BaseTransform):
    """The cells of the types with more than ``cell_type_threshold`` cells
    (counterpart: filter.py:718): ``__call__(onehot)`` takes the (cells,
    types) one-hot matrix and returns the keep mask; ``__call__(data)``
    reads it from ``obsm["cell_type"]``, a ``Frame`` as JAX's is a
    DataFrame, and keeps those cells."""

    _DISPLAY_ATTRS = ("cell_type_threshold",)

    def __init__(self, cell_type_threshold: int = 10, **kwargs):
        super().__init__(**kwargs)
        self.cell_type_threshold = cell_type_threshold

    def __call__(self, onehot):
        if isinstance(onehot, BaseData):
            data = onehot
            frame = data.data.obsm["cell_type"]
            if not isinstance(frame, Frame):
                raise TypeError(f"obsm['cell_type'] must be a Frame, got {type(frame)}")
            return data.filter_by_mask(self(frame.to_numpy()))
        onehot = np.asarray(onehot)
        remove = onehot.sum(0) <= self.cell_type_threshold
        self.logger.info("Found %d cell types below threshold", int(remove.sum()))
        return ~(onehot[:, remove].sum(1) > 0)


class FilterCellTransform:
    """QC outliers by median absolute deviations (counterpart:
    filter.py:746): 5 MADs on log1p totals, log1p genes and the top-20
    share, 3 MADs or over 8 % on the mitochondrial share (genes named
    ``MT-``, ``Mt-`` for mouse). ``__call__(x, gene_names)`` returns the
    keep mask and the ``obs`` columns JAX writes. Host numpy, as in JAX."""

    def __init__(self, species: str = "human"):
        self.species = species

    @staticmethod
    def is_outlier(values, nmads: int) -> np.ndarray:
        values = np.asarray(values, dtype=np.float64)
        med = np.median(values)
        mad = median_abs_deviation(values)
        return (values < med - nmads * mad) | (values > med + nmads * mad)

    def __call__(self, x, gene_names) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        x = x.toarray() if sp.issparse(x) else np.asarray(x)
        prefix = "MT-" if self.species == "human" else "Mt-"
        mt = np.array([str(n).startswith(prefix) for n in gene_names], dtype=bool)
        total = x.sum(1)
        n_genes = (x > 0).sum(1)
        pct_mt = (x[:, mt].sum(1) / np.maximum(total, 1e-12) * 100 if mt.any()
                  else np.zeros(len(total)))
        top20 = np.sort(x, axis=1)[:, -20:].sum(1) / np.maximum(total, 1e-12) * 100
        outlier = (self.is_outlier(np.log1p(total), 5) | self.is_outlier(np.log1p(n_genes), 5)
                   | self.is_outlier(top20, 5))
        mt_outlier = self.is_outlier(pct_mt, 3) | (pct_mt > 8)
        keep = ~outlier & ~mt_outlier
        logger.info("Keeping %d / %d cells after QC", int(keep.sum()), len(keep))
        return keep, {"total_counts": total, "n_genes_by_counts": n_genes,
                      "pct_counts_mt": pct_mt}


class ScrubletTransform:
    """The cells that Scrublet does not call doublets (counterpart:
    filter.py:788): ``__call__(x)`` returns the keep mask of
    :func:`~dance_tpu_torch.sc.pp.scrublet` on the counts ``x``, on
    ``device``."""

    def __init__(self, device="auto"):
        self.device = device

    def __call__(self, x) -> np.ndarray:
        from dance_tpu_torch.sc import pp

        _, doublet, _ = pp.scrublet(x, device=self.device)
        logger.info("Removing %d predicted doublets", int(doublet.sum()))
        return ~doublet


__all__ = ["FilterCellTransform", "FilterCellsCommonMod", "FilterCellsPlaceHolder",
           "FilterCellsScanpy", "FilterCellsScanpyOrder", "FilterCellsType", "FilterGenes",
           "FilterGenesCommon", "FilterGenesMarker", "FilterGenesMarkerGini", "FilterGenesMatch",
           "FilterGenesNumberPlaceHolder", "FilterGenesPercentile", "FilterGenesPlaceHolder",
           "FilterGenesRegression", "FilterGenesScanpy", "FilterGenesScanpyOrder",
           "FilterGenesTopK", "FilterScanpy", "HighlyVariableGenesLogarithmizedByMeanAndDisp",
           "HighlyVariableGenesLogarithmizedByTopGenes", "HighlyVariableGenesRawCount",
           "ScrubletTransform", "get_count", "get_marker_genes_giotto", "gini_func"]
