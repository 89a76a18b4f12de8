"""Gene filters on arrays: marker genes of a cell-type profile
(counterpart: ``FilterGenesMarker``, dance_tpu/transforms/filter.py:358-404),
the summary-statistic filters ``FilterGenesPercentile`` and
``FilterGenesTopK`` (filter.py:241-354), the name filter
``FilterGenesMatch`` (filter.py:212-238), the genes common to several groups
of cells ``FilterGenesCommon`` (filter.py:178-208), and the ratio thresholds
of the scanpy filters (``_get_count``, filter.py:26).

The summary filters return the kept genes in **sorted-name order**, as the
JAX transform does: it subsets its container by ``sorted(selected names)``
(filter.py:291-297), so "g10" comes before "g2". They take the gene names
beside the matrix for that reason.

A gene is a marker of a type when its log fold change against the mean of
the other types' profiles passes ``threshold``; the filter keeps the genes
that mark any type. The JAX transform reads the profile from ``varm``,
writes the per-type indicator there and subsets the container's genes; the
port returns the indicator and the mask. The file's other filters are not
ported as transforms (ROADMAP Queue 1); the modules apply ``FilterCellsType``
and ``FilterGenesScanpy`` in their ``*_preprocess``.
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from dance_tpu_torch.settings import logger


def get_count(value, basis: int):
    """A float in (0, 1) as that ratio of ``basis``, rounded down; any other
    value as it is (counterpart: filter.py:26)."""
    if isinstance(value, float) and 0 < value < 1:
        return int(value * basis)
    return value


class FilterGenesMarker:
    """Marker genes of a (genes x types) profile (counterpart: filter.py:358).
    ``__call__(ct_profile)`` returns the boolean mask of the genes kept."""

    def __init__(self, *, threshold: float = 1.25, eps: float = 1e-6):
        self.threshold = threshold
        self.eps = eps

    @staticmethod
    def get_marker_genes(ct_profile: np.ndarray, cell_types: Sequence[str],
                         genes: Optional[Sequence[str]] = None, *, threshold: float = 1.25,
                         eps: float = 1e-6) -> Tuple[List, np.ndarray]:
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

    def __call__(self, ct_profile: np.ndarray, cell_types: Optional[Sequence[str]] = None
                 ) -> np.ndarray:
        cell_types = cell_types if cell_types is not None else range(ct_profile.shape[1])
        _, ind = self.get_marker_genes(ct_profile, list(cell_types), threshold=self.threshold,
                                       eps=self.eps)
        return ind.any(1)


class FilterGenesMatch:
    """Drop the genes whose names start with one of ``prefixes`` or end with
    one of ``suffixes`` (counterpart: filter.py:212). With ``case_sensitive``
    the patterns and the names are upper-cased before matching, as the JAX
    transform does (the flag's name says the opposite of what it does).
    ``select(gene_names)`` is the boolean mask of the genes kept, and
    ``__call__(x, gene_names)`` returns the kept columns and names in gene
    order."""

    def __init__(self, prefixes: Optional[List[str]] = None,
                 suffixes: Optional[List[str]] = None, case_sensitive: bool = False):
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
        logger.info("Removing %d genes by name match", int(remove.sum()))
        return ~remove

    def __call__(self, x, gene_names: Sequence) -> Tuple[np.ndarray, np.ndarray]:
        keep = np.nonzero(self.select(gene_names))[0]
        return x[:, keep], np.asarray(gene_names)[keep]


class FilterGenesCommon:
    """The genes expressed in every group of cells (counterpart:
    filter.py:178). The JAX transform groups one container's cells by split
    or batch; here each group is a ``(matrix, gene_names)`` pair, so the
    groups may name different genes. ``select(groups)`` returns the names
    with a nonzero absolute sum in every group, in sorted-name order as the
    JAX transform subsets by them; ``__call__(groups)`` returns each group's
    ``(columns, names)`` of those genes in that order."""

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

    def __call__(self, groups: Sequence[Tuple[object, Sequence]]) -> List[Tuple[object,
                                                                               np.ndarray]]:
        common = self.select(groups)
        out = []
        for x, names in groups:
            col = {g: j for j, g in enumerate(np.asarray(names).tolist())}
            idx = np.asarray([col[g] for g in common.tolist()], dtype=np.int64)
            out.append((x[:, idx], common))
        return out


GENE_SUMMARY_MODES = ("sum", "var", "cv", "rv")


class FilterGenes:
    """A gene filter on a per-gene summary statistic of a cells x genes
    matrix (counterpart: filter.py:241). ``mode`` is ``"sum"``, ``"var"``
    (the biased ``E[x²] - E[x]²``), ``"cv"`` (``sqrt(max(var, 0)) / mean``)
    or ``"rv"`` (``var / mean``), non-finite ratios read as 0, in the
    matrix's dtype as numpy computes them. ``__call__(x, gene_names)``
    returns the kept columns and names in sorted-name order."""

    def __init__(self, *, mode: str = "sum"):
        if mode not in GENE_SUMMARY_MODES:
            raise ValueError(f"Unknown summarization mode {mode!r}")
        self.mode = mode

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

    def __call__(self, x, gene_names: Sequence) -> Tuple[np.ndarray, np.ndarray]:
        idx = self.select(x, gene_names)
        return np.asarray(x)[:, idx], np.asarray(gene_names)[idx]


class FilterGenesPercentile(FilterGenes):
    """Keep the genes whose summary lies between its ``min_val`` and
    ``max_val`` percentiles, both bounds included (counterpart:
    filter.py:306)."""

    def __init__(self, min_val: Optional[float] = 1, max_val: Optional[float] = 99, *,
                 mode: str = "sum"):
        super().__init__(mode=mode)
        self.min_val = min_val
        self.max_val = max_val

    def _get_preserve_mask(self, gene_summary):
        lo = np.percentile(gene_summary, self.min_val) if self.min_val is not None else -np.inf
        hi = np.percentile(gene_summary, self.max_val) if self.max_val is not None else np.inf
        return (gene_summary >= lo) & (gene_summary <= hi)


class FilterGenesTopK(FilterGenes):
    """Keep the ``num_genes`` genes of the largest summary (``top``) or the
    smallest (counterpart: filter.py:327). Ties are broken as numpy's default
    ``argsort`` breaks them, which is the JAX transform's call."""

    def __init__(self, num_genes: int = 1000, top: bool = True, *, mode: str = "cv"):
        super().__init__(mode=mode)
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


__all__ = ["FilterGenes", "FilterGenesCommon", "FilterGenesMarker", "FilterGenesMatch",
           "FilterGenesPercentile", "FilterGenesTopK", "get_count"]
