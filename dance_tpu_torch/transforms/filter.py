"""Marker-gene selection from a cell-type profile, on arrays (counterpart:
``FilterGenesMarker``, dance_tpu/transforms/filter.py:358-404), and the
ratio thresholds of the scanpy filters (``_get_count``, filter.py:26).

A gene is a marker of a type when its log fold change against the mean of
the other types' profiles passes ``threshold``; the filter keeps the genes
that mark any type. The JAX transform reads the profile from ``varm``,
writes the per-type indicator there and subsets the container's genes; the
port returns the indicator and the mask. The other gene filters of that
file are not ported yet (ROADMAP Queue 1); the modules apply ``FilterCellsType``
and ``FilterGenesScanpy`` in their ``*_preprocess``.
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np

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


__all__ = ["FilterGenesMarker", "get_count"]
