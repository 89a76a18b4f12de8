"""Entry masks for imputation (counterpart: dance_tpu/transforms/mask.py,
``CellwiseMaskData`` :12-84 and ``MaskData`` :87-111).

Handed the cells x genes matrix, the transforms return the masks. Handed a
port ``Data``, ``CellwiseMaskData`` reads its feature channel and writes the
masks into its ``layers``, as JAX's does; it is registered under JAX's key
in the port's own registry. Both draw from ``np.random.default_rng(seed)``
(with ``scipy.stats.expon`` weights for ``CellwiseMaskData``) in the same
order, so the masks are the JAX package's bit for bit.
"""

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
from scipy.stats import expon

from dance_tpu_torch.data.base import BaseData
from dance_tpu_torch.registry import register_preprocessor
from dance_tpu_torch.transforms.base import BaseTransform


@register_preprocessor("split", "entry")
class CellwiseMaskData(BaseTransform):
    """Per-cell masking of positive entries (counterpart: mask.py:13). In
    each cell with more than ``min_gene_counts`` positive entries,
    ``floor(mask_rate x`` that count``)`` of them leave the train mask,
    drawn without replacement with weights ``expon.pdf(value, 0, 20)``
    (``"exp"``) or uniform; they go to the valid mask, or with
    ``add_test_mask`` a tenth (at least one) to valid and the rest to test.
    ``__call__(x)`` returns ``(train_mask, valid_mask, test_mask)``;
    ``__call__(data)`` masks the entries of ``X`` and writes the three into
    ``layers["train_mask"]``, ``["valid_mask"]`` and ``["test_mask"]``."""

    _DISPLAY_ATTRS = ("distr", "mask_rate", "seed", "min_gene_counts", "add_test_mask")

    def __init__(self, distr: Optional[str] = "exp", mask_rate: float = 0.1,
                 seed: Optional[int] = None, min_gene_counts: int = 5,
                 add_test_mask: bool = False, **kwargs):
        super().__init__(**kwargs)
        if not 0.0 <= mask_rate <= 1.0:
            raise ValueError(f"mask_rate must be in [0, 1], got {mask_rate}")
        self.distr = distr
        self.mask_rate = mask_rate
        self.seed = seed
        self.min_gene_counts = min_gene_counts
        self.add_test_mask = add_test_mask

    def _get_probs(self, vec: np.ndarray) -> np.ndarray:
        if self.distr == "exp":
            prob = expon.pdf(vec, 0, 20)
        elif self.distr == "uniform":
            prob = np.ones(len(vec))
        else:
            raise ValueError(f"Unknown distribution {self.distr!r}; options: exp, uniform")
        s = prob.sum()
        return prob / s if s > 1e-9 else np.full(len(vec), 1.0 / max(len(vec), 1))

    def __call__(self, x) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if isinstance(x, BaseData):
            masks = self(x.get_feature(return_type="sparse"))
            for name, mask in zip(("train_mask", "valid_mask", "test_mask"), masks):
                x.data.layers[name] = mask
            return x
        rng = np.random.default_rng(self.seed)
        feat = sp.csr_matrix(x)
        n_cells, n_genes = feat.shape
        train_mask = np.ones((n_cells, n_genes), dtype=bool)
        valid_mask = np.zeros((n_cells, n_genes), dtype=bool)
        test_mask = np.zeros((n_cells, n_genes), dtype=bool)
        for c in range(n_cells):
            start, end = feat.indptr[c], feat.indptr[c + 1]
            ind_pos = feat.indices[start:end]
            vals = feat.data[start:end]
            if len(ind_pos) <= self.min_gene_counts:
                continue
            n_masked = int(np.floor(len(ind_pos) * self.mask_rate))
            if n_masked <= 0:
                continue
            if n_masked >= len(ind_pos):
                self.logger.warning("Too many genes masked for cell %d (%d/%d)", c, n_masked,
                               len(ind_pos))
                n_masked = 1 + int(np.floor(0.5 * len(ind_pos)))
            chosen = rng.choice(len(ind_pos), n_masked, p=self._get_probs(vals), replace=False)
            cols = ind_pos[chosen]
            train_mask[c, cols] = False
            if self.add_test_mask:
                n_valid = max(int(round(0.1 * len(cols))), 1)
                vm = np.zeros(len(cols), dtype=bool)
                vm[rng.choice(len(cols), n_valid, replace=False)] = True
                valid_mask[c, cols[vm]] = True
                test_mask[c, cols[~vm]] = True
            else:
                valid_mask[c, cols] = True
        return train_mask, valid_mask, test_mask


def entry_masks(data) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The train, valid and test masks that :class:`CellwiseMaskData` wrote
    into a ``Data``'s ``layers``; without them (a pipeline run without
    ``mask``) an all-ones train mask and empty others."""
    layers = data.data.layers
    if "train_mask" in layers:
        return tuple(np.asarray(layers[k]) for k in ("train_mask", "valid_mask", "test_mask"))
    shape = data.data.shape
    return np.ones(shape, bool), np.zeros(shape, bool), np.zeros(shape, bool)


class MaskData:
    """Global masking of nonzero entries (counterpart: mask.py:87):
    ``floor(mask_rate x`` the number of nonzero entries``)`` of them, drawn
    uniformly without replacement in row-major order, leave the train mask.
    ``__call__(x)`` returns ``(train_mask, valid_mask)``, the second the
    first's complement, as JAX writes them."""

    def __init__(self, mask_rate: float = 0.1, seed: Optional[int] = None):
        self.mask_rate = mask_rate
        self.seed = seed

    def __call__(self, x) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self.seed)
        feat = np.asarray(x.toarray() if sp.issparse(x) else x)
        train_mask = np.ones(feat.shape, dtype=bool)
        row, col = np.nonzero(feat)
        n_masked = int(np.floor(len(row) * self.mask_rate))
        idx = rng.choice(len(row), size=n_masked, replace=False)
        train_mask[row[idx], col[idx]] = False
        return train_mask, ~train_mask


__all__ = ["CellwiseMaskData", "MaskData", "entry_masks"]
