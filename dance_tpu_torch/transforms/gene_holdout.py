"""Target-gene blocks and their predictor genes for DeepImpute, on arrays
(counterpart: ``GeneHoldout``, dance_tpu/transforms/gene_holdout.py:11-38).

The genes are split, in a random permutation, into blocks of
``batch_size`` targets; each block's predictors are the ``n_top`` genes
outside it of largest covariance with each of its targets, made unique.
Handed the matrix, the transform returns the lists; handed a port ``Data``,
it reads the feature matrix and writes them into ``uns["targets"]`` and
``uns["predictors"]``, as JAX's does, and it is registered under JAX's key
in the port's own registry. Both draw from ``np.random.default_rng(random_state)`` and compute
``np.cov`` in float64, so the lists are the JAX package's.
"""

from typing import List, Optional, Tuple

import numpy as np

from dance_tpu_torch.data.base import BaseData
from dance_tpu_torch.registry import register_preprocessor
from dance_tpu_torch.transforms.base import BaseTransform


@register_preprocessor("split", "gene")
class GeneHoldout(BaseTransform):
    """``__call__(x)`` returns ``(targets, predictors)``: lists of index
    arrays, one pair per block (counterpart: gene_holdout.py:11)."""

    _DISPLAY_ATTRS = ("batch_size", "n_top")

    def __init__(self, n_top: int = 5, batch_size: int = 512, random_state: Optional[int] = None,
                 **kwargs):
        super().__init__(**kwargs)
        self.n_top = n_top
        self.batch_size = batch_size
        self.random_state = random_state

    def __call__(self, x) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        if isinstance(x, BaseData):
            x.data.uns["targets"], x.data.uns["predictors"] = self(
                x.get_feature(return_type="numpy"))
            return x
        rng = np.random.default_rng(self.random_state)
        feat = np.asarray(x, dtype=np.float64)
        n_genes = feat.shape[1]
        targets = np.split(rng.permutation(n_genes),
                           range(self.batch_size, n_genes, self.batch_size))
        cov = np.cov(feat, rowvar=False)
        predictors = []
        for targs in targets:
            others = np.setdiff1d(np.arange(n_genes), targs)
            order = np.argsort(-cov[np.ix_(targs, others)], axis=1)[:, :self.n_top]
            predictors.append(np.unique(others[order.ravel()]))
        return targets, predictors


__all__ = ["GeneHoldout"]
