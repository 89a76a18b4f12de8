"""Target-gene blocks and their predictor genes for DeepImpute, on arrays
(counterpart: ``GeneHoldout``, dance_tpu/transforms/gene_holdout.py:11-38).

The genes are split, in a random permutation, into blocks of
``batch_size`` targets; each block's predictors are the ``n_top`` genes
outside it of largest covariance with each of its targets, made unique.
The JAX transform reads the feature matrix of a ``Data`` container and
writes the lists into its ``uns``; the port takes the matrix and returns
them. Both draw from ``np.random.default_rng(random_state)`` and compute
``np.cov`` in float64, so the lists are the JAX package's.
"""

from typing import List, Optional, Tuple

import numpy as np


class GeneHoldout:
    """``__call__(x)`` returns ``(targets, predictors)``: lists of index
    arrays, one pair per block (counterpart: gene_holdout.py:11)."""

    def __init__(self, n_top: int = 5, batch_size: int = 512, random_state: Optional[int] = None):
        self.n_top = n_top
        self.batch_size = batch_size
        self.random_state = random_state

    def __call__(self, x) -> Tuple[List[np.ndarray], List[np.ndarray]]:
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
