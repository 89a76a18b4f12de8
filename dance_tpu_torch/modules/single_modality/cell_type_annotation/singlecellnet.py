"""SingleCellNet cell-type annotation: a random forest over binary top
gene-pair features, with an extra "unknown" class trained on doubly
shuffled pseudo-cells.

Counterpart: dance_tpu/modules/single_modality/cell_type_annotation/
singlecellnet.py. The forest is :class:`~dance_tpu_torch.ops.forest.
RandomForest`; :func:`singlecellnet_preprocess` is the array form of
``preprocessing_pipeline`` (``normalize_total(1e4)``, ``log1p``,
:class:`~dance_tpu_torch.transforms.scn_feature.SCNFeature`).

Where this differs from the JAX package:

- ``device`` is the torch device (default the CUDA card; the CPU only when
  named). JAX's ``device="cpu"`` meant sklearn's ``RandomForestClassifier``;
  the card's machine has no scikit-learn, so that forest is not ported.
- ``randomize`` draws the pseudo-cells from ``rng`` (any object with
  numpy's ``choice``), by default ``np.random.default_rng(random_state)``;
  JAX draws them from numpy's global state. A ``np.random.RandomState``
  seeded as the global state was gives JAX's pseudo-cells.
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from dance_tpu_torch.modules.base import BaseClassificationMethod
from dance_tpu_torch.ops.forest import ForestDraws, RandomForest
from dance_tpu_torch.sc.pp import log1p, normalize_total
from dance_tpu_torch.transforms.scn_feature import SCNFeature
from dance_tpu_torch.utils import as_numpy


def singlecellnet_preprocess(x, gene_names: Sequence, cell_types,
                             split_idx: Optional[Sequence[int]] = None, *,
                             normalize: bool = True, num_top_genes: int = 10,
                             num_top_gene_pairs: int = 25) -> Tuple[np.ndarray, List[str]]:
    """``SingleCellNet.preprocessing_pipeline`` on arrays (singlecellnet.py:
    27-39): with ``normalize``, ``normalize_total(target_sum=1e4)`` and
    ``log1p`` of the raw (cells x genes) counts; then the gene pairs chosen
    on the cells ``split_idx`` (the training split). Returns the (cells,
    pairs) float64 features and their ``"g1&g2"`` names."""
    if normalize:
        x = log1p(normalize_total(x, target_sum=1e4))
    x = x.toarray() if sp.issparse(x) else np.asarray(x)
    return SCNFeature(num_top_genes=num_top_genes,
                      num_top_gene_pairs=num_top_gene_pairs)(x, gene_names, cell_types, split_idx)


class SingleCellNet(BaseClassificationMethod):
    """SingleCellNet (counterpart: singlecellnet.py:18). ``predict`` returns
    the class index, the pseudo-cells' class being ``y.max() + 1``."""

    def __init__(self, num_trees: int = 100, device="auto", max_depth: int = 10):
        self.num_trees = num_trees
        self.device = device
        self.max_depth = max_depth
        self.model: Optional[RandomForest] = None

    preprocessing_pipeline = staticmethod(singlecellnet_preprocess)

    @staticmethod
    def randomize(exp, num: int = 50, rng=None) -> np.ndarray:
        """``num`` pseudo-cells: every cell's genes shuffled, then every
        gene's cells, as the JAX method does (singlecellnet.py:41)."""
        rng = np.random.default_rng() if rng is None else rng
        exp = as_numpy(exp)
        rand = np.array([rng.choice(x, len(x), replace=False) for x in exp]).T
        rand = np.array([rng.choice(x, len(x), replace=False) for x in rand]).T
        return rand[:num]

    def fit(self, x, y, num_rand: int = 100, stratify: bool = True,
            random_state: Optional[int] = 100, rng=None, draws: Optional[ForestDraws] = None):
        """Add ``num_rand`` pseudo-cells as the class ``y.max() + 1`` and grow
        the forest, class-balanced with ``stratify`` (counterpart:
        singlecellnet.py:48). ``rng`` draws the pseudo-cells (default
        ``np.random.default_rng(random_state)``); ``draws`` replaces the
        forest's own (parity tests pass JAX's)."""
        x = as_numpy(x)
        y = as_numpy(y)
        if y.ndim == 2:
            y = y.argmax(1)
        rng = np.random.default_rng(random_state) if rng is None else rng
        x_rand = self.randomize(x, num=num_rand, rng=rng)
        x_comb = np.vstack((x, x_rand))
        y_comb = np.concatenate((y, np.full(x_rand.shape[0], y.max() + 1)))
        self.model = RandomForest(n_estimators=self.num_trees, max_depth=self.max_depth,
                                  random_state=random_state,
                                  class_weight="balanced" if stratify else None,
                                  device=self.device)
        self.model.fit(x_comb, y_comb, draws=draws)
        return self

    def predict_proba(self, x) -> np.ndarray:
        return self.model.predict_proba(as_numpy(x))

    def predict(self, x) -> np.ndarray:
        return self.predict_proba(x).argmax(1)


__all__ = ["SingleCellNet", "singlecellnet_preprocess"]
