"""SingleCellNet cell-type annotation: a random forest over binary top
gene-pair features, with an extra "unknown" class trained on doubly
shuffled pseudo-cells.

Counterpart: dance_tpu/modules/single_modality/cell_type_annotation/
singlecellnet.py. The forest is :class:`~dance_tpu_torch.ops.forest.
RandomForest`; :func:`singlecellnet_preprocess` is the array front of
``preprocessing_pipeline`` (``normalize_total(1e4)``, ``log1p``,
:class:`~dance_tpu_torch.transforms.scn_feature.SCNFeature`): it runs the
pipeline on a matrix wrapped in a ``Data``.

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

from dance_tpu_torch.data import Frame
from dance_tpu_torch.modules.base import BaseClassificationMethod, wrap_matrix
from dance_tpu_torch.ops.forest import ForestDraws, RandomForest
from dance_tpu_torch.transforms.interface import AnnDataTransform
from dance_tpu_torch.transforms.misc import Compose, SetConfig
from dance_tpu_torch.transforms.scn_feature import SCNFeature
from dance_tpu_torch.utils import as_numpy


def singlecellnet_preprocess(x, gene_names: Sequence, cell_types,
                             split_idx: Optional[Sequence[int]] = None, *,
                             normalize: bool = True, num_top_genes: int = 10,
                             num_top_gene_pairs: int = 25) -> Tuple[np.ndarray, List[str]]:
    """:meth:`SingleCellNet.preprocessing_pipeline` on the raw (cells x genes)
    counts ``x`` named ``gene_names``, wrapped in a ``Data`` with
    ``cell_types`` one-hot in ``obsm["cell_type"]`` and ``split_idx`` (every
    cell when None) as its split ``"train"``, on which the gene pairs are
    chosen. Returns the (cells, pairs) float64 features and their
    ``"g1&g2"`` names."""
    types, codes = np.unique(np.asarray(cell_types), return_inverse=True)
    data = wrap_matrix(x, gene_names)
    data.data.obsm["cell_type"] = Frame(np.eye(len(types), dtype=np.float32)[codes],
                                        index=data.data.obs_names, columns=list(types))
    data.set_split_idx("train", np.arange(x.shape[0]) if split_idx is None else split_idx)
    SingleCellNet.preprocessing_pipeline(normalize=normalize, num_top_genes=num_top_genes,
                                         num_top_gene_pairs=num_top_gene_pairs,
                                         log_level="WARNING")(data)
    feat = data.data.obsm["SCNFeature"]
    return feat.to_numpy(), list(feat.columns)


class SingleCellNet(BaseClassificationMethod):
    """SingleCellNet (counterpart: singlecellnet.py:18). ``predict`` returns
    the class index, the pseudo-cells' class being ``y.max() + 1``."""

    def __init__(self, num_trees: int = 100, device="auto", max_depth: int = 10):
        self.num_trees = num_trees
        self.device = device
        self.max_depth = max_depth
        self.model: Optional[RandomForest] = None

    @staticmethod
    def preprocessing_pipeline(normalize: bool = True, num_top_genes: int = 10,
                               num_top_gene_pairs: int = 25, log_level: str = "INFO") -> Compose:
        """With ``normalize``, ``normalize_total`` to 1e4 and ``log1p``; then
        the gene-pair features chosen on split ``"train"`` (``SCNFeature``),
        the labels in ``obsm["cell_type"]`` (counterpart:
        singlecellnet.py:28-39)."""
        transforms = []
        if normalize:
            transforms.append(AnnDataTransform("sc.pp.normalize_total", target_sum=1e4))
            transforms.append(AnnDataTransform("sc.pp.log1p"))
        transforms.append(SCNFeature(num_top_genes=num_top_genes,
                                     num_top_gene_pairs=num_top_gene_pairs))
        transforms.append(SetConfig({"feature_channel": "SCNFeature",
                                     "label_channel": "cell_type"}))
        return Compose(*transforms, log_level=log_level)

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
