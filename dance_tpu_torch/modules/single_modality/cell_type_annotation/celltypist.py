"""CellTypist cell-type annotation: one-vs-rest logistic regression (or
its SGD form, with an optional two-pass feature selection) over scaled
expression, and an optional majority vote over a Leiden over-clustering of
the query.

Counterpart: dance_tpu/modules/single_modality/cell_type_annotation/
celltypist.py (``Model`` :23, ``AnnotationResult`` :62, ``Classifier`` :79,
``_device_standardize`` :112, ``Celltypist.fit`` :136-213, ``predict``
:215-229, ``_majority_voting`` :232-245). The heads are
:mod:`dance_tpu_torch.ops.linear_model`'s; the over-clustering is the
ported ``pca``, ``knn_graph(15)`` and ``leiden``.

Where this differs from the JAX package:

- No pandas: :class:`AnnotationResult` keeps the labels as a dict of named
  arrays (``predicted_labels``, then ``over_clustering`` and
  ``majority_voting``) and the decision and probability matrices as arrays
  whose columns are ``cell_types``. ``over_cluster`` returns the labels as
  a string array.
- No scikit-learn: the scaler is :class:`Scaler` (sklearn's
  ``StandardScaler`` surface: ``mean_``, ``scale_``, ``var_``,
  ``transform``), fitted on the device; ``fit(backend=...)`` other than
  ``"device"``, ``LRClassifier_celltypist`` and ``SGDClassifier_celltypist``
  raise, since the card's machine has no scikit-learn.
- The SGD rows are drawn by :func:`~dance_tpu_torch.ops.linear_model.sgd_rows`.
"""

from typing import Dict, Optional

import numpy as np
import torch

from dance_tpu_torch.modules.base import BaseClassificationMethod
from dance_tpu_torch.ops.cluster import leiden
from dance_tpu_torch.ops.linalg import pca
from dance_tpu_torch.ops.linear_model import DeviceLogisticRegression, DeviceSGDLogistic
from dance_tpu_torch.ops.neighbors import knn_graph
from dance_tpu_torch.settings import logger
from dance_tpu_torch.transforms.misc import SetConfig
from dance_tpu_torch.utils import as_numpy, resolve_device

_NO_SKLEARN = ("is not ported: the card's machine has no scikit-learn; use "
               "Celltypist.fit(backend='device'), the device heads")


class Scaler:
    """sklearn's ``StandardScaler`` state as CellTypist uses it: ``mean_``,
    ``scale_`` (the population standard deviation, 0 read as 1), ``var_``;
    ``transform`` is ``(x - mean_) / scale_`` in the input's float dtype."""

    def __init__(self, mean: np.ndarray, scale: np.ndarray, n_samples: int):
        self.mean_, self.scale_ = mean, scale
        self.var_ = scale ** 2
        self.n_features_in_ = len(mean)
        self.n_samples_seen_ = n_samples

    def subset(self, index: np.ndarray):
        """Keep the statistics of the genes ``index`` (feature selection)."""
        self.mean_, self.var_, self.scale_ = (a[index] for a in (self.mean_, self.var_,
                                                                 self.scale_))
        self.n_features_in_ = len(index)

    def transform(self, x) -> np.ndarray:
        x = np.array(x, dtype=np.float32 if np.asarray(x).dtype == np.float32 else np.float64)
        x -= self.mean_
        x /= self.scale_
        return x


def _device_standardize(x: torch.Tensor):
    """Standardise every gene with its population variance, a zero scale read
    as 1, and clip at 10 (counterpart: celltypist.py:112)."""
    mean = x.mean(0)
    scale = torch.sqrt(x.var(0, correction=0))
    scale = torch.where(scale == 0, 1.0, scale)
    return torch.clamp((x - mean) / scale, max=10.0), mean, scale


class Model:
    """A trained classifier and its scaler (counterpart: celltypist.py:23)."""

    def __init__(self, clf, scaler: Scaler, description):
        self.classifier = clf
        self.scaler = scaler
        self.description = description

    @property
    def cell_types(self) -> np.ndarray:
        return self.classifier.classes_

    @property
    def features(self) -> np.ndarray:
        return self.classifier.features

    def __repr__(self):
        return (f"CellTypist model with {len(self.cell_types)} cell types and "
                f"{len(self.features)} features")

    def predict_labels_and_prob(self, indata):
        indata = np.clip(self.scaler.transform(indata), None, 10)
        decision_mat = self.classifier.decision_function(indata)
        if decision_mat.ndim == 1:
            decision_mat = np.column_stack([-decision_mat, decision_mat])
        prob_mat = 1 / (1 + np.exp(-decision_mat))
        return self.cell_types[prob_mat.argmax(1)], prob_mat, decision_mat

    def extract_top_markers(self, cell_type, top_n: int = 10,
                            only_positive: bool = True) -> np.ndarray:
        idx = list(self.cell_types).index(cell_type)
        coef = self.classifier.coef_
        coef = coef[idx] if coef.ndim == 2 else coef
        order = np.argsort(-coef if only_positive else -np.abs(coef))
        return np.asarray(self.features)[order[:top_n]]


class AnnotationResult:
    """Predictions of the query cells (counterpart: celltypist.py:62):
    ``predicted_labels`` is a dict of named per-cell arrays; the decision and
    probability matrices are (cells, types) arrays with columns
    ``cell_types``."""

    def __init__(self, labels: np.ndarray, decision_mat: np.ndarray, prob_mat: np.ndarray,
                 cell_types):
        self.predicted_labels: Dict[str, np.ndarray] = {"predicted_labels": labels}
        self.decision_matrix = decision_mat
        self.probability_matrix = prob_mat
        self.cell_types = list(cell_types)

    def summary_frequency(self, by: str = "predicted_labels"):
        """``(values, counts)`` of a label column, most frequent first and
        ties in order of first appearance, as pandas' ``value_counts``."""
        values, first, counts = np.unique(self.predicted_labels[by], return_index=True,
                                          return_counts=True)
        order = np.argsort(first, kind="stable")
        order = order[np.argsort(-counts[order], kind="stable")]
        return values[order], counts[order]

    def __repr__(self):
        return f"AnnotationResult for {len(self.predicted_labels['predicted_labels'])} query cells"


class Classifier:
    """The query side (counterpart: celltypist.py:79)."""

    def __init__(self, x, model: Model, device="auto"):
        self.indata = np.asarray(x)
        self.model = model
        self.device = resolve_device(device)

    def celltype(self) -> AnnotationResult:
        labels, prob, decision = self.model.predict_labels_and_prob(self.indata)
        return AnnotationResult(labels, decision, prob, self.model.cell_types)

    def over_cluster(self, resolution: Optional[float] = None) -> np.ndarray:
        """Leiden communities of the query's 15-NN graph in its first 50
        principal components, as strings (counterpart: celltypist.py:95);
        the resolution grows with the cell count when not given."""
        n = self.indata.shape[0]
        if resolution is None:
            resolution = (5 if n < 5000 else 10 if n < 20000 else 15 if n < 40000
                          else 20 if n < 100000 else 25)
        x = torch.as_tensor(self.indata.astype(np.float32), device=self.device)
        emb = pca(x, min(50, min(self.indata.shape) - 1)).embedding.cpu().numpy()
        adj = knn_graph(emb, min(15, n - 1), mode="connectivity", include_self=False)
        return leiden(adj, resolution=resolution).astype(str)


class Celltypist(BaseClassificationMethod):
    """CellTypist (counterpart: celltypist.py:122). The arithmetic runs on
    ``device`` (default the CUDA card; the CPU only when named)."""

    def __init__(self, majority_voting: bool = False, clf=None, scaler=None, description=None,
                 device="auto"):
        self.majority_voting = majority_voting
        self.classifier = clf
        self.scaler = scaler
        self.description = description
        self.device = resolve_device(device)

    @staticmethod
    def preprocessing_pipeline(log_level: str = "INFO") -> SetConfig:
        """The labels in ``obsm["cell_type"]``; the features are ``X`` as it
        stands (counterpart: celltypist.py:133-134)."""
        return SetConfig({"label_channel": "cell_type"}, log_level=log_level)

    def fit(self, indata, labels=None, C: float = 1.0, solver: Optional[str] = None,
            max_iter: int = 1000, n_jobs: Optional[int] = None, use_SGD: bool = False,
            alpha: float = 0.0001, mini_batch: bool = False, batch_number: int = 100,
            batch_size: int = 1000, epochs: int = 10, balance_cell_type: bool = False,
            feature_selection: bool = False, top_genes: int = 300, backend: str = "device",
            **kwargs):
        """Standardise on the device, train the LR head (``C``, ``max_iter``,
        to its ``tol`` stop) or, with ``use_SGD`` or ``feature_selection``,
        the SGD head (``max_iter`` full-batch steps, or ``epochs x
        min(batch_number, n // batch_size)`` minibatch steps); with
        ``feature_selection`` retrain on the union of every type's
        ``top_genes`` largest ``|coef|`` (counterpart: celltypist.py:136).
        ``solver``, ``n_jobs`` and ``balance_cell_type`` are sklearn's and
        have no effect on the device heads, as in JAX."""
        if backend != "device":
            raise NotImplementedError(f"Celltypist.fit(backend={backend!r}) {_NO_SKLEARN}")
        labels = as_numpy(labels)
        if labels.ndim == 2:
            labels = labels.argmax(1)
        genes = np.arange(indata.shape[1]).astype(str)
        x = (indata.to(self.device, torch.float32) if isinstance(indata, torch.Tensor)
             else torch.as_tensor(np.asarray(indata, np.float32), device=self.device))
        x_s, mean, scale = _device_standardize(x)
        scaler = Scaler(mean.cpu().numpy(), scale.cpu().numpy(), x.shape[0])

        def train(xs, y):
            if use_SGD or feature_selection:
                steps = (epochs * min(batch_number, max(len(y) // batch_size, 1))
                         if mini_batch else max_iter)
                return DeviceSGDLogistic(alpha=alpha, epochs=steps,
                                         batch_size=batch_size if mini_batch else 0,
                                         device=self.device).fit(xs, y)
            return DeviceLogisticRegression(C=C, epochs=max_iter, device=self.device).fit(xs, y)

        classifier = train(x_s, labels)
        if feature_selection:
            if len(genes) <= top_genes:
                raise ValueError(f"Only {len(genes)} genes; cannot select {top_genes}")
            gene_index = np.unique(np.argpartition(np.abs(classifier.coef_), -top_genes,
                                                   axis=1)[:, -top_genes:])
            logger.info("%d features selected", len(gene_index))
            genes = genes[gene_index]
            classifier = train(x_s[:, torch.as_tensor(gene_index, device=self.device)], labels)
            scaler.subset(gene_index)
        classifier.features = genes
        self.classifier = classifier
        self.scaler = scaler
        self.description = {"number_celltypes": len(classifier.classes_)}
        return self

    def predict(self, x, as_obj: bool = False, over_clustering=None, min_prop: float = 0.0):
        """The predicted labels, or with ``majority_voting`` each
        over-cluster's majority label; ``as_obj`` returns the
        :class:`AnnotationResult` (counterpart: celltypist.py:215)."""
        clf = Classifier(as_numpy(x), Model(self.classifier, self.scaler, self.description),
                         device=self.device)
        predictions = clf.celltype()
        if self.majority_voting:
            if over_clustering is None:
                over_clustering = clf.over_cluster()
            predictions = self._majority_voting(predictions, over_clustering, min_prop)
        if as_obj:
            return predictions
        cols = predictions.predicted_labels
        return cols["majority_voting" if "majority_voting" in cols else "predicted_labels"]

    @staticmethod
    def _majority_voting(predictions: AnnotationResult, over_clustering,
                         min_prop: float = 0.0) -> AnnotationResult:
        """Give each over-cluster its most frequent predicted label: the
        first of the sorted labels at a tie, as ``pd.crosstab(...)
        .idxmax()`` picks it; a cluster whose share of that label is below
        ``min_prop`` gets ``"Heterogeneous"`` (counterpart: celltypist.py:232)."""
        clusters = np.asarray(over_clustering)
        pred = predictions.predicted_labels["predicted_labels"]
        rows, r_idx = np.unique(pred, return_inverse=True)
        cols, c_idx = np.unique(clusters, return_inverse=True)
        votes = np.zeros((len(rows), len(cols)), np.int64)
        np.add.at(votes, (r_idx, c_idx), 1)
        majority = rows[votes.argmax(0)]
        low = votes.max(0) / votes.sum(0) < min_prop
        if low.any():
            majority = majority.astype(object)
            majority[low] = "Heterogeneous"
        predictions.predicted_labels["over_clustering"] = clusters
        predictions.predicted_labels["majority_voting"] = majority[c_idx]
        return predictions


def LRClassifier_celltypist(*args, **kwargs):
    """sklearn's ``LogisticRegression`` trainer (counterpart: celltypist.py:271)."""
    raise NotImplementedError(f"LRClassifier_celltypist {_NO_SKLEARN}")


def SGDClassifier_celltypist(*args, **kwargs):
    """sklearn's ``SGDClassifier`` trainer (counterpart: celltypist.py:288)."""
    raise NotImplementedError(f"SGDClassifier_celltypist {_NO_SKLEARN}")


__all__ = ["AnnotationResult", "Celltypist", "Classifier", "LRClassifier_celltypist", "Model",
           "SGDClassifier_celltypist", "Scaler"]
