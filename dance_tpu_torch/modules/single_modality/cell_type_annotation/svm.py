"""SVM cell-type annotation: the RBF-kernel one-vs-rest SVM of
:class:`~dance_tpu_torch.ops.linear_model.DeviceSVC` on weighted gene-PCA
features.

Counterpart: dance_tpu/modules/single_modality/cell_type_annotation/svm.py.
The JAX ``backend="sklearn"`` (sklearn's ``SVC``) is not ported: the card's
machine has no scikit-learn, so it raises. :func:`svm_preprocess` is the
array form of ``preprocessing_pipeline`` (``WeightedFeaturePCA`` on the
training cells).
"""

from typing import Optional

import numpy as np

from dance_tpu_torch.modules.base import BaseClassificationMethod
from dance_tpu_torch.ops.linear_model import DeviceSVC
from dance_tpu_torch.transforms.cell_feature import weighted_feature_pca
from dance_tpu_torch.utils import as_numpy


def svm_preprocess(x, train_idx, n_components: int = 400, *, device="auto") -> np.ndarray:
    """``SVM.preprocessing_pipeline`` on arrays: the gene PCA of the training
    cells ``x[train_idx]``, then every cell's row-normalised expression times
    the gene embedding (:func:`weighted_feature_pca`). Returns the float32
    (cells, k) features."""
    x = np.asarray(x, np.float32)
    return weighted_feature_pca(x[np.asarray(train_idx)], x, n_components, device=device)[0]


class SVM(BaseClassificationMethod):
    """SVM annotation (counterpart: svm.py:18). ``fit(x, y)`` takes features
    and integer or one-hot labels (the argmax of a one-hot row)."""

    def __init__(self, args=None, prj_path: str = "./", random_state: Optional[int] = None,
                 backend: str = "device", device="auto"):
        if backend == "sklearn":
            raise NotImplementedError("SVM(backend='sklearn') is not ported: the card's machine "
                                      "has no scikit-learn; the device SVC is the port's head")
        self.args = args
        self.random_state = random_state
        self._mdl = DeviceSVC(random_state=random_state or 0, device=device)

    preprocessing_pipeline = staticmethod(svm_preprocess)

    def fit(self, x, y):
        y = as_numpy(y)
        if y.ndim == 2:
            y = y.argmax(1)
        self._mdl.fit(as_numpy(x), y)
        return self

    def predict(self, x) -> np.ndarray:
        return self._mdl.predict(as_numpy(x))

    def predict_proba(self, x) -> np.ndarray:
        return self._mdl.predict_proba(as_numpy(x))


__all__ = ["SVM", "svm_preprocess"]
