"""SVM cell-type annotation: the RBF-kernel one-vs-rest SVM of
:class:`~dance_tpu_torch.ops.linear_model.DeviceSVC` on weighted gene-PCA
features.

Counterpart: dance_tpu/modules/single_modality/cell_type_annotation/svm.py.
The JAX ``backend="sklearn"`` (sklearn's ``SVC``) is not ported: the card's
machine has no scikit-learn, so it raises. :func:`svm_preprocess` is the
array front of ``preprocessing_pipeline`` (``WeightedFeaturePCA`` on the
training cells): it runs the pipeline on a matrix wrapped in a ``Data``.
"""

from typing import Optional

import numpy as np

from dance_tpu_torch.modules.base import BaseClassificationMethod, wrap_matrix
from dance_tpu_torch.ops.linear_model import DeviceSVC
from dance_tpu_torch.transforms.cell_feature import WeightedFeaturePCA
from dance_tpu_torch.transforms.misc import Compose, SetConfig
from dance_tpu_torch.utils import as_numpy


def svm_preprocess(x, train_idx, n_components: int = 400, *, device="auto") -> np.ndarray:
    """:meth:`SVM.preprocessing_pipeline` on ``x`` (cells x genes) wrapped in
    a ``Data`` whose split ``"train"`` is ``train_idx``, for a caller that
    holds a matrix. Returns the float32 (cells, k) features."""
    data = wrap_matrix(x)
    data.set_split_idx("train", np.asarray(train_idx))
    SVM.preprocessing_pipeline(n_components, log_level="WARNING", device=device)(data)
    return data.data.obsm["WeightedFeaturePCA"]


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
        self.device = device  # the pipeline's too (``preprocess``)
        self._mdl = DeviceSVC(random_state=random_state or 0, device=device)

    @staticmethod
    def preprocessing_pipeline(n_components: int = 400, log_level: str = "INFO",
                               device="auto") -> Compose:
        """The gene PCA of the training cells, then every cell's
        row-normalised expression times the gene embedding
        (``WeightedFeaturePCA`` on ``device``), the labels in
        ``obsm["cell_type"]`` (counterpart: svm.py:33-39)."""
        return Compose(
            WeightedFeaturePCA(n_components=n_components, split_name="train", device=device),
            SetConfig({"feature_channel": "WeightedFeaturePCA", "label_channel": "cell_type"}),
            log_level=log_level,
        )

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
