"""SpatialDecon: log-normal regression deconvolution.

Counterpart: dance_tpu/modules/spatial/cell_type_deconvo/spatialdecon.py
(``msle`` :23, ``SpatialDecon`` :28, ``MSLELoss`` :93). Each spot's
expression is modelled as the type profiles (genes x types) times the
spot's non-negative weights, plus a per-spot bias with ``bias``; Adam
minimises the mean squared log error, the weights clamped at 0 after every
step (the loss reads ``max(w, 0)``, whose gradient at 0 is halved, as JAX's
``maximum`` and torch's give it). The portions are the row-normalised
weights. SpatialDecon runs no TPU kernel: a small GEMM, its gradient and
elementwise passes a step. :func:`spatialdecon_preprocess` is the array front
of ``preprocessing_pipeline`` (``CellTopicProfile`` of the reference): it
runs the pipeline on the reference wrapped in a ``Data``.
"""

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dance_tpu_torch.modules.base import BaseRegressionMethod, resolve_score_func
from dance_tpu_torch.modules.spatial.cell_type_deconvo.dstg import deconvo_container
from dance_tpu_torch.settings import logger
from dance_tpu_torch.transforms.misc import Compose, SetConfig
from dance_tpu_torch.transforms.pseudobulk import CellTopicProfile
from dance_tpu_torch.utils import as_numpy, resolve_device


def msle(pred: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    """Mean squared log error (counterpart: spatialdecon.py:23)."""
    return torch.mean((torch.log1p(pred) - torch.log1p(true)) ** 2)


def spatialdecon_preprocess(x_ref, ref_annot, ct_select="auto") -> Tuple[np.ndarray, List[str]]:
    """:meth:`SpatialDecon.preprocessing_pipeline` on the reference cells
    ``x_ref`` (cells x genes) typed ``ref_annot``, wrapped in a ``Data`` as
    split ``"ref"`` (:func:`deconvo_container`), for a caller that holds a
    matrix. Returns the (genes x types) median profile and its type names."""
    data = deconvo_container(x_ref, ref_annot)
    SpatialDecon.preprocessing_pipeline(ct_select, log_level="WARNING")(data)
    profile = data.data.varm["CellTopicProfile"]
    return profile.to_numpy(), list(profile.columns)


class SpatialDecon(BaseRegressionMethod):
    """SpatialDecon (counterpart: spatialdecon.py:28). ``ct_profile`` is
    (genes x types); ``fit(x)`` takes the spots (spots x genes). The
    arithmetic runs on ``device`` (default the CUDA card; the CPU only when
    named)."""

    def __init__(self, ct_profile, ct_select: Sequence, bias: bool = False, device="auto"):
        self.device = resolve_device(device)
        self.ct_profile = torch.as_tensor(as_numpy(ct_profile).astype(np.float32),
                                          device=self.device)
        self.ct_select = list(ct_select)
        self.bias = bias
        self.history: List[float] = []

    @staticmethod
    def preprocessing_pipeline(ct_select="auto", ct_profile_split: str = "ref",
                               log_level: str = "INFO") -> Compose:
        """The median profile of each type over the cells of split
        ``ct_profile_split`` into ``varm["CellTopicProfile"]``, the portions
        in ``obsm["cell_type_portion"]`` (counterpart: spatialdecon.py:37-43)."""
        return Compose(
            CellTopicProfile(ct_select=ct_select, split_name=ct_profile_split),
            SetConfig({"label_channel": "cell_type_portion"}),
            log_level=log_level,
        )

    def _loss(self, w: torch.Tensor, b: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
        pred = self.ct_profile @ torch.maximum(w, torch.zeros((), device=w.device)).T
        if self.bias:
            pred = pred + b[None, :]
        return msle(pred, mix)

    def fit(self, x, lr: float = 1e-4, max_iter: int = 500, print_period: int = 100):
        """``max_iter`` Adam steps from weights ``1 / types`` and zero biases
        (counterpart: spatialdecon.py:60); the loss is read every
        ``print_period`` steps."""
        mix = torch.as_tensor(as_numpy(x).astype(np.float32), device=self.device).T  # genes x spots
        n_spots, k = mix.shape[1], len(self.ct_select)
        w = torch.full((n_spots, k), 1.0 / k, device=self.device, requires_grad=True)
        b = torch.zeros(n_spots, device=self.device, requires_grad=True)
        opt = torch.optim.Adam([w, b], lr=lr)
        self.history = []
        for it in range(max_iter):
            opt.zero_grad(set_to_none=True)
            loss = self._loss(w, b, mix)
            loss.backward()
            opt.step()
            with torch.no_grad():
                w.clamp_(min=0.0)
            if (it + 1) % print_period == 0:
                self.history.append(float(loss.detach()))
                logger.info("Iter %d/%d MSLE %.5e", it + 1, max_iter, self.history[-1])
        self.weights = w.detach().cpu().numpy()
        return self

    def predict(self, x: Optional[Any] = None) -> np.ndarray:
        w = np.maximum(self.weights, 0)
        return w / np.maximum(w.sum(1, keepdims=True), 1e-12)

    def score(self, x, y, *, score_func=None, return_pred: bool = False, **kwargs):
        y_pred = self.predict(x)
        s = resolve_score_func(score_func or "mse")(as_numpy(y), y_pred)
        return (s, y_pred) if return_pred else s

    def fit_score(self, x, y, *, score_func=None, return_pred: bool = False, **fit_kwargs):
        self.fit(x, **fit_kwargs)
        return self.score(None, y, score_func=score_func, return_pred=return_pred)


class MSLELoss:
    """Mean squared log error as a float, called like the reference's
    ``nn.Module``: ``MSLELoss()(pred, true)`` (counterpart: spatialdecon.py:93)."""

    def __call__(self, pred, true) -> float:
        as_t = lambda a: a.float() if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.asarray(a, np.float32))
        return float(msle(as_t(pred), as_t(true)))

    forward = __call__


__all__ = ["MSLELoss", "SpatialDecon", "msle", "spatialdecon_preprocess"]
