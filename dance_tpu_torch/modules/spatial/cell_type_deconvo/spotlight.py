"""SPOTlight: NMF topic deconvolution with two non-negative regressions.

Counterpart: dance_tpu/modules/spatial/cell_type_deconvo/spotlight.py
(``SPOTlight`` :23, ``NNLS`` :96). The reference counts (genes x cells) are
factorised into topics, the basis started from the types' median profiles
when ``rank`` equals their number; the types' topic profiles are the
medians of their cells' topic weights. Then two fixed-basis NMFs (NNLS):
the spots on the basis, and the types' topic profiles on the spots' topic
weights, whose row-normalised columns are the portions. SPOTlight runs no
TPU kernel: three loops of ``max_iter`` small cuBLAS GEMMs and elementwise
passes (:mod:`dance_tpu_torch.ops.nmf`).

Where this differs from the JAX package: the loops run in float32 on
``device`` (JAX: ``Precision.DEFAULT``, one bf16 pass on a TPU); the NMF
starts are drawn by :func:`dance_tpu_torch.ops.nmf.init_factors`.
"""

from typing import Any, List, Optional

import numpy as np
import torch

from dance_tpu_torch.modules.base import BaseRegressionMethod, resolve_score_func
from dance_tpu_torch.ops.nmf import nmf
from dance_tpu_torch.settings import logger
from dance_tpu_torch.transforms.misc import SetConfig
from dance_tpu_torch.transforms.pseudobulk import get_ct_profile
from dance_tpu_torch.utils import as_numpy, resolve_device


class SPOTlight(BaseRegressionMethod):
    """SPOTlight (counterpart: spotlight.py:23). ``ref_count`` (cells x
    genes) and ``ref_annot`` are the reference; ``fit(x)`` takes the spots
    (spots x genes); ``predict`` returns their (spots x types) portions."""

    def __init__(self, ref_count, ref_annot, ct_select: List[str], rank: int = 2,
                 bias: bool = False, init_bias=None, device="auto"):
        self.ref_count = as_numpy(ref_count)
        self.ref_annot = as_numpy(ref_annot)
        self.ct_select = list(ct_select)
        self.rank = rank
        self.bias = bias
        self.device = resolve_device(device)

    @staticmethod
    def preprocessing_pipeline(log_level: str = "INFO") -> SetConfig:
        """The portions in ``obsm["cell_type_portion"]``; the reference is
        the model's own (counterpart: spotlight.py:35-36)."""
        return SetConfig({"label_channel": "cell_type_portion"}, log_level=log_level)

    def fit(self, x, lr: float = 1e-3, max_iter: int = 1000):
        """``max_iter`` iterations of each of the three NMFs; ``lr`` is the
        reference's and has no effect, as in JAX (counterpart: spotlight.py:38)."""
        dev = self.device
        x = as_numpy(x).astype(np.float32)
        x_ref = self.ref_count.T.astype(np.float32)  # genes x cells
        W_init = None
        if self.rank == len(self.ct_select):
            W_init = get_ct_profile(self.ref_count, self.ref_annot, ct_select=self.ct_select,
                                    method="median")
        res = nmf(x_ref, self.rank, n_iter=max_iter, W_init=W_init, device=dev)
        self.W = res.W.cpu().numpy()  # genes x topics
        self.H = res.H.cpu().numpy()  # topics x cells
        # the types' topic profiles: the medians of their cells' topic weights
        self.H_profile = get_ct_profile(self.H.T, self.ref_annot, ct_select=self.ct_select,
                                        method="median")
        # the spots' topic weights: the basis regressed onto the spots
        res_b = nmf(x.T, self.rank, n_iter=max_iter, W_init=res.W, W_fixed=True, device=dev)
        self.B = res_b.H.cpu().numpy()  # topics x spots
        # the portions: the types' topic profiles regressed onto the spots' weights
        res_p = nmf(res_b.H, len(self.ct_select), n_iter=max_iter, W_init=self.H_profile,
                    W_fixed=True, device=dev)
        self.P = res_p.H.cpu().numpy()  # types x spots
        return self

    def predict(self, x: Optional[Any] = None) -> np.ndarray:
        p = self.P.T
        return p / np.maximum(p.sum(1, keepdims=True), 1e-12)

    def score(self, x, y, *, score_func=None, return_pred: bool = False, valid_idx=None,
              test_idx=None):
        """The metric (default MSE) of the portions; with ``valid_idx``,
        those of the validation and the test spots (counterpart: spotlight.py:77)."""
        y_pred = self.predict(x)
        func = resolve_score_func(score_func or "mse")
        y = as_numpy(y)
        if valid_idx is None:
            s = func(y, y_pred)
            return (s, y_pred) if return_pred else s
        vs, ts = func(y[valid_idx], y_pred[valid_idx]), func(y[test_idx], y_pred[test_idx])
        return (vs, ts, y_pred) if return_pred else (vs, ts)

    def fit_score(self, x, y, *, score_func=None, return_pred: bool = False, valid_idx=None,
                  test_idx=None, **fit_kwargs):
        self.fit(x, **fit_kwargs)
        return self.score(x, y, score_func=score_func, return_pred=return_pred,
                          valid_idx=valid_idx, test_idx=test_idx)


class NNLS:
    """Non-negative linear model ``y ≈ x Wᵀ`` fitted by projected gradient
    descent on the mean squared error, from zero weights (counterpart:
    spotlight.py:96)."""

    def __init__(self, in_dim, out_dim, bias: bool = False, init_bias=None, device="auto"):
        self.in_dim, self.out_dim = in_dim, out_dim
        self.bias = bias
        self.init_bias = init_bias
        self.device = resolve_device(device)
        self.weight = np.zeros((out_dim, in_dim), np.float32)

    def forward(self, x) -> np.ndarray:
        out = as_numpy(x) @ self.weight.T
        if self.bias and self.init_bias is not None:
            out = out + as_numpy(self.init_bias)
        return out

    __call__ = forward

    def fit(self, x, y, max_iter, lr, print_res: bool = False, print_period: int = 100):
        x = torch.as_tensor(as_numpy(x).astype(np.float32), device=self.device)
        y = torch.as_tensor(as_numpy(y).astype(np.float32), device=self.device)
        w = torch.zeros((self.out_dim, self.in_dim), device=self.device, requires_grad=True)
        losses = []
        for _ in range(max_iter):
            loss = torch.mean((x @ w.T - y) ** 2)
            (g,) = torch.autograd.grad(loss, w)
            with torch.no_grad():
                w = torch.clamp(w - lr * g, min=0.0).requires_grad_(True)
            losses.append(loss.detach())
        self.weight = w.detach().cpu().numpy()
        if print_res:
            for it in range(print_period - 1, max_iter, print_period):
                logger.info("Epoch: %02d/%d Loss: %.5e", it + 1, max_iter, float(losses[it]))
        return self


__all__ = ["NNLS", "SPOTlight"]
