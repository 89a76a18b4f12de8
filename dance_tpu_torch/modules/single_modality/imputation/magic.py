"""MAGIC: Markov affinity-based graph imputation of cells.

Counterpart: dance_tpu/modules/single_modality/imputation/magic.py
(``compute_markov`` :24, ``impute_fast`` :67, ``magic`` :113, ``optimal_t``
:123, ``MAGIC`` :143 with ``_impute`` :179-203). ``MAGIC`` builds, on the
device, the dense squared distances, each cell's adaptive Gaussian kernel
(its width the ``ka``-th neighbour's distance) kept on its ``k`` nearest
neighbours (every cell within the ``k``-th distance, ties included), the
symmetrised row-stochastic matrix P, ``t`` products ``P X`` and the
percentile rescale. MAGIC runs no TPU kernel: its device work is cuBLAS
GEMMs, ``topk``, a sort and elementwise passes.

Where this differs from the JAX package:

- The n x n matrices are built in place and freed as soon as they are
  spent (d², then w, then P: 400 MB each at 10,000 cells in float32).
- The percentiles are JAX's linear interpolation written out on a sort
  along the cells (``torch.quantile`` refuses inputs above 2**24 values).
- :func:`impute_fast` runs its matrix power on ``device``; the functional
  API's ``compute_markov`` stays host scipy on the port's ``knn``.
- :func:`magic_preprocess` is the array front of ``preprocessing_pipeline``:
  it runs the pipeline on a matrix wrapped in a ``Data``.
"""

from typing import NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch

from dance_tpu_torch.modules.base import (BaseRegressionMethod, dense32, row_positions,
                                          wrap_matrix)
from dance_tpu_torch.ops.neighbors import knn
from dance_tpu_torch.settings import logger
from dance_tpu_torch.transforms.filter import FilterCellsScanpy, FilterGenesScanpy
from dance_tpu_torch.transforms.interface import AnnDataTransform
from dance_tpu_torch.transforms.mask import CellwiseMaskData, entry_masks
from dance_tpu_torch.transforms.misc import Compose, SaveRaw, SetConfig
from dance_tpu_torch.utils import as_numpy, resolve_device


def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q``-th percentile of each column by linear interpolation, in
    float32 as ``jnp.percentile`` computes it."""
    n = x.shape[0]
    pos = torch.tensor(q, dtype=torch.float32) / 100 * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    srt = torch.sort(x, dim=0).values
    return (srt[int(low.clamp(0, n - 1))] * (1 - hw)
            + srt[int(high.clamp(0, n - 1))] * hw.to(x.device))


def compute_markov(data, k: int = 10, epsilon: float = 1, distance_metric: str = "euclidean",
                   ka: int = 0) -> sp.csr_matrix:
    """The row-stochastic ``D^-1 W`` of the symmetrised, optionally
    ``ka``-autotuned Gaussian affinity of the kNN graph, as scipy CSR
    (counterpart: magic.py:24)."""
    if distance_metric != "euclidean":
        raise ValueError("only the reference's euclidean metric is supported")
    data = as_numpy(data).astype(np.float32)
    n = data.shape[0]
    k = min(k, n)
    dists, indices = knn(data, k, include_self=True)
    if ka > 0:
        # autotune: each row over its (ka+1)-th smallest distance
        denom = np.sort(dists, axis=1)[:, min(ka, k - 1)]
        dists = np.where(denom[:, None] > 0, dists / np.maximum(denom[:, None], 1e-12), 0.0)
    rows = indices.ravel()
    cols = np.repeat(np.arange(n), k)
    vals = dists.ravel() if epsilon > 0 else np.ones(n * k)
    w = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    w = w + w.T
    if epsilon > 0:
        r, c, d = sp.find(w)
        r = np.append(r, np.arange(n))
        c = np.append(c, np.arange(n))
        d = np.append(d / (epsilon ** 2), np.zeros(n))
        w = sp.csr_matrix((np.exp(-d), (r, c)), shape=(n, n))
    deg = np.ravel(w.sum(axis=1))
    dinv = np.where(deg != 0, 1.0 / np.maximum(deg, 1e-300), 0.0)
    return sp.diags(dinv) @ w


def impute_fast(data, L, t: int, rescale_percent: int = 0, L_t=None, tprev: Optional[int] = None,
                *, device="auto"):
    """``L^t data`` with the optional percentile rescale (counterpart:
    magic.py:67); the matrix power by squaring runs on ``device`` (default
    the CUDA card). Returns ``(data_new, L_t)``; a later call with a larger
    ``t`` can start from ``L_t`` and ``tprev``."""
    dev = resolve_device(device)
    data = as_numpy(data).astype(np.float32)
    Ld = torch.as_tensor(np.asarray(L.todense() if sp.issparse(L) else L, np.float32),
                         device=dev)

    def mat_power(m, p):
        out = torch.eye(m.shape[0], dtype=m.dtype, device=dev)
        base = m
        while p:
            if p & 1:
                out = out @ base
            base = base @ base
            p >>= 1
        return out

    if L_t is None:
        Lt = mat_power(Ld, t)
    else:
        Lt = torch.as_tensor(np.asarray(L_t, np.float32), device=dev) @ mat_power(Ld, t - tprev)
    data_new = (Lt @ torch.as_tensor(data, device=dev)).cpu().numpy()
    L_t = Lt.cpu().numpy()
    if rescale_percent != 0:
        if (data_new < 0).any():
            logger.warning("Rescaling should not be performed on log-transformed (or other "
                           "negative) values. Imputed data returned unscaled.")
            return data_new, L_t
        m99 = np.percentile(data, rescale_percent, axis=0)
        m100 = data.max(axis=0)
        m99[m99 == 0] = m100[m99 == 0]
        m99n = np.percentile(data_new, rescale_percent, axis=0)
        m100n = data_new.max(axis=0)
        m99n[m99n == 0] = m100n[m99n == 0]
        data_new = data_new * (m99 / np.maximum(m99n, 1e-12))[None, :]
    return data_new, L_t


def magic(data, pca_projected_data, t: int = 6, k: int = 30, ka: int = 10, epsilon: float = 1,
          rescale: int = 99, *, device="auto"):
    """Functional MAGIC: the Markov matrix of the PCA space, then ``t`` steps
    of diffusion of ``data`` (counterpart: magic.py:113)."""
    L = compute_markov(pca_projected_data, k=k, epsilon=epsilon, distance_metric="euclidean",
                       ka=ka)
    return impute_fast(data, L, t, rescale_percent=rescale, device=device)[0]


def optimal_t(data, th: float = 0.001, max_t: int = 32) -> int:
    """The first diffusion time at which the retained spectral energy
    changes by less than ``th`` (counterpart: magic.py:123)."""
    data = as_numpy(data).astype(np.float32)
    s = np.linalg.svd(data, compute_uv=False) ** 2
    nse = np.zeros(max_t)
    for t in range(max_t):
        s_t = s ** t
        p = s_t / s_t.sum()
        nse[t] = p[p > th].sum()
        if t > 1 and abs(nse[t] - nse[t - 1]) < th:
            return t
    return max_t


class MagicInputs(NamedTuple):
    """:func:`magic_preprocess`'s output: log-normalised ``x`` and the raw
    counts of the kept cells and genes, the three masks, and the indices of
    the kept cells and genes."""
    x: np.ndarray
    x_raw: np.ndarray
    train_mask: np.ndarray
    valid_mask: np.ndarray
    test_mask: np.ndarray
    cells: np.ndarray
    genes: np.ndarray


def magic_preprocess(counts, *, min_cells: float = 0.1, mask: bool = True, distr: str = "exp",
                     mask_rate: float = 0.1, seed: Optional[int] = None) -> MagicInputs:
    """:meth:`MAGIC.preprocessing_pipeline` on raw ``counts`` (cells x genes,
    numpy or scipy, taken as float32) wrapped in a ``Data``, for a caller
    that holds a matrix. Without ``mask`` the train mask is all ones and the
    others empty."""
    data = wrap_matrix(counts)
    MAGIC.preprocessing_pipeline(min_cells=min_cells, mask=mask, distr=distr,
                                 mask_rate=mask_rate, seed=seed, log_level="WARNING")(data)
    return MagicInputs(*imputation_arrays(data))


def imputation_arrays(data) -> tuple:
    """``(x, x_raw, train_mask, valid_mask, test_mask, cells, genes)`` of a
    ``Data`` an imputation pipeline ran on, its cells and genes named by
    their rows and columns in the input (:func:`wrap_matrix`)."""
    adata = data.data
    return (dense32(adata.X), dense32(adata.raw.X), *entry_masks(data),
            row_positions(adata.obs_names), row_positions(adata.var_names))


class MAGIC(BaseRegressionMethod):
    """MAGIC (counterpart: magic.py:143). ``fit(x, mask=None)`` imputes the
    (cells x genes) ``x`` (times ``mask`` when given); ``predict`` returns
    the imputed matrix. The arithmetic runs on ``device`` (default the CUDA
    card; the CPU only when named); ``gpu`` is the reference's and has no
    effect."""

    _DISPLAY_ATTRS = ("t", "k", "ka", "epsilon", "rescale")

    def __init__(self, t: int = 3, k: int = 10, ka: int = 4, epsilon: float = 1.0,
                 rescale: int = 99, gpu: int = -1, device="auto"):
        self.t = t
        self.k = k
        self.ka = ka
        self.epsilon = epsilon
        self.rescale = rescale
        self.device = resolve_device(device)

    @torch.no_grad()
    def _impute(self, x: torch.Tensor) -> torch.Tensor:
        """The diffusion of ``x`` (counterpart: magic.py:179)."""
        n = x.shape[0]
        k = min(self.k, n - 1)
        ka = min(self.ka, k)
        sq = (x ** 2).sum(1)
        d2 = sq[:, None] + sq[None, :]
        d2.sub_((x @ x.T).mul_(2)).clamp_(min=0.0)
        srt = torch.topk(d2, k + 1, dim=1, largest=False).values  # ascending, self included
        sigma = torch.sqrt(torch.clamp(srt[:, ka], min=1e-12)) * self.epsilon
        thresh = srt[:, k][:, None]
        keep = d2 <= thresh  # every cell within the k-th distance: ties kept
        w = d2.neg_().div_(torch.clamp(sigma[:, None] ** 2, min=1e-12)).exp_()
        w.mul_(keep)
        del d2, keep
        p = w + w.T
        del w
        p.div_(2)
        p.div_(torch.clamp(p.sum(1, keepdim=True), min=1e-12))
        out = x
        for _ in range(self.t):
            out = p @ out
        del p
        if self.rescale:
            scale = percentile(x, self.rescale) / torch.clamp(percentile(out, self.rescale),
                                                              min=1e-12)
            out = out * torch.where(x.amax(0) > 0, scale, 1.0)[None, :]
        return out

    @staticmethod
    def preprocessing_pipeline(min_cells: float = 0.1, mask: bool = True, distr: str = "exp",
                               mask_rate: float = 0.1, seed: Optional[int] = None,
                               log_level: str = "INFO") -> Compose:
        """Genes expressed in at least ``min_cells`` cells (a float in (0, 1)
        a ratio of the gene count, as JAX resolves it), cells with a count,
        the counts kept (``SaveRaw``), ``normalize_total`` to 1e4, ``log1p``
        and the entry masks (``CellwiseMaskData``, unless ``mask`` is off)
        (counterpart: magic.py:157-176)."""
        transforms = [
            FilterGenesScanpy(min_cells=min_cells),
            FilterCellsScanpy(min_counts=1),
            SaveRaw(),
            AnnDataTransform("sc.pp.normalize_total", target_sum=1e4),
            AnnDataTransform("sc.pp.log1p"),
        ]
        if mask:
            transforms.append(CellwiseMaskData(distr=distr, mask_rate=mask_rate, seed=seed))
        transforms.append(SetConfig({
            "feature_channel": [None, "train_mask"] if mask else [None],
            "feature_channel_type": ["X", "layers"] if mask else ["X"],
            "label_channel": [None, None],
            "label_channel_type": ["X", "raw_X"]}))
        return Compose(*transforms, log_level=log_level)

    def fit(self, x, y=None, mask=None):
        x = as_numpy(x).astype(np.float32)
        if mask is not None:
            x = x * as_numpy(mask)
        self.imputed = self._impute(torch.as_tensor(x, device=self.device)).cpu().numpy()
        return self

    def predict(self, x=None, mask=None) -> np.ndarray:
        if x is not None and not hasattr(self, "imputed"):
            self.fit(x, mask=mask)
        return self.imputed


__all__ = ["MAGIC", "MagicInputs", "compute_markov", "imputation_arrays", "impute_fast", "magic",
           "magic_preprocess", "optimal_t"]
