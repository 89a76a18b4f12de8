"""Gene PCA and expression-weighted cell features, scDeepSort's preprocessing,
and the cell PCA embedding of scTAG's (counterparts: the array cores of
``WeightedFeaturePCA.__call__`` and ``CellPCA.__call__``,
dance_tpu/transforms/cell_feature.py:51-67, 119-146).

The JAX transform reads and writes a ``Data`` container and registers itself
in ``dance_tpu.registry``. The port works on arrays and registers nothing,
so its name cannot collide with the JAX registry in a process that imports
both packages. ``save_info`` is not ported yet.
"""

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from dance_tpu_torch.ops.linalg import pca
from dance_tpu_torch.settings import logger
from dance_tpu_torch.utils import resolve_device
from dance_tpu_torch.utils.matrix import normalize


def _dense(x, device) -> torch.Tensor:
    x = x.toarray() if sp.issparse(x) else np.asarray(x)
    return torch.from_numpy(np.asarray(x, np.float32)).to(device)


def weighted_feature_pca(x_split, x_all, n_components: int, *,
                         feat_norm_mode: Optional[str] = None, feat_norm_axis: int = 0,
                         device="auto") -> Tuple[np.ndarray, np.ndarray]:
    """PCA over genes on ``x_split`` (cells x genes, e.g. the training cells),
    then each cell of ``x_all`` is its row-normalized expression times the
    gene embedding. Returns ``(cell_feat, gene_feat)`` as float32 arrays of
    shapes (n_cells, k) and (n_genes, k); ``k`` is clipped to the matrix size.

    ``feat_norm_mode`` normalizes ``x_split`` along ``feat_norm_axis`` before
    the PCA (:func:`~dance_tpu_torch.utils.matrix.normalize`; counterpart:
    cell_feature.py:53-54). The arithmetic runs on ``device`` (default the
    CUDA card; the CPU only when named)."""
    device = resolve_device(device)
    feat = _dense(x_split, device)
    if feat_norm_mode is not None:
        feat = normalize(feat, mode=feat_norm_mode, axis=feat_norm_axis)
    k = int(min(n_components, min(feat.shape)))
    if k < n_components:
        logger.warning("n_components=%s > min(n_samples, n_features)=%s; clipping",
                       n_components, k)
    gene_feat = pca(feat.T, k).embedding
    cell_feat = normalize(_dense(x_all, device), mode="normalize", axis=1) @ gene_feat
    return cell_feat.cpu().numpy(), gene_feat.cpu().numpy()


def cell_pca(x, n_components: int = 400, *, device="auto") -> np.ndarray:
    """The PCA embedding of the cells, ``x`` (cells x features) projected on
    its ``n_components`` leading principal axes, float32 (n_cells, k); ``k``
    is clipped to the matrix size (counterpart: ``CellPCA.__call__``,
    cell_feature.py:135-146, which writes it to ``obsm``). The arithmetic runs
    on ``device`` (default the CUDA card; the CPU only when named).
    ``save_info`` and float ``n_components`` are not ported yet."""
    device = resolve_device(device)
    feat = _dense(x, device)
    k = int(min(n_components, min(feat.shape)))
    if k < n_components:
        logger.warning("n_components=%s > min(n_samples, n_features)=%s; clipping",
                       n_components, k)
    return pca(feat, k).embedding.cpu().numpy()


__all__ = ["cell_pca", "weighted_feature_pca"]
