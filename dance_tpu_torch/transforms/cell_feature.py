"""Cell features: the gene PCA and SVD with expression-weighted cell
embeddings, the cell PCA, sparse PCA and truncated SVD, the batch
statistics and the Gaussian random projection (counterparts:
dance_tpu/transforms/cell_feature.py, ``WeightedFeaturePCA`` :28-67,
``WeightedFeatureSVD`` :70-105, ``_evr_components`` :108, ``CellPCA``
:117-146, ``CellSparsePCA`` :149-175 with ``_sparse_pca`` :178,
``CellSVD`` :193-221, ``FeatureCellPlaceHolder`` :224, ``BatchFeature``
:241-278, ``GaussRandProjFeature`` :281-301).

The JAX transforms read and write a ``Data`` container. Here each class's
``__call__`` takes the cells x features matrix (and the batch labels where
JAX reads ``obs["batch"]``) and returns what JAX writes to ``obsm``/``varm``;
with ``save_info`` the components JAX writes to ``uns`` are kept in the
instance's ``info``. :class:`WeightedFeaturePCA`, which the container
pipelines run, also takes a port ``Data`` and then acts on it as JAX's does
(``split_name``, ``obsm``/``varm[out]``, ``uns`` under ``save_info``, a
modality by ``mod``); it is registered under JAX's key in the port's own
registry. The matrix work runs on ``device`` (the CUDA card unless the CPU
is named); the batch statistics (percentiles) are host numpy, as in JAX.

Where this differs from the JAX package: the randomized SVD (above 1,024 on
both sides) and the Gaussian projection draw from torch generators, not
from ``jax.random``; ``GaussRandProjFeature`` takes ``proj=`` to be handed a
projection.
"""

from typing import Dict, Optional, Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch

from dance_tpu_torch.data.base import BaseData
from dance_tpu_torch.ops.linalg import gram_schmidt_gauss_proj, pca, randomized_svd, svd_embedding
from dance_tpu_torch.registry import register_preprocessor
from dance_tpu_torch.settings import logger
from dance_tpu_torch.transforms.base import BaseTransform
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
    return WeightedFeaturePCA(n_components, feat_norm_mode=feat_norm_mode,
                              feat_norm_axis=feat_norm_axis, device=device)(x_split, x_all)


def cell_pca(x, n_components: int = 400, *, device="auto") -> np.ndarray:
    """The PCA embedding of the cells, ``x`` (cells x features) projected on
    its ``n_components`` leading principal axes, float32 (n_cells, k); ``k``
    is clipped to the matrix size (counterpart: ``CellPCA.__call__``,
    cell_feature.py:135-146, which writes it to ``obsm``). The arithmetic runs
    on ``device`` (default the CUDA card; the CPU only when named).
    :class:`CellPCA` keeps the components with ``save_info``."""
    return CellPCA(n_components, device=device)(x)


def _resolve_k(n_components, shape) -> int:
    """``n_components`` clipped to the matrix size, with JAX's warning
    (counterpart: cell_feature.py:19)."""
    k = n_components
    if k > min(shape):
        logger.warning("n_components=%s > min(n_samples, n_features)=%s; clipping", k,
                       min(shape))
        k = min(shape)
    return int(k)


def _evr_components(feat: torch.Tensor, target_ratio: float) -> int:
    """The smallest k whose cumulative explained-variance ratio, over the
    leading ``min(shape) - 1`` singular values, reaches ``target_ratio``
    (counterpart: cell_feature.py:108)."""
    _, s, _ = randomized_svd(feat, min(feat.shape) - 1)
    ev = s.to(torch.float64) ** 2
    evr = torch.cumsum(ev, 0) / ev.sum()
    return int((evr < target_ratio).sum()) + 1


@register_preprocessor("feature", "cell")
class WeightedFeaturePCA(BaseTransform):
    """:func:`weighted_feature_pca` as JAX's transform (counterpart:
    cell_feature.py:28). On arrays, ``__call__(x_split, x_all=None)``
    returns ``(cell_feat, gene_feat)``, ``x_all`` defaulting to ``x_split``;
    with ``save_info``, ``info`` holds the gene PCA's components, mean and
    explained variance. On a ``Data``, the PCA is of ``get_x(split_name)``
    and the cells are ``get_x()``; the features go to ``obsm[out]`` and
    ``varm[out]``, and with ``save_info`` the components to ``uns``."""

    _DISPLAY_ATTRS = ("n_components", "split_name", "feat_norm_mode", "feat_norm_axis")

    def __init__(self, n_components: Union[float, int] = 400, split_name: Optional[str] = None,
                 feat_norm_mode: Optional[str] = None, feat_norm_axis: int = 0,
                 save_info: bool = False, device="auto", **kwargs):
        super().__init__(**kwargs)
        self.n_components = n_components
        self.split_name = split_name
        self.feat_norm_mode = feat_norm_mode
        self.feat_norm_axis = feat_norm_axis
        self.save_info = save_info
        self.device = device
        self.info: Dict[str, np.ndarray] = {}

    def __call__(self, x_split, x_all=None):
        if isinstance(x_split, BaseData):
            data = x_split
            cell_feat, gene_feat = self._features(data.get_x(self.split_name), data.get_x())
            data.data.obsm[self.out] = cell_feat
            data.data.varm[self.out] = gene_feat
            data.data.uns.update(self.info)
            return data
        return self._features(x_split, x_split if x_all is None else x_all)

    def _features(self, x_split, x_all) -> Tuple[np.ndarray, np.ndarray]:
        device = resolve_device(self.device)
        feat = _dense(x_split, device)
        if self.feat_norm_mode is not None:
            feat = normalize(feat, mode=self.feat_norm_mode, axis=self.feat_norm_axis)
        res = pca(feat.T, _resolve_k(self.n_components, feat.shape))
        cell_feat = normalize(_dense(x_all, device), mode="normalize", axis=1) @ res.embedding
        if self.save_info:
            self.info = {"pca_components": res.components.cpu().numpy(),
                         "pca_mean": res.mean.cpu().numpy(),
                         "pca_explained_variance": res.explained_variance.cpu().numpy()}
        return cell_feat.cpu().numpy(), res.embedding.cpu().numpy()


class WeightedFeatureSVD:
    """The gene SVD (TruncatedSVD, no centring) and the row-normalised
    expression times it (counterpart: cell_feature.py:70). A float
    ``n_components`` is first turned into the smallest k whose explained
    variance ratio reaches it (:func:`_evr_components`, on ``x_split``
    before any normalisation, as JAX does). ``__call__(x_split, x_all=None)``
    returns ``(cell_feat, gene_feat)``; with ``save_info``, ``info`` holds
    the SVD's components."""

    def __init__(self, n_components: Union[float, int] = 400,
                 feat_norm_mode: Optional[str] = None, feat_norm_axis: int = 0,
                 save_info: bool = False, device="auto"):
        self.n_components = n_components
        self.feat_norm_mode = feat_norm_mode
        self.feat_norm_axis = feat_norm_axis
        self.save_info = save_info
        self.device = device
        self.info: Dict[str, np.ndarray] = {}

    def __call__(self, x_split, x_all=None) -> Tuple[np.ndarray, np.ndarray]:
        device = resolve_device(self.device)
        feat = _dense(x_split, device)
        if isinstance(self.n_components, float):
            self.n_components = _evr_components(feat, self.n_components)
        if self.feat_norm_mode is not None:
            feat = normalize(feat, mode=self.feat_norm_mode, axis=self.feat_norm_axis)
        gene_feat, comps = svd_embedding(feat.T, _resolve_k(self.n_components, feat.shape))
        x_all = x_split if x_all is None else x_all
        cell_feat = normalize(_dense(x_all, device), mode="normalize", axis=1) @ gene_feat
        if self.save_info:
            self.info = {"svd_components": comps.cpu().numpy()}
        return cell_feat.cpu().numpy(), gene_feat.cpu().numpy()


class CellPCA:
    """:func:`cell_pca` as JAX's transform (counterpart:
    cell_feature.py:117); with ``save_info``, ``info`` holds the PCA's
    components, mean and explained variance."""

    def __init__(self, n_components: int = 400, *, save_info: bool = False, device="auto"):
        self.n_components = n_components
        self.save_info = save_info
        self.device = device
        self.info: Dict[str, np.ndarray] = {}

    def __call__(self, x) -> np.ndarray:
        feat = _dense(x, resolve_device(self.device))
        res = pca(feat, _resolve_k(self.n_components, feat.shape))
        if self.save_info:
            self.info = {"pca_components": res.components.cpu().numpy(),
                         "pca_mean": res.mean.cpu().numpy(),
                         "pca_explained_variance": res.explained_variance.cpu().numpy()}
        return res.embedding.cpu().numpy()


def _sparse_pca(xc: torch.Tensor, k: int, alpha: float, n_iter: int = 30) -> torch.Tensor:
    """(k, d) sparse loadings: the truncated SVD's right vectors refined by
    ``n_iter`` power steps with soft thresholding at ``alpha`` (counterpart:
    cell_feature.py:178)."""
    _, _, v = randomized_svd(xc, k)
    for _ in range(n_iter):
        u = xc @ v.T
        u = u / torch.linalg.vector_norm(u, dim=0, keepdim=True).clamp(min=1e-12)
        v_new = u.T @ xc
        v_new = torch.sign(v_new) * (v_new.abs() - alpha).clamp(min=0.0)
        v = v_new / torch.linalg.vector_norm(v_new, dim=1, keepdim=True).clamp(min=1e-12)
    return v


class CellSparsePCA:
    """Sparse-loading PCA of the cells (counterpart: cell_feature.py:149):
    ``__call__(x)`` returns ``(embedding, loadings)``, the centred cells
    on the loadings (cells, k) and the loadings (features, k), JAX's
    ``obsm`` and ``varm["sparse_components"]``."""

    def __init__(self, n_components: int = 400, *, alpha: float = 1.0, device="auto"):
        self.n_components = n_components
        self.alpha = alpha
        self.device = device

    def __call__(self, x) -> Tuple[np.ndarray, np.ndarray]:
        feat = _dense(x, resolve_device(self.device))
        xc = feat - feat.mean(0)
        comps = _sparse_pca(xc, _resolve_k(self.n_components, feat.shape), self.alpha)
        return (xc @ comps.T).cpu().numpy(), comps.T.cpu().numpy()


class CellSVD:
    """The truncated SVD of the cells, ``U S`` (counterpart:
    cell_feature.py:193); a float ``n_components`` as in
    :class:`WeightedFeatureSVD`. ``__call__(x)`` returns the embedding; with
    ``save_info`` (the default, as in JAX) ``info`` holds the components."""

    def __init__(self, n_components: Union[float, int] = 400, *, save_info: bool = True,
                 device="auto"):
        self.n_components = n_components
        self.save_info = save_info
        self.device = device
        self.info: Dict[str, np.ndarray] = {}

    def __call__(self, x) -> np.ndarray:
        feat = _dense(x, resolve_device(self.device))
        if isinstance(self.n_components, float):
            self.n_components = _evr_components(feat, self.n_components)
        emb, comps = svd_embedding(feat, _resolve_k(self.n_components, feat.shape))
        if self.save_info:
            self.info = {"svd_components": comps.cpu().numpy()}
        return emb.cpu().numpy()


class FeatureCellPlaceHolder:
    """The features as they are: ``(x, x.T)`` for ``obsm`` and ``varm``
    (counterpart: cell_feature.py:224)."""

    def __call__(self, x) -> Tuple[np.ndarray, np.ndarray]:
        feat = np.asarray(x.toarray() if sp.issparse(x) else x)
        return feat, feat.T


def cell_stats(x) -> np.ndarray:
    """Nine statistics of each cell (counterpart:
    cell_feature.py:262-272 and graph_construct.py:58-62): the mean and
    standard deviation of its row, the 25th, 50th and 75th percentiles of
    its nonzero entries, the row's maximum, its nonzero count over 1,000, and
    the mean and standard deviation of its nonzero entries (NaN for a row
    without one). Host numpy in ``x``'s dtype, gathered in float64, as in
    JAX."""
    x = np.asarray(x.toarray() if sp.issparse(x) else x)
    nz = np.where(x != 0, x, np.nan)
    return np.column_stack([x.mean(1), x.std(1), np.nanpercentile(nz, 25, axis=1),
                            np.nanpercentile(nz, 50, axis=1), np.nanpercentile(nz, 75, axis=1),
                            x.max(1), (x != 0).sum(1) / 1000, np.nanmean(nz, 1),
                            np.nanstd(nz, 1)])


def batch_means(stats: np.ndarray, batches) -> np.ndarray:
    """Each row replaced by the mean of its batch's rows."""
    batches = np.asarray(batches)
    out = np.zeros_like(stats)
    for b in np.unique(batches):
        m = batches == b
        out[m] = stats[m].mean(0)
    return out


class BatchFeature:
    """The nine :func:`cell_stats` of each cell averaged over its batch
    (counterpart: cell_feature.py:241): ``__call__(x, batches)`` returns
    the (cells, 9) float32 ``obsm["batch_features"]``; a cell without a
    nonzero entry raises, as in JAX."""

    def __call__(self, x, batches) -> np.ndarray:
        x = np.asarray(x.toarray() if sp.issparse(x) else x)
        if not (x != 0).any(axis=1).all():
            raise ValueError("One or more cells contain all-zero features")
        return batch_means(cell_stats(x), batches).astype(np.float32)


class GaussRandProjFeature:
    """The cells times a Gaussian random projection, (features, k) standard
    normals over sqrt(k) (counterpart: cell_feature.py:281), in float32 on
    ``device``. The projection is drawn from a torch generator seeded with
    ``seed`` on the device, or handed in as ``proj``."""

    def __init__(self, n_components: int = 400, seed: int = 0, device="auto"):
        self.n_components = n_components
        self.seed = seed
        self.device = device

    def __call__(self, x, proj=None) -> np.ndarray:
        device = resolve_device(self.device)
        feat = _dense(x, device)
        if proj is None:
            gen = torch.Generator(device=device).manual_seed(self.seed)
            proj = gram_schmidt_gauss_proj(gen, feat.shape[1], self.n_components)
        else:
            proj = torch.as_tensor(np.asarray(proj, np.float32)).to(device)
        return (feat @ proj).cpu().numpy()


__all__ = ["BatchFeature", "CellPCA", "CellSVD", "CellSparsePCA", "FeatureCellPlaceHolder",
           "GaussRandProjFeature", "WeightedFeaturePCA", "WeightedFeatureSVD", "batch_means",
           "cell_pca", "cell_stats", "weighted_feature_pca"]
