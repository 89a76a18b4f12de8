"""stLearn's clustering heads over SME-normalised features: k-means and
Louvain.

Counterpart: dance_tpu/modules/spatial/spatial_domain/stlearn.py
(``_sme_pipeline`` :16-29, ``StKmeans`` :32, ``StLouvain`` :67). The SME
features come from the heads' shared ``preprocessing_pipeline``: the scaled
expression's PCA, the morphology CNN's features of the H&E tiles, the SME
graph of the two and the spots' pixel distances, and the SME average of the
expression. :func:`sme_preprocess` is its array front: it runs the
pipeline on a matrix wrapped in a ``Data``. Neither
head runs a TPU kernel: k-means is a loop of distance GEMMs and one-hot
sums on the device, Louvain runs on the host in C++.

Where this differs from the JAX package: the k-means restarts are drawn
from torch generators (:func:`~dance_tpu_torch.ops.cluster.kmeans`), not
JAX's keys; the morphology encoder is initialised from torch's draws
(:func:`~dance_tpu_torch.transforms.spatial_feature.morphology_init`).
"""

from typing import NamedTuple

import numpy as np

from dance_tpu_torch.modules.base import BaseClusteringMethod, row_positions, wrap_matrix
from dance_tpu_torch.ops.cluster import kmeans, louvain
from dance_tpu_torch.ops.neighbors import knn_graph
from dance_tpu_torch.transforms.cell_feature import CellPCA
from dance_tpu_torch.transforms.graph.spatial_graph import SMEGraph
from dance_tpu_torch.transforms.interface import AnnDataTransform
from dance_tpu_torch.transforms.misc import Compose, SetConfig
from dance_tpu_torch.transforms.spatial_feature import MorphologyFeatureCNN, SMEFeature
from dance_tpu_torch.utils import resolve_device


class SMEInputs(NamedTuple):
    feature: np.ndarray   # (n, k) SME features, the heads' input
    x: np.ndarray         # (n, g) scaled expression
    cell_pca: np.ndarray  # (n, k) PCA of x
    morph: np.ndarray     # (n, k') morphology features
    adj: np.ndarray       # (n, n) SME graph
    genes: np.ndarray     # the kept gene columns


def sme_preprocess(counts, xy, xy_pixel, image, *, n_components: int = 50,
                   device="auto") -> SMEInputs:
    """The heads' ``preprocessing_pipeline`` on raw ``counts`` (spots x
    genes) wrapped in a ``Data`` with the coordinates ``xy`` in
    ``obsm["spatial"]``, the pixels ``xy_pixel`` in ``obsm["spatial_pixel"]``
    and the HWC ``image`` in ``uns["image"]``, for a caller that holds the
    arrays."""
    data = wrap_matrix(counts, uns={"image": image}, spatial=np.asarray(xy),
                       spatial_pixel=np.asarray(xy_pixel))
    SMEMethod.preprocessing_pipeline(n_components, log_level="WARNING", device=device)(data)
    adata = data.data
    return SMEInputs(adata.obsm["SMEFeature"], np.asarray(adata.X), adata.obsm["CellPCA"],
                     adata.obsm["MorphologyFeatureCNN"], adata.obsp["SMEGraph"],
                     row_positions(adata.var_names))


class SMEMethod(BaseClusteringMethod):
    """The pipeline stLearn's two heads share (counterpart: ``_sme_pipeline``,
    stlearn.py:16-29)."""

    @staticmethod
    def preprocessing_pipeline(n_components: int = 50, log_level: str = "INFO",
                               device="auto") -> Compose:
        """Genes in at least one spot, ``normalize_total`` to 1e4, ``log1p``,
        ``scale``; the cell PCA and the morphology CNN's features at
        ``n_components``, the SME graph (radius 3) and the SME feature at
        ``n_components`` into ``obsm["SMEFeature"]``, on ``device``."""
        return Compose(
            AnnDataTransform("sc.pp.filter_genes", min_cells=1),
            AnnDataTransform("sc.pp.normalize_total", target_sum=1e4),
            AnnDataTransform("sc.pp.log1p"),
            AnnDataTransform("sc.pp.scale"),
            CellPCA(n_components=n_components, device=device),
            MorphologyFeatureCNN(n_components=n_components, device=device),
            SMEGraph(device=device),
            SMEFeature(n_components=n_components, device=device),
            SetConfig({"feature_channel": "SMEFeature", "feature_channel_type": "obsm",
                       "label_channel": "label", "label_channel_type": "obs"}),
            log_level=log_level,
        )


class StKmeans(SMEMethod):
    """k-means over the SME features (counterpart: stlearn.py:32): the best
    of ``n_init`` k-means++ restarts, each up to ``max_iter`` Lloyd steps
    until the squared centre shift is ``tol`` of the mean variance. The
    arithmetic runs on ``device`` (default the CUDA card)."""

    _DISPLAY_ATTRS = ("n_clusters",)

    def __init__(self, n_clusters: int = 19, init: str = "k-means++", n_init: int = 10,
                 max_iter: int = 300, tol: float = 1e-4, algorithm: str = "auto",
                 verbose: bool = False, random_state: int = 0, use_data: str = "X_pca",
                 key_added: str = "X_pca_kmeans", device="auto"):
        self.n_clusters = n_clusters
        self.n_init = n_init
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state
        self.device = resolve_device(device)

    def fit(self, x, y=None):
        self.pred = kmeans(x, self.n_clusters, n_init=self.n_init, n_iter=self.max_iter,
                           seed=self.random_state, tol=self.tol,
                           device=self.device).labels.cpu().numpy()
        return self

    def predict(self, x=None) -> np.ndarray:
        return self.pred


class StLouvain(SMEMethod):
    """Louvain over the ``n_neighbors`` graph of the SME features, or over
    ``adj`` when given (counterpart: stlearn.py:67)."""

    _DISPLAY_ATTRS = ("resolution",)

    def __init__(self, resolution: float = 1.0, n_neighbors: int = 15, seed: int = 0):
        self.resolution = resolution
        self.n_neighbors = n_neighbors
        self.seed = seed

    def fit(self, x, y=None, *, adj=None):
        if adj is None:
            adj = knn_graph(np.asarray(x, np.float32), min(self.n_neighbors, len(x) - 1),
                            mode="connectivity", include_self=False)
        self.pred = louvain(adj, resolution=self.resolution, seed=self.seed)
        return self

    def predict(self, x=None) -> np.ndarray:
        return self.pred


__all__ = ["SMEInputs", "SMEMethod", "StKmeans", "StLouvain", "sme_preprocess"]
