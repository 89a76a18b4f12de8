"""Louvain spatial-domain identification: Louvain communities of the spots'
kNN graph in PCA space, and the python-louvain module API that the
reference vendors, on adjacency matrices.

Counterpart: dance_tpu/modules/spatial/spatial_domain/louvain.py
(``Louvain`` :17, its ``preprocessing_pipeline`` :26, the module API
:52-128). The port's front, :func:`louvain_preprocess`, runs the pipeline
on a matrix wrapped in a ``Data``. Louvain runs on the host in C++
(:func:`~dance_tpu_torch.ops.cluster.louvain`); the PCA on the device. No
TPU kernel is on this path.
"""

from typing import Optional

import numpy as np
import scipy.sparse as sp

from dance_tpu_torch.modules.base import BaseClusteringMethod, wrap_matrix
from dance_tpu_torch.ops.cluster import louvain
from dance_tpu_torch.transforms.cell_feature import CellPCA
from dance_tpu_torch.transforms.graph.neighbor_graph import NeighborGraph
from dance_tpu_torch.transforms.interface import AnnDataTransform
from dance_tpu_torch.transforms.misc import Compose, SetConfig


def louvain_preprocess(x, dim: int = 50, n_neighbors: int = 17, device="auto") -> sp.csr_matrix:
    """:meth:`Louvain.preprocessing_pipeline` on raw counts ``x`` (spots x
    genes, numpy or scipy, taken as float32) wrapped in a ``Data``, for a
    caller that holds a matrix. Returns the graph, the method's input."""
    data = wrap_matrix(x)
    Louvain.preprocessing_pipeline(dim, n_neighbors, log_level="WARNING", device=device)(data)
    return data.data.obsp["NeighborGraph"]


class Louvain(BaseClusteringMethod):
    """Louvain communities of a spot graph (counterpart: :17); ``score`` is
    the ARI against given domains."""

    _DISPLAY_ATTRS = ("resolution",)

    def __init__(self, resolution: float = 1.0, seed: int = 0):
        self.resolution = resolution
        self.seed = seed

    @staticmethod
    def preprocessing_pipeline(dim: int = 50, n_neighbors: int = 17, log_level: str = "INFO",
                               device="auto") -> Compose:
        """``normalize_total`` to 1e4, ``log1p``, the ``dim``-component cell
        PCA on ``device`` and the Gaussian-weighted, symmetric
        ``n_neighbors``-NN graph without self-loops into
        ``obsp["NeighborGraph"]``, the domains in ``obs["label"]``
        (counterpart: louvain.py:26-37)."""
        return Compose(
            AnnDataTransform("sc.pp.normalize_total", target_sum=1e4),
            AnnDataTransform("sc.pp.log1p"),
            CellPCA(n_components=dim, device=device),
            NeighborGraph(n_neighbors=n_neighbors),
            SetConfig({"feature_channel": "NeighborGraph", "feature_channel_type": "obsp",
                       "label_channel": "label", "label_channel_type": "obs"}),
            log_level=log_level,
        )

    def fit(self, adj, partition=None, weight="weight", randomize=None,
            random_state: Optional[int] = None):
        """Louvain on ``adj`` at ``resolution``, seeded with ``random_state``
        (``seed`` when None). ``partition``, ``weight`` and ``randomize`` are
        unused, as in JAX."""
        self.pred = louvain(sp.csr_matrix(adj), resolution=self.resolution,
                            seed=random_state if random_state is not None else self.seed)
        return self

    def predict(self, x=None) -> np.ndarray:
        return self.pred


# -- the python-louvain module API on adjacencies (counterpart: :52-128) ---


def check_random_state(seed):
    """A ``RandomState`` from None, an integer, a ``RandomState`` or a
    ``Generator`` (counterpart: :57)."""
    if seed is None or isinstance(seed, (int, np.integer)):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    if isinstance(seed, np.random.Generator):
        return np.random.RandomState(seed.integers(2 ** 31))
    raise ValueError(f"{seed!r} cannot be used to seed a RandomState")


def best_partition(graph, partition=None, weight="weight", resolution=1.0, randomize=None,
                   random_state=None) -> dict:
    """``{node: community}`` of Louvain on the adjacency ``graph``, seeded
    from ``random_state`` when it or ``randomize`` is given, else with 0
    (counterpart: :69)."""
    seed = (check_random_state(random_state).randint(2 ** 31)
            if (randomize or random_state is not None) else 0)
    labels = louvain(sp.csr_matrix(graph), resolution=resolution, seed=seed)
    return {i: int(c) for i, c in enumerate(labels)}


def modularity(partition, graph, weight="weight") -> float:
    """Newman's modularity of ``partition`` on a symmetric adjacency
    (counterpart: :82)."""
    a = sp.csr_matrix(graph)
    m2 = a.sum()  # 2m for symmetric adjacencies
    if m2 == 0:
        raise ValueError("A graph without link has an undefined modularity")
    labels = np.asarray([partition[i] for i in range(a.shape[0])])
    deg = np.asarray(a.sum(1)).ravel()
    q = 0.0
    for c in np.unique(labels):
        idx = np.nonzero(labels == c)[0]
        q += a[idx][:, idx].sum() / m2 - (deg[idx].sum() / m2) ** 2
    return float(q)


def induced_graph(partition, graph, weight="weight") -> sp.csr_matrix:
    """The adjacency of the communities, one node each, edge weights summed
    (counterpart: :100)."""
    a = sp.coo_matrix(graph)
    labels = np.asarray([partition[i] for i in range(a.shape[0])])
    k = int(labels.max()) + 1
    return sp.csr_matrix((a.data, (labels[a.row], labels[a.col])), shape=(k, k))


def generate_dendrogram(graph, part_init=None, weight="weight", resolution=1.0, randomize=None,
                        random_state=None) -> list:
    """The partitions from finest to coarsest; the port's Louvain, like the
    JAX package's, returns its last level only, so the list holds one
    (counterpart: :110)."""
    return [best_partition(graph, part_init, weight, resolution, randomize, random_state)]


def partition_at_level(dendrogram, level) -> dict:
    """Levels 0 .. ``level`` of ``dendrogram`` composed into one
    ``{node: community}`` (counterpart: :121)."""
    partition = dendrogram[0].copy()
    for index in range(1, level + 1):
        for node, community in partition.items():
            partition[node] = dendrogram[index][community]
    return partition


__all__ = ["Louvain", "best_partition", "check_random_state", "generate_dendrogram",
           "induced_graph", "louvain_preprocess", "modularity", "partition_at_level"]
