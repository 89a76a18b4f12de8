"""The cell kNN connectivity graph (counterpart:
dance_tpu/transforms/graph/neighbor_graph.py:8-38): :func:`neighbor_graph`
on arrays, and :class:`NeighborGraph`, JAX's transform on a port ``Data``,
registered under JAX's key.
"""

from typing import Optional

import numpy as np
import scipy.sparse as sp

from dance_tpu_torch.ops.neighbors import knn_graph
from dance_tpu_torch.registry import register_preprocessor
from dance_tpu_torch.transforms.base import BaseTransform


def neighbor_graph(rep, n_neighbors: int = 15, *, n_pcs: Optional[int] = None) -> sp.csr_matrix:
    """Gaussian-weighted, symmetrised ``n_neighbors``-NN graph of the rows of
    ``rep`` without self-loops, on its first ``n_pcs`` columns when given
    (neighbor_graph.py:27-38)."""
    rep = np.asarray(rep, np.float32)
    if n_pcs is not None:
        rep = rep[:, :n_pcs]
    return knn_graph(rep, n_neighbors, mode="gauss", include_self=False, symmetrize=True)


@register_preprocessor("graph", "cell")
class NeighborGraph(BaseTransform):
    """:func:`neighbor_graph` of a ``Data`` channel (``obsm[channel]``, ``X``
    when None) into ``obsp[out]`` (counterpart: neighbor_graph.py:9). JAX's
    ``knn``, ``random_state``, ``method`` and ``metric`` change nothing
    there (the graph is the exact euclidean kNN's): the port keeps their
    defaults as constants, printed in the digest as JAX prints them."""

    _DISPLAY_ATTRS = ("n_neighbors", "n_pcs", "knn", "random_state", "method", "metric")
    knn, random_state, method, metric = True, 0, "umap", "euclidean"

    def __init__(self, n_neighbors: int = 15, *, n_pcs: Optional[int] = None,
                 channel: Optional[str] = "CellPCA", **kwargs):
        super().__init__(**kwargs)
        self.n_neighbors = n_neighbors
        self.n_pcs = n_pcs
        self.channel = channel

    def __call__(self, data):
        self.logger.info("Computing kNN connectivity adjacency matrix")
        rep = data.get_feature(return_type="numpy", channel=self.channel)
        data.data.obsp[self.out] = neighbor_graph(rep, self.n_neighbors, n_pcs=self.n_pcs)
        return data


__all__ = ["NeighborGraph", "neighbor_graph"]
