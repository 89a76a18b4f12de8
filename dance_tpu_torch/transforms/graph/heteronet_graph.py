"""scHeteroNet's cell kNN graph (counterpart:
dance_tpu/transforms/graph/heteronet_graph.py:14-44): :func:`heteronet_graph`
takes the features and returns the :class:`~dance_tpu_torch.graph.Graph`;
:class:`HeteronetGraph`, JAX's transform, writes it into a port ``Data``'s
``uns`` and is registered under JAX's key.
"""

import numpy as np
import scipy.sparse as sp

from dance_tpu_torch.graph import Graph
from dance_tpu_torch.ops.neighbors import knn_graph
from dance_tpu_torch.registry import register_preprocessor
from dance_tpu_torch.transforms.base import BaseTransform


def heteronet_graph(feat, knn_num: int = 5, distance_metrics: str = "l2") -> Graph:
    """The symmetrised ``knn_num``-NN connectivity graph of the rows of
    ``feat`` without self-loops (Euclidean; ``distance_metrics`` is kept for
    the reference's signature and only ``"l2"`` is taken, as JAX computes
    it), carrying ``ndata["feat"]`` and ``info["num_cells"]``."""
    if distance_metrics != "l2":
        raise ValueError(f"heteronet_graph: only distance_metrics='l2' is computed, got "
                         f"{distance_metrics!r}")
    feat = np.asarray(feat.toarray() if sp.issparse(feat) else feat, dtype=np.float32)
    adj = knn_graph(feat, min(knn_num, feat.shape[0] - 1), mode="connectivity",
                    include_self=False, symmetrize=True)
    g = Graph(sp.csr_matrix(adj), info={"num_cells": feat.shape[0]})
    g.ndata["feat"] = feat
    return g


@register_preprocessor("graph", "cell")
class HeteronetGraph(BaseTransform):
    """:func:`heteronet_graph` of a ``Data``'s ``X`` into ``uns[out]``
    (counterpart: heteronet_graph.py:13). JAX's ``random_state`` and
    ``ignore_first``, which it ignores, and its channel options, which no
    pipeline sets, are not taken."""

    _DISPLAY_ATTRS = ("knn_num", "distance_metrics")

    def __init__(self, knn_num: int = 5, distance_metrics: str = "l2", **kwargs):
        super().__init__(**kwargs)
        self.knn_num = knn_num
        self.distance_metrics = distance_metrics

    def __call__(self, data):
        feat = data.get_feature(return_type="numpy", channel_type="X")
        data.data.uns[self.out] = heteronet_graph(feat, self.knn_num, self.distance_metrics)
        return data


__all__ = ["HeteronetGraph", "heteronet_graph"]
