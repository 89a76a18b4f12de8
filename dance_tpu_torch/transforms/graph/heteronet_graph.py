"""scHeteroNet's cell kNN graph on arrays (counterpart:
dance_tpu/transforms/graph/heteronet_graph.py:14-44, ``HeteronetGraph``).

The JAX transform reads the feature channel of a ``Data`` container and
writes the graph into ``uns``; the port takes the features and returns the
:class:`~dance_tpu_torch.graph.Graph`.
"""

import numpy as np
import scipy.sparse as sp

from dance_tpu_torch.graph import Graph
from dance_tpu_torch.ops.neighbors import knn_graph


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


__all__ = ["heteronet_graph"]
