"""The cell kNN connectivity graph on arrays (counterpart: the array core of
``NeighborGraph.__call__``, dance_tpu/transforms/graph/neighbor_graph.py:8-38).

The JAX transform reads the representation from a ``Data`` channel and
writes the graph into ``obsp``; the port takes the representation and
returns the graph, and registers nothing (see transforms/cell_feature.py).
"""

from typing import Optional

import numpy as np
import scipy.sparse as sp

from dance_tpu_torch.ops.neighbors import knn_graph


def neighbor_graph(rep, n_neighbors: int = 15, *, n_pcs: Optional[int] = None) -> sp.csr_matrix:
    """Gaussian-weighted, symmetrised ``n_neighbors``-NN graph of the rows of
    ``rep`` without self-loops, on its first ``n_pcs`` columns when given
    (neighbor_graph.py:27-38)."""
    rep = np.asarray(rep, np.float32)
    if n_pcs is not None:
        rep = rep[:, :n_pcs]
    return knn_graph(rep, n_neighbors, mode="gauss", include_self=False, symmetrize=True)


__all__ = ["neighbor_graph"]
