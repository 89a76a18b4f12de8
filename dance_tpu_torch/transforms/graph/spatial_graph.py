"""STAGATE's spatial graph on arrays (counterpart: the array core of
``StagateGraph.__call__``, dance_tpu/transforms/graph/spatial_graph.py:120-148).

The JAX transform reads coordinates from a ``Data`` container and writes the
graph into ``obsp``; the port takes the coordinates and returns the graph,
and registers nothing (see transforms/cell_feature.py).
"""

import numpy as np
import scipy.sparse as sp

from dance_tpu_torch.ops.neighbors import knn_graph, radius_graph

_MODELS = ("radius", "knn")


def stagate_graph(xy, model_name: str = "radius", *, radius: float = 1,
                  n_neighbors: int = 5) -> sp.csr_matrix:
    """Spot connectivity: every pair within ``radius`` (no self-loops), or
    each spot's ``n_neighbors`` nearest spots including itself, unsymmetrised."""
    if not isinstance(model_name, str) or model_name.lower() not in _MODELS:
        raise ValueError(f"Unknown model {model_name!r}, options: {_MODELS}")
    xy = np.asarray(xy, np.float32)
    if model_name.lower() == "radius":
        return sp.csr_matrix(radius_graph(xy, radius))
    return sp.csr_matrix(knn_graph(xy, n_neighbors, mode="connectivity", include_self=True,
                                   symmetrize=False))


__all__ = ["stagate_graph"]
