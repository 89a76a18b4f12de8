"""RESEPT's spatial graph on arrays (counterpart: ``RESEPTGraph``,
dance_tpu/transforms/graph/resept_graph.py:11-36): the symmetrised kNN
connectivity of the spots' coordinates (a KD-tree, the JAX package's graph
bit for bit), each edge weighted by the cosine similarity of the two spots'
expression embeddings clipped at 0, in float64 on ``device`` (the CUDA card
unless the CPU is named). JAX takes the whole n x n similarity matrix and
keeps its entries on the edges; the port computes them on the edges only.
The JAX transform reads ``obsm`` and writes ``obsp``; the port takes the
coordinates and the embedding and returns the graph.
"""

import numpy as np
import scipy.sparse as sp
import torch

from dance_tpu_torch.ops.neighbors import knn_graph
from dance_tpu_torch.utils import resolve_device


class RESEPTGraph:
    """``__call__(xy, feat=None)``: the ``n_neighbors``-NN graph of ``xy``
    without self-loops, weighted by the clipped cosine similarity of the
    rows of ``feat`` when given (JAX's ``feature_channel``), as scipy CSR
    (counterpart: resept_graph.py:11)."""

    def __init__(self, n_neighbors: int = 10, device="auto"):
        self.n_neighbors = n_neighbors
        self.device = device

    def __call__(self, xy, feat=None) -> sp.csr_matrix:
        xy = np.asarray(xy, np.float32)
        adj = knn_graph(xy, min(self.n_neighbors, len(xy) - 1), mode="connectivity",
                        include_self=False)
        if feat is None:
            return sp.csr_matrix(adj)
        device = resolve_device(self.device)
        f = torch.from_numpy(np.asarray(feat, np.float64)).to(device)
        fn = f / torch.linalg.vector_norm(f, dim=1, keepdim=True).clamp(min=1e-12)
        coo = adj.tocoo()
        rows = torch.from_numpy(coo.row.astype(np.int64)).to(device)
        cols = torch.from_numpy(coo.col.astype(np.int64)).to(device)
        sim = (fn[rows] * fn[cols]).sum(1).clamp(min=0.0)
        w = coo.data.astype(np.float64) * sim.cpu().numpy()
        return sp.csr_matrix((w, (coo.row, coo.col)), shape=adj.shape)


__all__ = ["RESEPTGraph"]
