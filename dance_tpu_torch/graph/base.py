"""Graph container: scipy CSR adjacency on the host, tensors on the device
(counterpart: dance_tpu/graph/base.py:19-179).

The host side is the JAX package's numpy/scipy code, so adjacencies come out
bit-identical; ``dance_tpu.graph`` itself cannot be imported here because it
pulls in JAX. The bipartite cell-gene graph is homogeneous: gene nodes first
(0..n_genes-1), then cell nodes. The device forms (``to_device``, ``to_bsr``,
``to_dense_adj``, ``to_adaptive_bsr``) go to the CUDA card unless the caller
names the CPU; inside a data-parallel fit ``to_device`` gives this rank's
node rows. Not ported yet: ``from_adjacency`` and the row
normalization.
"""

from typing import Dict, NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch

from dance_tpu_torch.ops.bsr import BSRMatrix, bsr_from_scipy
from dance_tpu_torch.ops.sparse import (AdaptiveBSR, CSRMatrix, DenseAdj, csr_from_scipy,
                                        dense_adj_from_scipy)
from dance_tpu_torch.parallel.mesh import to_device as place
from dance_tpu_torch.utils import resolve_device


class DeviceGraph(NamedTuple):
    """Adjacency and node features as tensors on one device (counterpart: base.py:19)."""

    adj: CSRMatrix
    ndata: Dict[str, torch.Tensor]


class Graph:
    """Host-side graph: scipy CSR adjacency (row = destination) + numpy node data."""

    def __init__(self, adj: sp.spmatrix, ndata: Optional[Dict[str, np.ndarray]] = None,
                 info: Optional[dict] = None):
        self.adj = sp.csr_matrix(adj)
        self.ndata: Dict[str, np.ndarray] = dict(ndata or {})
        self.info = dict(info or {})  # num_cells / num_genes for bipartite layouts

    @classmethod
    def from_cell_feature_matrix(cls, feat, cell_feature: np.ndarray,
                                 gene_feature: np.ndarray, *,
                                 normalize_edges: bool = True,
                                 add_self_loop: bool = True) -> "Graph":
        """Undirected cell-gene bipartite graph from nonzero expression
        (counterpart: base.py:41-77). ``ndata['features']`` stacks gene then
        cell features; ``cell_id`` holds the gene index (-1 for cells) and
        ``feat_id`` the cell index (-1 for genes), the reference's naming."""
        feat = sp.csr_matrix(feat)
        n_cells, n_genes = feat.shape
        n = n_cells + n_genes
        coo = feat.tocoo()
        rows = coo.row + n_genes  # cell nodes offset by gene nodes
        cols = coo.col
        w = coo.data.astype(np.float32)
        src = np.concatenate([rows, cols])
        dst = np.concatenate([cols, rows])
        ww = np.concatenate([w, w])
        adj = sp.csr_matrix((ww, (dst, src)), shape=(n, n))  # row = destination
        g = cls(adj, info={"num_cells": n_cells, "num_genes": n_genes})
        if normalize_edges:
            g.normalize_edges_by_in_degree()
        if add_self_loop:
            g.add_self_loop(1.0)
        g.ndata["cell_id"] = np.concatenate([np.arange(n_genes, dtype=np.int32),
                                             -np.ones(n_cells, dtype=np.int32)])
        g.ndata["feat_id"] = np.concatenate([-np.ones(n_genes, dtype=np.int32),
                                             np.arange(n_cells, dtype=np.int32)])
        g.ndata["features"] = np.vstack([np.asarray(gene_feature, np.float32),
                                         np.asarray(cell_feature, np.float32)])
        return g

    def add_self_loop(self, weight: float = 1.0) -> "Graph":
        """Counterpart: base.py:88."""
        n = self.adj.shape[0]
        self.adj = (self.adj + sp.diags(np.full(n, weight, np.float32))).tocsr()
        return self

    def normalize_edges_by_in_degree(self) -> "Graph":
        """In-edge weights of each node scaled to sum to its in-degree
        (counterpart: base.py:93)."""
        in_deg = np.diff(self.adj.indptr).astype(np.float32)
        row_sums = np.asarray(self.adj.sum(axis=1)).ravel()
        scale = np.divide(in_deg, row_sums, out=np.zeros_like(row_sums),
                          where=row_sums != 0)
        self.adj = (sp.diags(scale) @ self.adj).tocsr()
        return self

    def normalize_edges_sym(self) -> "Graph":
        """Symmetric ``D^-1/2 A D^-1/2``, degrees floored at 1e-12
        (counterpart: base.py:103)."""
        deg = np.asarray(self.adj.sum(axis=1)).ravel()
        dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
        self.adj = (sp.diags(dinv) @ self.adj @ sp.diags(dinv)).tocsr()
        return self

    @property
    def num_nodes(self) -> int:
        return self.adj.shape[0]

    @property
    def num_edges(self) -> int:
        return self.adj.nnz

    def subgraph(self, node_idx: np.ndarray) -> "Graph":
        """Counterpart: base.py:126."""
        node_idx = np.asarray(node_idx)
        return Graph(self.adj[node_idx][:, node_idx],
                     {k: v[node_idx] for k, v in self.ndata.items()}, dict(self.info))

    def to_device(self, device="auto") -> DeviceGraph:
        """CSR adjacency and numeric node data as tensors on ``device``
        (counterpart: base.py:132; integer labels become int64, torch's index
        type). Inside a data-parallel fit
        (:func:`~dance_tpu_torch.parallel.mesh.dp_context`) the node data
        take this rank's rows when the node count divides by ``dp`` and are
        replicated otherwise (``to_device(pad=False)``); the adjacency is
        replicated. Models that shard the adjacency itself build a
        :class:`~dance_tpu_torch.parallel.sharded_graph.ShardedCSR`."""
        device = resolve_device(device)
        ndata = {}
        for k, v in self.ndata.items():
            v = np.asarray(v)
            if v.dtype.kind in "iub":
                ndata[k] = place(v.astype(np.int64), pad=False, device=device)
            elif v.dtype.kind == "f":
                ndata[k] = place(v.astype(np.float32), pad=False, device=device)
        return DeviceGraph(csr_from_scipy(self.adj).to(device), ndata)

    def to_bsr(self, block: int = 128, device="auto") -> BSRMatrix:
        """The adjacency as BSR tiles on ``device``, for weighted sum, mean
        (with the row degrees) and max aggregation through
        :func:`~dance_tpu_torch.ops.segment.spmm` (counterpart: base.py:143)."""
        return bsr_from_scipy(self.adj, block=block).to(resolve_device(device))

    def to_dense_adj(self, device="auto") -> DenseAdj:
        """The adjacency as one dense matrix on ``device`` (counterpart: base.py:153)."""
        return dense_adj_from_scipy(self.adj).to(resolve_device(device))

    def to_adaptive_bsr(self, block: int = 128, dense: bool = False,
                        device="auto") -> AdaptiveBSR:
        """AdaptiveSAGE's decomposed form: one SpMM over the off-diagonal
        adjacency, per-node alpha scales and self-loop terms (counterpart:
        base.py:160-179). The off-diagonal is BSR tiles, or with ``dense`` a
        :class:`DenseAdj` (one cuBLAS product). Needs the bipartite
        ``cell_id`` node labels (gene index or -1)."""
        device = resolve_device(device)
        gene_idx = np.asarray(self.ndata["cell_id"], np.int64)
        adj = self.adj.tocsr()
        w_diag = np.asarray(adj.diagonal(), np.float32)
        off = adj - sp.diags(w_diag)
        off.eliminate_zeros()
        deg = np.diff(adj.indptr).astype(np.float32)
        off_dev = dense_adj_from_scipy(off) if dense else bsr_from_scipy(off, block=block)
        return AdaptiveBSR(off_dev, torch.from_numpy(w_diag),
                           torch.from_numpy(gene_idx), torch.from_numpy(deg),
                           int(self.info["num_genes"])).to(device)

    def __repr__(self):
        return (f"Graph(num_nodes={self.num_nodes}, num_edges={self.num_edges}, "
                f"ndata={list(self.ndata)}, info={self.info})")


__all__ = ["DeviceGraph", "Graph"]
