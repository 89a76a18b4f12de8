"""Block-row-sharded sparse adjacency (counterpart:
dance_tpu/parallel/sharded_graph.py:26-181).

The destination rows split into contiguous chunks of ``rows_per = ceil(n /
D)`` over the ``D`` ranks of ``dp`` (the last chunks short or empty); each
rank keeps only its chunk's edges, padded to the largest chunk's edge count
``E_max`` with weight 0, so per-rank edge storage is about 1/D of the graph.
:func:`sharded_spmm` all-gathers the (much smaller) node features and
segment-sums this rank's edges into its rows, as JAX's ``shard_map`` body
does, in a fixed order (the chunk as a CSR of its rows:
:func:`~dance_tpu_torch.ops.segment.segment_sum_csr`, the gather's
backward over its transposed order); its backward sums the feature
gradients over the ranks and hands each its rows. A model run this way
holds its node features as each rank's ``rows_per`` rows
(:func:`~dance_tpu_torch.parallel.mesh.to_device`'s layout).

Where this differs from the JAX package: a rank holds its chunk only (JAX's
arrays carry every chunk on a leading device axis; :func:`csr_chunks` builds
that stacked layout on the host), the output is this rank's rows (JAX's is
the whole ``(n, d)`` array), and the padding edges are left out of the sum,
so ``weighted=False`` does not count them (JAX's unweighted sum adds
``h[0]`` once per padding edge to each shard's first row).
"""

from typing import Dict, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from dance_tpu_torch.ops.sparse import CSRMatrix, kept
from dance_tpu_torch.parallel.mesh import Mesh, current_mesh, gather_rows, mesh_device


class ShardedCSR:
    """This rank's block-row chunk of a CSR adjacency.

    ``data``, ``indices`` (global source columns) and ``local_rows``
    (destination rows within the chunk) are (E_max,) tensors, padded with
    weight 0 past the chunk's ``n_edges`` real edges; ``edge_data`` holds
    per-edge arrays chunked the same way (e.g. AdaptiveSAGE's alpha index).
    ``shape`` is the true matrix shape, ``rows_per_shard`` the padded rows a
    rank holds, ``degrees`` the true in-degrees of all ``n`` rows."""

    def __init__(self, data, indices, local_rows, edge_data: Dict, shape: Tuple[int, int],
                 rows_per_shard: int, n_edges: int, degrees, mesh: Mesh, axis: str = "dp"):
        self.data, self.indices, self.local_rows = data, indices, local_rows
        self.edge_data = edge_data
        self.shape = tuple(shape)
        self.rows_per_shard, self.n_edges = int(rows_per_shard), int(n_edges)
        self.degrees, self.mesh, self.axis = degrees, mesh, axis

    @property
    def n_shards(self) -> int:
        return self.mesh.size(self.axis)

    @property
    def row_offset(self) -> int:
        return self.mesh.index(self.axis) * self.rows_per_shard

    def local_degrees(self) -> torch.Tensor:
        """The true in-degrees of this rank's ``rows_per_shard`` rows (0 on
        the padding rows)."""
        return _local_block(self.degrees, self.row_offset, self.rows_per_shard)

    def local_csr(self) -> CSRMatrix:
        """This rank's real edges as a CSR of its ``rows_per_shard`` rows over
        all ``n`` sources (the chunk is row-sorted), kept on the shard."""
        def build():
            k = self.n_edges
            rows = self.local_rows[:k]
            bounds = torch.arange(self.rows_per_shard + 1, device=rows.device, dtype=rows.dtype)
            return CSRMatrix(self.data[:k], self.indices[:k], torch.searchsorted(rows, bounds),
                             (self.rows_per_shard, self.shape[0]))
        return kept(self, "local_csr", (self.data, self.indices, self.local_rows), build)

    def __repr__(self):
        return (f"ShardedCSR(shape={self.shape}, shards={self.n_shards}, "
                f"edges_per_shard={self.data.shape[0]}, edges_here={self.n_edges})")


def _local_block(v: torch.Tensor, lo: int, rows: int) -> torch.Tensor:
    """Rows ``lo .. lo + rows`` of ``v``, zero past its end."""
    out = v.new_zeros((rows,) + v.shape[1:])
    part = v[lo:lo + rows]
    out[:part.shape[0]] = part
    return out


def csr_chunks(adj: sp.spmatrix, n_shards: int,
               edge_data: Optional[Dict[str, np.ndarray]] = None) -> Dict[str, np.ndarray]:
    """JAX's host partition (sharded_graph.py:83-120) as stacked numpy
    arrays: ``data``, ``indices``, ``local_rows`` and each ``edge_data``
    entry (D, E_max), ``n_edges`` (D,), ``rows_per_shard`` and ``degrees``."""
    adj = sp.csr_matrix(adj)
    n, _ = adj.shape
    rows_per = -(-n // n_shards)
    ptr = adj.indptr
    bounds = [(min(s * rows_per, n), min((s + 1) * rows_per, n)) for s in range(n_shards)]
    chunks = []
    for r0, r1 in bounds:
        rows_local = np.repeat(np.arange(r1 - r0, dtype=np.int32), np.diff(ptr[r0:r1 + 1]))
        chunks.append((adj.data[ptr[r0]:ptr[r1]].astype(np.float32),
                       adj.indices[ptr[r0]:ptr[r1]].astype(np.int32), rows_local))
    e_max = max(1, max(len(c[0]) for c in chunks))

    def pad(arr):
        return np.concatenate([arr, np.zeros(e_max - len(arr), dtype=arr.dtype)])

    out = {"data": np.stack([pad(c[0]) for c in chunks]),
           "indices": np.stack([pad(c[1]) for c in chunks]),
           "local_rows": np.stack([pad(c[2]) for c in chunks]),
           "n_edges": np.array([len(c[0]) for c in chunks], np.int64),
           "rows_per_shard": rows_per,
           "degrees": np.diff(ptr).astype(np.float32)}
    for name, arr in (edge_data or {}).items():
        arr = np.asarray(arr)
        out[name] = np.stack([pad(arr[ptr[r0]:ptr[r1]]) for r0, r1 in bounds])
    return out


def shard_csr(adj: sp.spmatrix, mesh: Optional[Mesh] = None, axis: str = "dp",
              edge_data: Optional[Dict[str, np.ndarray]] = None, device=None) -> ShardedCSR:
    """This rank's chunk of a scipy CSR, on ``device`` (the mesh's when
    None) (counterpart: sharded_graph.py:73). ``edge_data`` maps names to
    per-edge arrays in the CSR's edge order, chunked alongside. The CPU
    only when named (:func:`~dance_tpu_torch.parallel.mesh.mesh_device`)."""
    mesh = mesh or current_mesh(device)
    device = mesh_device(mesh, device)
    parts = csr_chunks(adj, mesh.size(axis), edge_data)
    i = mesh.index(axis)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    extra = {k: put(parts[k][i], torch.int64) for k in (edge_data or {})}
    return ShardedCSR(put(parts["data"][i], torch.float32), put(parts["indices"][i], torch.int64),
                      put(parts["local_rows"][i], torch.int64), extra, adj.shape,
                      parts["rows_per_shard"], parts["n_edges"][i],
                      put(parts["degrees"], torch.float32), mesh, axis)


def sharded_spmm(s: ShardedCSR, h: torch.Tensor, *, weighted: bool = True, op: str = "sum",
                 degrees: Optional[torch.Tensor] = None,
                 edge_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``A @ H`` for this rank's rows (counterpart: sharded_graph.py:124).

    ``h`` is this rank's ``rows_per_shard`` rows of the features (they are
    all-gathered, the backward summing their gradients over the ranks) or
    all ``n`` rows replicated (used as they are). The output is this rank's
    ``rows_per_shard`` rows; padding rows have no edges and give 0.
    ``op="mean"`` divides by the true in-degrees (``degrees``, all ``n``
    rows, else the adjacency's own). ``edge_scale`` is an optional per-edge
    multiplier in this rank's chunk order (e.g. alpha gathered by the alpha
    index)."""
    if op not in ("sum", "mean"):
        raise ValueError(f"unsupported sharded aggregation {op!r}")
    n = s.shape[0]
    rps = s.rows_per_shard
    if h.shape[0] == rps:
        h_all = gather_rows(h, s.mesh, s.axis)[:n]
    elif h.shape[0] == n:
        h_all = h
    else:
        raise ValueError(f"sharded_spmm takes this rank's {rps} rows or all {n}, got "
                         f"{h.shape[0]}")
    from dance_tpu_torch.ops.segment import gather_src, segment_sum_csr
    local = s.local_csr()
    msgs = gather_src(local, h_all)
    if weighted:
        msgs = msgs * local.data[:, None]
    if edge_scale is not None:
        msgs = msgs * edge_scale[:s.n_edges, None]
    out = segment_sum_csr(msgs, local.indptr)
    if op == "mean":
        deg = (_local_block(degrees, s.row_offset, rps) if degrees is not None
               else s.local_degrees())
        out = out / deg.clamp(min=1.0)[:, None]
    return out


__all__ = ["ShardedCSR", "csr_chunks", "shard_csr", "sharded_spmm"]
