"""Message-passing ops: the ``spmm`` dispatch over CSR, dense and BSR
adjacencies, and the segment ops under it (counterpart:
dance_tpu/ops/segment.py:14-114).

Rows are destinations. ``jax.ops.segment_sum`` becomes ``index_add_`` and
``segment_max`` ``scatter_reduce(amax)`` on a ``-inf``-filled output, so that
an empty segment gives ``-inf`` as in JAX. A BSR adjacency runs the sums
through the differentiable SpMM (:func:`~dance_tpu_torch.ops.bsr.bsr_spmm_ad`)
and max aggregation through the forward-only
:func:`~dance_tpu_torch.ops.bsr.bsr_spmm_max`, each a CUDA kernel on the
card. A block-row-sharded adjacency (:class:`~dance_tpu_torch.parallel.
sharded_graph.ShardedCSR`) goes to :func:`~dance_tpu_torch.parallel.
sharded_graph.sharded_spmm` (sum or mean over this rank's rows).
"""

from typing import Optional

import torch
import torch.nn.functional as F

from dance_tpu_torch.ops.bsr import BSRMatrix, bsr_spmm_ad, bsr_spmm_max
from dance_tpu_torch.ops.sparse import CSRMatrix, DenseAdj
from dance_tpu_torch.parallel.sharded_graph import ShardedCSR, sharded_spmm

AGGREGATIONS = ("sum", "mean", "max")


def gather_src(adj: CSRMatrix, h: torch.Tensor) -> torch.Tensor:
    """Per-edge source features ``h[src]`` (counterpart: segment.py:14)."""
    return h.index_select(0, adj.indices)


def aggregate(adj: CSRMatrix, messages: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Aggregate per-edge messages to destination nodes (counterpart:
    segment.py:19). ``op`` is ``"sum"``, ``"mean"`` or ``"max"``; a node
    without incoming edges gets 0, 0 and ``-inf``."""
    rows = adj.row_ids()
    n = adj.shape[0]
    if op == "max":
        index = rows.view(-1, *([1] * (messages.dim() - 1))).expand_as(messages)
        out = messages.new_full((n,) + messages.shape[1:], -torch.inf)
        return out.scatter_reduce(0, index, messages, "amax", include_self=False)
    if op not in ("sum", "mean"):
        raise ValueError(f"Unknown aggregation {op!r}")
    out = messages.new_zeros((n,) + messages.shape[1:]).index_add_(0, rows, messages)
    if op == "sum":
        return out
    deg = (adj.indptr[1:] - adj.indptr[:-1]).to(messages.dtype)
    return out / deg.clamp(min=1.0)[:, None]


def spmm(adj, h: torch.Tensor, *, weighted: bool = True, op: str = "sum",
         degrees: Optional[torch.Tensor] = None, n_out: Optional[int] = None) -> torch.Tensor:
    """``A @ H`` with optional edge weights, the core message-passing op
    (counterpart: segment.py:35-85).

    - :class:`CSRMatrix`: gather and segment sum, mean or max.
    - :class:`DenseAdj`: one matrix product, sum or mean.
    - :class:`BSRMatrix`: weighted sum, mean (pass the per-row edge counts as
      ``degrees``: a zero slot of a tile means "no edge") and weighted or
      unweighted max (forward only; rows without an edge give ``-inf``). For
      a rectangular BSR adjacency pass ``n_out``, the true number of output
      rows; it defaults to ``h.shape[0]``.
    - :class:`ShardedCSR`: this rank's rows of the sum or mean
      (:func:`sharded_spmm`; ``degrees``, when given, are the true in-degrees
      of all rows).
    """
    if isinstance(adj, ShardedCSR):
        return sharded_spmm(adj, h, weighted=weighted, op=op, degrees=degrees)
    if isinstance(adj, DenseAdj):
        if op not in ("sum", "mean"):
            raise ValueError("DenseAdj supports sum/mean aggregation; use the CSR adjacency "
                             "for max")
        mat = adj.mat if weighted else (adj.mat != 0).to(h.dtype)
        out = mat @ h
        if op == "mean":
            out = out / adj.degrees.clamp(min=1.0)[:, None]
        return out
    if isinstance(adj, BSRMatrix):
        if op not in AGGREGATIONS:
            raise ValueError(f"Unknown aggregation {op!r}")
        if not weighted and op != "max":
            raise ValueError("BSR path supports weighted sum/mean and (un)weighted max; use "
                             "the CSR adjacency for unweighted sum/mean")
        if op == "mean" and degrees is None:
            raise ValueError("BSR mean aggregation needs the per-row edge-count vector "
                             "(degrees=...) from the graph builder")
        n = n_out if n_out is not None else h.shape[0]
        hp = F.pad(h, (0, 0, 0, adj.shape[1] - h.shape[0]))
        if op == "max":
            return bsr_spmm_max(adj, hp, weighted=weighted)[:n]
        out = bsr_spmm_ad(adj, hp)[:n]
        if op == "mean":
            out = out / degrees[:n].clamp(min=1.0)[:, None]
        return out
    if not isinstance(adj, CSRMatrix):
        raise TypeError(f"spmm takes a CSRMatrix, DenseAdj, BSRMatrix or ShardedCSR, got "
                        f"{type(adj).__name__}")
    msgs = gather_src(adj, h)
    if weighted:
        msgs = msgs * adj.data[:, None]
    return aggregate(adj, msgs, op=op)


def edge_softmax(adj: CSRMatrix, logits: torch.Tensor) -> torch.Tensor:
    """Softmax of per-edge logits, (nnz,) or (nnz, heads), over each
    destination's incoming edges (counterpart: segment.py:88).

    The per-row max is taken out of the graph: the softmax does not depend on
    it, so its gradient is zero in exact arithmetic."""
    rows = adj.row_ids()
    index = rows.view(-1, *([1] * (logits.dim() - 1))).expand_as(logits)
    maxes = logits.new_full((adj.shape[0],) + logits.shape[1:], -torch.inf)
    maxes = maxes.scatter_reduce(0, index, logits.detach(), "amax")
    maxes = torch.where(torch.isfinite(maxes), maxes, 0.0)
    exp = torch.exp(logits - maxes.index_select(0, rows))
    denom = torch.zeros_like(maxes).index_add_(0, rows, exp)
    return exp / denom.index_select(0, rows).clamp(min=1e-12)


def sddmm_dot(adj: CSRMatrix, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-edge dot products ``a[dst]·b[src]`` (counterpart: segment.py:101)."""
    return (a.index_select(0, adj.row_ids()) * b.index_select(0, adj.indices)).sum(-1)


def in_degrees(adj: CSRMatrix) -> torch.Tensor:
    """Stored entries per row, float32 (counterpart: segment.py:107)."""
    return (adj.indptr[1:] - adj.indptr[:-1]).to(torch.float32)


def out_degrees(adj: CSRMatrix) -> torch.Tensor:
    """Stored entries per column, float32 (counterpart: segment.py:111)."""
    return torch.zeros(adj.shape[1], dtype=torch.float32, device=adj.indices.device) \
        .index_add_(0, adj.indices, torch.ones(adj.indices.shape[0], device=adj.indices.device))


__all__ = ["AGGREGATIONS", "aggregate", "edge_softmax", "gather_src", "in_degrees",
           "out_degrees", "sddmm_dot", "spmm"]
