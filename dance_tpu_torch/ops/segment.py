"""Message-passing ops over a CSR adjacency, the part AdaptiveSAGE's and the
GAT layers' CSR branches need (counterpart: dance_tpu/ops/segment.py:14-32,
88-98).

Rows are destinations. ``jax.ops.segment_sum`` becomes ``index_add_`` and
``segment_max`` ``scatter_reduce(amax)``. The rest of the JAX module (``spmm``
dispatch, ``sddmm_dot``, max aggregation, degrees) waits for later slices
(ROADMAP Queue 1).
"""

import torch

from dance_tpu_torch.ops.sparse import CSRMatrix


def gather_src(adj: CSRMatrix, h: torch.Tensor) -> torch.Tensor:
    """Per-edge source features ``h[src]`` (counterpart: segment.py:14)."""
    return h.index_select(0, adj.indices)


def aggregate(adj: CSRMatrix, messages: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Aggregate per-edge messages to destination nodes (counterpart:
    segment.py:19). ``op`` is ``"sum"`` or ``"mean"``."""
    rows = adj.row_ids()
    n = adj.shape[0]
    out = messages.new_zeros((n,) + messages.shape[1:]).index_add_(0, rows, messages)
    if op == "sum":
        return out
    if op == "mean":
        deg = (adj.indptr[1:] - adj.indptr[:-1]).to(messages.dtype)
        return out / deg.clamp(min=1.0)[:, None]
    raise NotImplementedError(f"aggregation {op!r} is not ported yet "
                              f"(ROADMAP Queue 1, 'left out of slice 1')")


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


__all__ = ["aggregate", "edge_softmax", "gather_src"]
