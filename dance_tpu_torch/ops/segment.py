"""Message-passing ops over a CSR adjacency, the part AdaptiveSAGE's CSR branch
needs (counterpart: dance_tpu/ops/segment.py:14-32).

Rows are destinations. ``jax.ops.segment_sum`` becomes ``index_add_``. The
rest of the JAX module (``spmm`` dispatch, ``edge_softmax``, ``sddmm_dot``,
max aggregation, degrees) waits for later slices (ROADMAP Queue 1).
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


__all__ = ["aggregate", "gather_src"]
