"""Message-passing ops: the ``spmm`` dispatch over CSR, dense and BSR
adjacencies, and the segment ops under it (counterpart:
dance_tpu/ops/segment.py:14-114).

Rows are destinations. ``jax.ops.segment_sum`` becomes a sum in a fixed
order over destination-sorted edges (:func:`segment_sum_csr`: a CSR's
edges are sorted by row, so its segments are ``indptr``'s), which gives
the same bits on every run, as JAX's does; ``index_add_`` would add with
atomics in any order on the card. The gathers' backward passes are such
sums too: over ``indptr`` for a gather by destination (:func:`gather_dst`),
over ``Aᵀ``'s order (:meth:`~dance_tpu_torch.ops.sparse.CSRMatrix.col_order`,
built once per matrix) for a gather by source (:func:`gather_src`), and
over a kept sort of any other index (:func:`gather`). ``spmm`` on a CSR is
one autograd function (:func:`csr_spmm`): the fixed-order sum of
``w_e · h[src_e]``, ``dh`` the same sum on ``Aᵀ``, ``dw_e = ⟨ḡ[dst_e],
h[src_e]⟩``. ``segment_max`` is ``scatter_reduce(amax)`` on a
``-inf``-filled output (a maximum does not depend on the order), so that
an empty segment gives ``-inf`` as in JAX. A BSR adjacency runs the sums
through the differentiable SpMM (:func:`~dance_tpu_torch.ops.bsr.bsr_spmm_ad`)
and max aggregation through the forward-only
:func:`~dance_tpu_torch.ops.bsr.bsr_spmm_max`, each a CUDA kernel on the
card. A block-row-sharded adjacency (:class:`~dance_tpu_torch.parallel.
sharded_graph.ShardedCSR`) goes to :func:`~dance_tpu_torch.parallel.
sharded_graph.sharded_spmm` (sum or mean over this rank's rows).
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from dance_tpu_torch.ops.bsr import BSRMatrix, bsr_spmm_ad, bsr_spmm_max
from dance_tpu_torch.ops.sparse import CSRMatrix, DenseAdj
from dance_tpu_torch.parallel.sharded_graph import ShardedCSR, sharded_spmm

AGGREGATIONS = ("sum", "mean", "max")


def segment_sum_csr(values: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Sums of the consecutive runs ``values[offsets[i]:offsets[i + 1]]``
    along the first axis (an empty run gives 0), in an order fixed by the
    offsets alone, so the same bits on every run: on the card, 2-D values
    are added in their stored order and 1-D values by a segmented tree
    reduction whose shape depends only on the run's length; differentiable,
    its backward a gather."""
    return torch.segment_reduce(values, "sum", offsets=offsets, axis=0, unsafe=True)


class _Gather(torch.autograd.Function):
    """``x[index]`` whose backward sums the gradient in a fixed order: the
    entries ``perm`` (all of them when None) grouped by ``offsets``."""

    @staticmethod
    def forward(ctx, x, index, perm, offsets):
        ctx.save_for_backward(perm, offsets)
        ctx.n = x.shape[0]
        return x.index_select(0, index)

    @staticmethod
    def backward(ctx, g):
        perm, offsets = ctx.saved_tensors
        dx = segment_sum_csr(g if perm is None else g.index_select(0, perm), offsets)
        return _pad_rows(dx, ctx.n), None, None, None


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    return x if x.shape[0] == n else torch.cat([x, x.new_zeros((n - x.shape[0],) + x.shape[1:])])


def gather(x: torch.Tensor, index: torch.Tensor,
           order: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """``x[index]`` whose gradient is summed in a fixed order; ``order`` is
    :func:`~dance_tpu_torch.ops.sparse.index_order` of ``index``."""
    return _Gather.apply(x, index, *order)


def gather_src(adj: CSRMatrix, h: torch.Tensor) -> torch.Tensor:
    """Per-edge source features ``h[src]`` (counterpart: segment.py:14); the
    gradient summed over each source's edges in ``Aᵀ``'s order."""
    return _Gather.apply(h, adj.indices, *adj.col_order())


def gather_dst(adj: CSRMatrix, h: torch.Tensor) -> torch.Tensor:
    """Per-edge destination features ``h[dst]``; the gradient summed over
    each row's edges in CSR order."""
    return _Gather.apply(h, adj.row_ids(), None, adj.indptr)


def aggregate(adj: CSRMatrix, messages: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Aggregate per-edge messages to destination nodes (counterpart:
    segment.py:19). ``op`` is ``"sum"``, ``"mean"`` or ``"max"``; a node
    without incoming edges gets 0, 0 and ``-inf``."""
    if op == "max":
        rows = adj.row_ids()
        index = rows.view(-1, *([1] * (messages.dim() - 1))).expand_as(messages)
        out = messages.new_full((adj.shape[0],) + messages.shape[1:], -torch.inf)
        return out.scatter_reduce(0, index, messages, "amax", include_self=False)
    if op not in ("sum", "mean"):
        raise ValueError(f"Unknown aggregation {op!r}")
    out = segment_sum_csr(messages, adj.indptr)
    return out if op == "sum" else _mean(adj, out)


def _mean(adj: CSRMatrix, out: torch.Tensor) -> torch.Tensor:
    deg = (adj.indptr[1:] - adj.indptr[:-1]).to(out.dtype)
    return out / deg.clamp(min=1.0).view(-1, *([1] * (out.dim() - 1)))


class _CSRSpmm(torch.autograd.Function):
    """``out[r] = Σ_e w_e h[src_e]`` over row ``r``'s edges in CSR order;
    ``dh`` the same sum on ``Aᵀ``, ``dw_e = ⟨ḡ[dst_e], h[src_e]⟩``."""

    @staticmethod
    def forward(ctx, h, w, adj):
        ctx.save_for_backward(h, w)
        ctx.adj = adj
        msgs = h.index_select(0, adj.indices)
        if w is not None:
            msgs = msgs * w.view(-1, *([1] * (h.dim() - 1)))
        return segment_sum_csr(msgs, adj.indptr)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        adj = ctx.adj
        g_dst = g.index_select(0, adj.row_ids())
        dh = dw = None
        if ctx.needs_input_grad[0]:
            perm, col_ptr = adj.col_order()
            msgs = g_dst if w is None else g_dst * w.view(-1, *([1] * (h.dim() - 1)))
            dh = _pad_rows(segment_sum_csr(msgs.index_select(0, perm), col_ptr), h.shape[0])
        if w is not None and ctx.needs_input_grad[1]:
            dw = (g_dst * h.index_select(0, adj.indices)).reshape(g_dst.shape[0], -1).sum(1)
        return dh, dw, None


def csr_spmm(adj: CSRMatrix, h: torch.Tensor, w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``A @ h`` with per-edge weights ``w`` (or 1 where None) summed in
    CSR order, differentiable in ``h`` and ``w`` by fixed-order sums."""
    return _CSRSpmm.apply(h, w, adj)


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
    if op == "max":
        msgs = gather_src(adj, h)
        if weighted:
            msgs = msgs * adj.data[:, None]
        return aggregate(adj, msgs, op="max")
    if op not in ("sum", "mean"):
        raise ValueError(f"Unknown aggregation {op!r}")
    out = csr_spmm(adj, h, adj.data if weighted else None)
    return out if op == "sum" else _mean(adj, out)


def edge_softmax(adj: CSRMatrix, logits: torch.Tensor) -> torch.Tensor:
    """Softmax of per-edge logits, (nnz,) or (nnz, heads), over each
    destination's incoming edges (counterpart: segment.py:88).

    The per-row max is taken out of the graph: the softmax does not depend on
    it, so its gradient is zero in exact arithmetic. The denominators are
    fixed-order sums."""
    rows = adj.row_ids()
    index = rows.view(-1, *([1] * (logits.dim() - 1))).expand_as(logits)
    maxes = logits.new_full((adj.shape[0],) + logits.shape[1:], -torch.inf)
    maxes = maxes.scatter_reduce(0, index, logits.detach(), "amax")
    maxes = torch.where(torch.isfinite(maxes), maxes, 0.0)
    exp = torch.exp(logits - maxes.index_select(0, rows))
    denom = segment_sum_csr(exp, adj.indptr)
    return exp / gather_dst(adj, denom).clamp(min=1e-12)


def sddmm_dot(adj: CSRMatrix, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-edge dot products ``a[dst]·b[src]`` (counterpart: segment.py:101)."""
    return (gather_dst(adj, a) * gather_src(adj, b)).sum(-1)


def in_degrees(adj: CSRMatrix) -> torch.Tensor:
    """Stored entries per row, float32 (counterpart: segment.py:107)."""
    return (adj.indptr[1:] - adj.indptr[:-1]).to(torch.float32)


def out_degrees(adj: CSRMatrix) -> torch.Tensor:
    """Stored entries per column, float32 (counterpart: segment.py:111):
    the row lengths of ``Aᵀ``."""
    col_ptr = adj.col_order()[1]
    return (col_ptr[1:] - col_ptr[:-1]).to(torch.float32)


__all__ = ["AGGREGATIONS", "aggregate", "csr_spmm", "edge_softmax", "gather", "gather_dst",
           "gather_src", "in_degrees", "out_degrees", "sddmm_dot", "segment_sum_csr", "spmm"]
