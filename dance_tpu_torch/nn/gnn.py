"""Graph layers: the GCN and GraphSAGE convolutions, graph-sc's
WeightedGraphConv, scDeepSort's AdaptiveSAGE, the GAT convolution and
scTAG's TAGConv (counterparts: dance_tpu/nn/gnn.py:20-32, 35-61, 64-72,
75-163, 166-203, 206-219).

GCNConv, SAGEConv, WeightedGraphConv and TAGConv aggregate through
:func:`~dance_tpu_torch.ops.segment.spmm`, so their adjacency may be CSR,
dense or BSR: on a BSR adjacency a sum or mean is the SpMM kernel and a max
the forward-only max kernel.

AdaptiveSAGE has two branches, as in the JAX package:

- an :class:`~dance_tpu_torch.ops.sparse.AdaptiveBSR` adjacency runs the
  whole edge gather as one block-sparse SpMM (:func:`bsr_spmm_ad`, the CUDA
  kernel on the card), or one dense product when its off-diagonal is a
  :class:`~dance_tpu_torch.ops.sparse.DenseAdj`, plus per-node terms; only
  the gene nodes gather their alpha, by a gather whose gradient is a
  fixed-order sum (:func:`_node_scales`);
- a :class:`~dance_tpu_torch.ops.sparse.CSRMatrix` gathers per-edge messages
  and mean-aggregates them by the fixed-order segment sum
  (:func:`~dance_tpu_torch.ops.segment.aggregate`); the alpha gather's
  gradient is summed in a fixed order too (:func:`_alpha_gather`).

``bsr_dtype=torch.bfloat16`` streams the BSR branch's SpMM in bf16 with
float32 sums (gnn.py:90, :125-130); the dense and CSR branches ignore it, as
JAX's do. A :class:`~dance_tpu_torch.parallel.sharded_graph.ShardedCSR`
(a data-parallel fit's block rows, gnn.py:134-140) runs one
:func:`~dance_tpu_torch.parallel.sharded_graph.sharded_spmm` mean with the
alpha index riding the edge chunks as ``edge_scale``; ``h`` is then this
rank's rows.
flax's ``LayerNorm`` eps is 1e-6, and torch's default 1e-5 is overridden.

GATConv, too: a :class:`~dance_tpu_torch.ops.bsr.BSRMatrix` runs each head as
one fused GAT (:func:`bsr_gat_ad`, the CUDA kernels on the card), a
:class:`CSRMatrix` takes per-edge logits through :func:`edge_softmax`.
"""

import math
from typing import Optional, Tuple

import torch
from torch import nn

from dance_tpu_torch.ops.bsr import BSRMatrix, bsr_gat_ad, bsr_spmm_ad
from dance_tpu_torch.ops.segment import (aggregate, edge_softmax, gather, gather_dst,
                                         gather_src, in_degrees, out_degrees, spmm)
from dance_tpu_torch.ops.sparse import AdaptiveBSR, CSRMatrix, DenseAdj, index_order, kept
from dance_tpu_torch.parallel.sharded_graph import ShardedCSR, sharded_spmm

GRAPH_CONV_NORMS = ("none", "both", "right")
# the standard deviation of a unit normal cut at ±2 (flax's truncated normal
# initializers divide by it so that the cut distribution has the set variance)
_TRUNC_STD = 0.87962566103423978


def truncated_normal_(weight: torch.Tensor, std: float,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's ``variance_scaling(..., "truncated_normal")``: a normal cut at
    two standard deviations, scaled so that what is left has ``std``."""
    std = std / _TRUNC_STD
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


def flax_dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
                 rows: Optional[Tuple[Optional[torch.Tensor], int]] = None,
                 dim: int = 0) -> torch.Tensor:
    """flax ``Dropout``: keep with probability ``1 - rate`` and scale by its
    inverse; the uniforms come from ``generator`` on ``x``'s device. Without a
    generator (evaluation) or at rate 0, ``x`` itself; at rate 1, zeros.
    With ``rows = (pos, size)``, ``x`` holds the entries ``pos`` along
    ``dim`` of a batch of ``size`` (a data-parallel rank's rows): the
    uniforms are drawn for the whole batch, as the single fit draws them,
    and cut to ``pos`` (all of them when ``pos`` is None)."""
    if generator is None or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    if rows is None or rows[0] is None:
        u = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        pos, size = rows
        shape = x.shape[:dim] + (size,) + x.shape[dim + 1:]
        u = torch.rand(shape, generator=generator, device=x.device)
        u = u.index_select(dim, pos.to(x.device))
    return torch.where(u < 1.0 - rate, x / (1.0 - rate), 0.0)


def flax_dense_init_(linear: nn.Linear, generator: Optional[torch.Generator] = None):
    """flax ``Dense``'s default init: a lecun-normal kernel (truncated normal
    of variance 1 / fan-in) and a zero bias."""
    truncated_normal_(linear.weight, math.sqrt(1.0 / linear.in_features), generator)
    if linear.bias is not None:
        nn.init.zeros_(linear.bias)


class GCNConv(nn.Module):
    """Kipf and Welling's GCN layer on a (symmetrically) normalised
    adjacency, ``act(A @ linear(h))`` (counterpart: gnn.py:20): the product
    through :func:`spmm`, so a BSR adjacency runs the SpMM kernel forward
    and for ``Aᵀḡ``. flax's init: a glorot-uniform kernel and a zero bias.
    flax infers the input width; torch takes it."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True, activation=None):
        super().__init__()
        self.linear = nn.Linear(in_dim, out_dim, bias=use_bias)
        self.activation = activation
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.xavier_uniform_(self.linear.weight, generator=generator)
        if self.linear.bias is not None:
            nn.init.zeros_(self.linear.bias)

    def forward(self, adj, h: torch.Tensor) -> torch.Tensor:
        out = spmm(adj, self.linear(h))
        return self.activation(out) if self.activation is not None else out


class SAGEConv(nn.Module):
    """GraphSAGE with mean aggregation, ``linear_self(h) +
    linear_neigh(mean of the in-neighbours' h)`` (counterpart: gnn.py:64):
    the mean through :func:`spmm` without ``degrees``, as JAX calls it, so a
    BSR adjacency raises as JAX's dispatch does. flax's ``Dense`` init for
    both kernels; the neighbour one has no bias."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.fc_self = nn.Linear(in_dim, out_dim)
        self.fc_neigh = nn.Linear(in_dim, out_dim, bias=False)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        flax_dense_init_(self.fc_self, generator)
        flax_dense_init_(self.fc_neigh, generator)

    def forward(self, adj, h: torch.Tensor) -> torch.Tensor:
        neigh = spmm(adj, h, op="mean")
        return self.fc_self(h) + self.fc_neigh(neigh)


class WeightedGraphConv(nn.Module):
    """DGL's GraphConv with edge weights (counterpart: gnn.py:35, parity with
    graph-sc's WeightedGraphConv): ``h -> linear(h)`` without bias, aggregated
    over the weighted in-edges by ``agg`` (sum, mean or max), plus a bias.
    ``norm="both"`` scales by out-degree^-1/2 before and in-degree^-1/2
    after, ``"right"`` divides by the in-degree after; both need the CSR
    adjacency's degrees. flax infers the input width; torch takes it."""

    def __init__(self, in_dim: int, out_dim: int, norm: str = "both", use_bias: bool = True):
        super().__init__()
        if norm not in GRAPH_CONV_NORMS:
            raise ValueError(f"norm must be one of {GRAPH_CONV_NORMS}, got {norm!r}")
        self.norm = norm
        self.linear = nn.Linear(in_dim, out_dim, bias=False)
        self.bias = nn.Parameter(torch.zeros(out_dim)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's init: glorot-uniform kernel, zero bias."""
        nn.init.xavier_uniform_(self.linear.weight, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, adj, h: torch.Tensor, agg: str = "sum",
                degrees: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.norm != "none" and not isinstance(adj, CSRMatrix):
            raise TypeError(f"WeightedGraphConv(norm={self.norm!r}) needs the CSR "
                            f"adjacency's degrees, got {type(adj).__name__}")
        if self.norm == "both":
            h = h * torch.rsqrt(out_degrees(adj).clamp(min=1.0))[:, None]
        # BSR mean aggregation needs the per-row edge counts from the builder
        out = spmm(adj, self.linear(h), op=agg, degrees=degrees)
        if self.norm == "both":
            out = out * torch.rsqrt(in_degrees(adj).clamp(min=1.0))[:, None]
        elif self.norm == "right":
            out = out / in_degrees(adj).clamp(min=1.0)[:, None]
        return out + self.bias if self.bias is not None else out


class AdaptiveSAGE(nn.Module):
    """Each edge's message is ``h_src * alpha[edge_type_index] * edge_weight``,
    mean-aggregated, then Dropout -> Linear -> ReLU -> LayerNorm (none with
    ``use_norm=False``, gnn.py:88, :147-148).

    ``alpha`` (n_genes + 2,) is shared across layers and owned by the caller
    (the reference's per-gene beta plus gene/cell self-loop strengths).
    ``bsr_dtype`` (``None`` or ``torch.bfloat16``) is the BSR SpMM's
    ``compute_dtype``."""

    def __init__(self, in_dim: int, out_dim: int, dropout: float = 0.1, use_norm: bool = True,
                 bsr_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout = nn.Dropout(dropout)
        self.linear = nn.Linear(in_dim, out_dim)
        self.norm = nn.LayerNorm(out_dim, eps=1e-6) if use_norm else None
        self.bsr_dtype = bsr_dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's init: xavier-uniform kernel, zero bias, unit LayerNorm."""
        nn.init.xavier_uniform_(self.linear.weight, generator=generator)
        nn.init.zeros_(self.linear.bias)
        if self.norm is not None:
            self.norm.reset_parameters()

    @staticmethod
    def edge_alpha_index(adj_rows, adj_indices, gene_id, n_genes: int) -> torch.Tensor:
        """Per-edge alpha index (counterpart: gnn.py:92-107 and its traced twin
        :152-159): the source gene for gene->cell edges, the destination gene
        for cell->gene edges, ``n_genes`` for gene self-loops and
        ``n_genes + 1`` otherwise. Depends on the graph only, so callers
        compute it once per graph."""
        gene_id = torch.as_tensor(gene_id)
        src_id = gene_id[torch.as_tensor(adj_indices)].long()
        dst_id = gene_id[torch.as_tensor(adj_rows)].long()
        idx = torch.full_like(src_id, n_genes + 1)                         # cell self
        idx = torch.where((src_id >= 0) & (dst_id < 0), src_id, idx)       # gene -> cell
        idx = torch.where((dst_id >= 0) & (src_id < 0), dst_id, idx)       # cell -> gene
        idx = torch.where((dst_id >= 0) & (src_id >= 0), n_genes, idx)     # gene self
        return idx

    def forward(self, adj, h: torch.Tensor, gene_id: torch.Tensor, alpha: torch.Tensor,
                alpha_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        n_genes = alpha.shape[0] - 2
        if isinstance(adj, AdaptiveBSR):
            gidx = adj.gene_idx
            s = _node_scales(adj, alpha)
            self_alpha = torch.where(gidx >= 0, alpha[n_genes], alpha[n_genes + 1])
            n = h.shape[0]
            if isinstance(adj.bsr, DenseAdj):
                neigh = s[:, None] * (adj.bsr.mat @ (s[:, None] * h))
            else:
                hp = nn.functional.pad(s[:, None] * h, (0, 0, 0, adj.bsr.shape[1] - n))
                neigh = s[:, None] * bsr_spmm_ad(adj.bsr, hp,
                                                 compute_dtype=self.bsr_dtype)[:n]
            z = neigh + (adj.w_diag * self_alpha)[:, None] * h
            z = z / adj.deg.clamp(min=1.0)[:, None]
        elif isinstance(adj, CSRMatrix):
            if alpha_idx is None:
                alpha_idx = self.edge_alpha_index(adj.row_ids(), adj.indices, gene_id, n_genes)
            msgs = gather_src(adj, h) * _alpha_gather(adj, alpha, alpha_idx)[:, None] \
                * adj.data[:, None]
            z = aggregate(adj, msgs, op="mean")
        elif isinstance(adj, ShardedCSR):
            z = sharded_spmm(adj, h, weighted=True, op="mean",
                             edge_scale=_alpha_gather(adj, alpha, adj.edge_data["alpha_idx"]))
        else:
            raise TypeError(f"AdaptiveSAGE takes an AdaptiveBSR, a CSRMatrix or a ShardedCSR, "
                            f"got {type(adj)}")
        z = torch.relu(self.linear(self.dropout(z)))
        return z if self.norm is None else self.norm(z)


def _alpha_gather(adj, alpha: torch.Tensor, alpha_idx: torch.Tensor) -> torch.Tensor:
    """``alpha[alpha_idx]``, its gradient summed over each alpha's edges in a
    fixed order; the sort of the index is kept on ``adj``."""
    order = kept(adj, "alpha_order", (alpha_idx,),
                 lambda: index_order(alpha_idx, alpha.shape[0]))
    return gather(alpha, alpha_idx, order)


def _node_scales(adj: AdaptiveBSR, alpha: torch.Tensor) -> torch.Tensor:
    """``s[v] = alpha[gene_idx[v]]`` for a gene node and 1 for a cell. Only
    the gene nodes gather, so alpha's gradient is a fixed-order sum over
    their own nodes and the cells add nothing to it; the gene nodes and the
    sort of their indices are kept on ``adj``, built once per graph."""
    def build():
        nodes = torch.nonzero(adj.gene_idx >= 0).squeeze(1)
        genes = adj.gene_idx.index_select(0, nodes)
        return nodes, genes, index_order(genes, alpha.shape[0])

    nodes, genes, order = kept(adj, "gene_nodes", (adj.gene_idx,), build)
    s = torch.ones(adj.gene_idx.shape[0], dtype=alpha.dtype, device=alpha.device)
    return s.index_copy(0, nodes, gather(alpha, genes, order))


class GATConv(nn.Module):
    """Graph attention with an edge softmax (counterpart: gnn.py:166, parity
    with STAGATE's custom GATConv): ``feat = linear(h)`` per head,
    ``el/er = feat · attn_l/attn_r``, leaky-ReLU logits ``el[src] + er[dst]``.

    The BSR branch treats ``tile != 0`` as the edges and ignores the values;
    the CSR branch takes every stored entry as an edge and ignores its value
    too, as the JAX layer does. flax infers the input width; torch takes it."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int = 1,
                 negative_slope: float = 0.2, concat: bool = True):
        super().__init__()
        self.out_dim, self.num_heads = out_dim, num_heads
        self.negative_slope, self.concat = negative_slope, concat
        self.linear = nn.Linear(in_dim, num_heads * out_dim, bias=False)
        self.attn_l = nn.Parameter(torch.empty(1, num_heads, out_dim))
        self.attn_r = nn.Parameter(torch.empty(1, num_heads, out_dim))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's glorot-uniform init; for the (1, H, D) attention vectors flax
        takes fan-in H and fan-out D, where torch's xavier would take H * D."""
        nn.init.xavier_uniform_(self.linear.weight, generator=generator)
        bound = math.sqrt(6.0 / (self.num_heads + self.out_dim))
        for p in (self.attn_l, self.attn_r):
            nn.init.uniform_(p, -bound, bound, generator=generator)

    def forward(self, adj, h: torch.Tensor, return_attention: bool = False):
        H, D = self.num_heads, self.out_dim
        feat = self.linear(h).reshape(-1, H, D)
        el = (feat * self.attn_l).sum(-1)  # (n, H)
        er = (feat * self.attn_r).sum(-1)
        if isinstance(adj, BSRMatrix):
            if return_attention:
                raise ValueError("return_attention requires the CSR adjacency")
            n = h.shape[0]
            out = torch.stack([bsr_gat_ad(adj, er[:, k], el[:, k], feat[:, k, :],
                                          negative_slope=self.negative_slope)[:n]
                               for k in range(H)], dim=1)
            return out.reshape(-1, H * D) if self.concat else out.mean(1)
        if not isinstance(adj, CSRMatrix):
            raise TypeError(f"GATConv takes a BSRMatrix or a CSRMatrix, got {type(adj)}")
        logits = nn.functional.leaky_relu(gather_src(adj, el) + gather_dst(adj, er),
                                          self.negative_slope)
        att = edge_softmax(adj, logits)  # (nnz, H)
        msgs = gather_src(adj, feat) * att[:, :, None]
        out = aggregate(adj, msgs.reshape(-1, H * D), op="sum").reshape(-1, H, D)
        out = out.reshape(-1, H * D) if self.concat else out.mean(1)
        return (out, att) if return_attention else out


class TAGConv(nn.Module):
    """Topology-adaptive graph convolution ``W_0 h + Σ_{i=1..k} W_i (A^i h)``
    (counterpart: gnn.py:206, scTAG's TAG conv): ``W_0`` has a bias, the
    ``W_i`` do not, and each hop is one :func:`spmm`. ``linears`` holds
    ``W_0 .. W_k`` in the order flax names them (``Dense_0 .. Dense_k``).
    flax infers the input width; torch takes it."""

    def __init__(self, in_dim: int, out_dim: int, k: int = 2):
        super().__init__()
        self.k = k
        self.linears = nn.ModuleList(nn.Linear(in_dim, out_dim, bias=i == 0)
                                     for i in range(k + 1))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's ``Dense`` init for each of the k + 1 kernels."""
        for linear in self.linears:
            flax_dense_init_(linear, generator)

    def forward(self, adj, h: torch.Tensor) -> torch.Tensor:
        out = self.linears[0](h)
        hk = h
        for linear in self.linears[1:]:
            hk = spmm(adj, hk)
            out = out + linear(hk)
        return out


__all__ = ["AdaptiveSAGE", "GATConv", "GCNConv", "GRAPH_CONV_NORMS", "SAGEConv", "TAGConv",
           "WeightedGraphConv", "flax_dense_init_", "truncated_normal_"]
