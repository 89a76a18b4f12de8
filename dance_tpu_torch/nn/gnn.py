"""Graph layers: scDeepSort's AdaptiveSAGE and the GAT convolution
(counterparts: dance_tpu/nn/gnn.py:75-163, 166-203).

AdaptiveSAGE has two branches, as in the JAX package:

- an :class:`~dance_tpu_torch.ops.sparse.AdaptiveBSR` adjacency runs the
  whole edge gather as one block-sparse SpMM (:func:`bsr_spmm_ad`, the CUDA
  kernel on the card) plus per-node terms;
- a :class:`~dance_tpu_torch.ops.sparse.CSRMatrix` gathers per-edge messages
  and mean-aggregates them with ``index_add_``.

The sharded-CSR branch (gnn.py:134-140) and the dense off-diagonal
(``DenseAdj``) wait for later slices, as do bf16 streaming (``bsr_dtype``) and
``use_norm=False``, which no model sets. flax's ``LayerNorm`` eps is 1e-6, and
torch's default 1e-5 is overridden.

GATConv, too: a :class:`~dance_tpu_torch.ops.bsr.BSRMatrix` runs each head as
one fused GAT (:func:`bsr_gat_ad`, the CUDA kernels on the card), a
:class:`CSRMatrix` takes per-edge logits through :func:`edge_softmax`.
"""

import math
from typing import Optional

import torch
from torch import nn

from dance_tpu_torch.ops.bsr import BSRMatrix, bsr_gat_ad, bsr_spmm_ad
from dance_tpu_torch.ops.segment import aggregate, edge_softmax, gather_src
from dance_tpu_torch.ops.sparse import AdaptiveBSR, CSRMatrix


class AdaptiveSAGE(nn.Module):
    """Each edge's message is ``h_src * alpha[edge_type_index] * edge_weight``,
    mean-aggregated, then Dropout -> Linear -> ReLU -> LayerNorm.

    ``alpha`` (n_genes + 2,) is shared across layers and owned by the caller
    (the reference's per-gene beta plus gene/cell self-loop strengths)."""

    def __init__(self, in_dim: int, out_dim: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = nn.Dropout(dropout)
        self.linear = nn.Linear(in_dim, out_dim)
        self.norm = nn.LayerNorm(out_dim, eps=1e-6)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's init: xavier-uniform kernel, zero bias, unit LayerNorm."""
        nn.init.xavier_uniform_(self.linear.weight, generator=generator)
        nn.init.zeros_(self.linear.bias)
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
            # index_select: its backward is an index_add_, where advanced
            # indexing's backward walks the 12k duplicate cell indices serially
            s = torch.where(gidx >= 0, alpha.index_select(0, gidx.clamp(min=0)), 1.0)
            self_alpha = torch.where(gidx >= 0, alpha[n_genes], alpha[n_genes + 1])
            n = h.shape[0]
            hp = nn.functional.pad(s[:, None] * h, (0, 0, 0, adj.bsr.shape[1] - n))
            neigh = s[:, None] * bsr_spmm_ad(adj.bsr, hp)[:n]
            z = neigh + (adj.w_diag * self_alpha)[:, None] * h
            z = z / adj.deg.clamp(min=1.0)[:, None]
        elif isinstance(adj, CSRMatrix):
            if alpha_idx is None:
                alpha_idx = self.edge_alpha_index(adj.row_ids(), adj.indices, gene_id, n_genes)
            msgs = gather_src(adj, h) * alpha.index_select(0, alpha_idx)[:, None] \
                * adj.data[:, None]
            z = aggregate(adj, msgs, op="mean")
        else:
            raise TypeError(f"AdaptiveSAGE takes an AdaptiveBSR or a CSRMatrix, got {type(adj)}")
        return self.norm(torch.relu(self.linear(self.dropout(z))))


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
        rows = adj.row_ids()
        logits = nn.functional.leaky_relu(el.index_select(0, adj.indices)
                                          + er.index_select(0, rows), self.negative_slope)
        att = edge_softmax(adj, logits)  # (nnz, H)
        msgs = feat.index_select(0, adj.indices) * att[:, :, None]
        out = aggregate(adj, msgs.reshape(-1, H * D), op="sum").reshape(-1, H, D)
        out = out.reshape(-1, H * D) if self.concat else out.mean(1)
        return (out, att) if return_attention else out


__all__ = ["AdaptiveSAGE", "GATConv"]
