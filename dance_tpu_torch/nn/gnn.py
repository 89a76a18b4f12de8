"""scDeepSort's AdaptiveSAGE layer (counterpart: dance_tpu/nn/gnn.py:75-163).

Two branches, as in the JAX package:

- an :class:`~dance_tpu_torch.ops.sparse.AdaptiveBSR` adjacency runs the
  whole edge gather as one block-sparse SpMM (:func:`bsr_spmm_ad`, the CUDA
  kernel on the card) plus per-node terms;
- a :class:`~dance_tpu_torch.ops.sparse.CSRMatrix` gathers per-edge messages
  and mean-aggregates them with ``index_add_``.

The sharded-CSR branch (gnn.py:134-140) and the dense off-diagonal
(``DenseAdj``) wait for later slices, as do bf16 streaming (``bsr_dtype``) and
``use_norm=False``, which no model sets. flax's ``LayerNorm`` eps is 1e-6, and
torch's default 1e-5 is overridden.
"""

from typing import Optional

import torch
from torch import nn

from dance_tpu_torch.ops.bsr import bsr_spmm_ad
from dance_tpu_torch.ops.segment import aggregate, gather_src
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


__all__ = ["AdaptiveSAGE"]
