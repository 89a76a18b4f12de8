"""Sparse tensor containers, the CSR conversions, products and scalings
(counterpart: dance_tpu/ops/sparse.py:18-210; ``csr_from_dense``,
``csr_to_scipy``, ``csr_to_dense``, ``csr_matvec``, ``csr_row_sums``,
``csr_col_sums``, ``csr_scale_rows`` and ``csr_scale_cols`` :62-120).

The JAX package registers these as pytrees so that ``jit`` sees static
shapes; here they are plain dataclasses of tensors with a ``.to(device)``.
"""

from dataclasses import dataclass, replace
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from dance_tpu_torch.ops.bsr import BSRMatrix


@dataclass
class CSRMatrix:
    """CSR sparse matrix as tensors (counterpart: sparse.py:18-59)."""

    data: torch.Tensor     # (nnz,) f32
    indices: torch.Tensor  # (nnz,) int64 column index per entry
    indptr: torch.Tensor   # (n_rows + 1,) int64
    shape: Tuple[int, int]

    def row_ids(self) -> torch.Tensor:
        """Per-entry row id (counterpart: ``CSRMatrix.row_ids``, sparse.py:49)."""
        counts = self.indptr[1:] - self.indptr[:-1]
        return torch.repeat_interleave(
            torch.arange(self.shape[0], device=self.indptr.device), counts)

    def to(self, device) -> "CSRMatrix":
        return replace(self, data=self.data.to(device), indices=self.indices.to(device),
                       indptr=self.indptr.to(device))


def csr_from_scipy(mat: sp.spmatrix) -> CSRMatrix:
    """Counterpart: ``csr_from_scipy`` (sparse.py:62). Indices are int64,
    torch's index type."""
    mat = sp.csr_matrix(mat)
    return CSRMatrix(torch.from_numpy(np.asarray(mat.data, np.float32)),
                     torch.from_numpy(np.asarray(mat.indices, np.int64)),
                     torch.from_numpy(np.asarray(mat.indptr, np.int64)), mat.shape)


def csr_from_dense(x) -> CSRMatrix:
    """The nonzero entries of a dense matrix as a CSR matrix on the CPU
    (counterpart: sparse.py:68)."""
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return csr_from_scipy(sp.csr_matrix(x))


def csr_to_scipy(mat: CSRMatrix) -> sp.csr_matrix:
    """Counterpart: sparse.py:72."""
    return sp.csr_matrix((mat.data.cpu().numpy(), mat.indices.cpu().numpy(),
                          mat.indptr.cpu().numpy()), shape=mat.shape)


def csr_to_dense(mat: CSRMatrix) -> torch.Tensor:
    """The dense matrix where ``mat`` lies, duplicate entries summed
    (counterpart: sparse.py:77)."""
    out = mat.data.new_zeros(mat.shape)
    return out.index_put_((mat.row_ids(), mat.indices), mat.data, accumulate=True)


def csr_matvec(mat: CSRMatrix, v: torch.Tensor) -> torch.Tensor:
    """``A @ v`` by a gather and a segment sum (counterpart: sparse.py:83)."""
    prod = mat.data * v.index_select(0, mat.indices)
    return prod.new_zeros(mat.shape[0]).index_add_(0, mat.row_ids(), prod)


def csr_row_sums(mat: CSRMatrix) -> torch.Tensor:
    """Counterpart: sparse.py:108."""
    return mat.data.new_zeros(mat.shape[0]).index_add_(0, mat.row_ids(), mat.data)


def csr_col_sums(mat: CSRMatrix) -> torch.Tensor:
    """Counterpart: sparse.py:112."""
    return mat.data.new_zeros(mat.shape[1]).index_add_(0, mat.indices, mat.data)


def csr_scale_rows(mat: CSRMatrix, scale: torch.Tensor) -> CSRMatrix:
    """Row ``i`` times ``scale[i]``, without densifying (counterpart:
    sparse.py:116)."""
    return replace(mat, data=mat.data * scale.index_select(0, mat.row_ids()))


def csr_scale_cols(mat: CSRMatrix, scale: torch.Tensor) -> CSRMatrix:
    """Column ``j`` times ``scale[j]`` (counterpart: sparse.py:121)."""
    return replace(mat, data=mat.data * scale.index_select(0, mat.indices))


def csr_matmat(mat: CSRMatrix, b: torch.Tensor) -> torch.Tensor:
    """``A @ B`` for a dense ``B`` of shape (n_cols, d) (counterpart:
    sparse.py:92, a gather and a segment sum in XLA, outside Pallas): one
    sparse-dense product where ``mat`` lies, which materialises no (nnz, d)
    gather. CSR's row-major order is a coalesced COO."""
    coo = torch.sparse_coo_tensor(torch.stack([mat.row_ids(), mat.indices]), mat.data,
                                  size=mat.shape, is_coalesced=True, check_invariants=False)
    return torch.sparse.mm(coo, b)


def csr_rmatmat(mat: CSRMatrix, b: torch.Tensor) -> torch.Tensor:
    """``Aᵀ @ B`` for a dense ``B`` of shape (n_rows, d) (counterpart:
    sparse.py:100, a scatter-add over the columns): the entries sorted by
    column where ``mat`` lies, then one sparse-dense product."""
    coo = torch.sparse_coo_tensor(torch.stack([mat.indices, mat.row_ids()]), mat.data,
                                  size=(mat.shape[1], mat.shape[0]), check_invariants=False)
    return torch.sparse.mm(coo.coalesce(), b)


def sym_norm_adjacency(adj) -> Tuple[sp.csr_matrix, sp.csr_matrix]:
    """The graph with self-loops and its symmetric normalisation ``D^-1/2 (A
    + I) D^-1/2`` (counterpart: sctag.py:115-119, scdsc.py:240-244), in the
    JAX package's scipy arithmetic. Returns ``(A + I, normalised)``."""
    adj = sp.csr_matrix(adj)
    adj = adj + sp.eye(adj.shape[0], format="csr", dtype=np.float32)
    deg = np.asarray(adj.sum(1)).ravel()
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    return adj, sp.diags(dinv) @ adj @ sp.diags(dinv)


@dataclass
class DenseAdj:
    """A dense adjacency, its SpMM one matrix product (counterpart:
    sparse.py:124-159). ``degrees`` holds the nonzero count of each row, for
    mean aggregation."""

    mat: torch.Tensor      # (n, m) f32 weights, 0 = no edge
    degrees: torch.Tensor  # (n,) f32

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.mat.shape)

    def to(self, device) -> "DenseAdj":
        return replace(self, mat=self.mat.to(device), degrees=self.degrees.to(device))


def dense_adj_from_scipy(adj: sp.spmatrix) -> DenseAdj:
    """Counterpart: ``dense_adj_from_scipy`` (sparse.py:162)."""
    adj = sp.csr_matrix(adj)
    return DenseAdj(torch.from_numpy(np.asarray(adj.todense(), np.float32)),
                    torch.from_numpy(np.diff(adj.indptr).astype(np.float32)))


@dataclass
class AdaptiveBSR:
    """AdaptiveSAGE's message passing as one SpMM over a constant off-diagonal
    BSR matrix plus per-node terms (counterpart: sparse.py:177-210).

    With node scale ``s[v] = alpha[gene_idx[v]]`` for genes and 1 for cells,
    ``sum_e w_e * alpha_e * h_src == s * (A_off @ (s * h)) + w_diag * alpha_self * h``.
    ``bsr`` holds ``A_off`` as BSR tiles, or as a :class:`DenseAdj` (the JAX
    class keeps either in the same field).
    """

    bsr: "BSRMatrix | DenseAdj"  # the off-diagonal: BSR tiles or one dense matrix
    w_diag: torch.Tensor    # (n,) self-loop weight per node (0 if absent)
    gene_idx: torch.Tensor  # (n,) int64 gene index per node, -1 for cells
    deg: torch.Tensor       # (n,) incoming edge counts incl. self-loops
    n_genes: int

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.w_diag.shape[0], self.w_diag.shape[0])

    def to(self, device) -> "AdaptiveBSR":
        return replace(self, bsr=self.bsr.to(device), w_diag=self.w_diag.to(device),
                       gene_idx=self.gene_idx.to(device), deg=self.deg.to(device))


__all__ = ["AdaptiveBSR", "CSRMatrix", "DenseAdj", "csr_col_sums", "csr_from_dense",
           "csr_from_scipy", "csr_matmat", "csr_matvec", "csr_rmatmat", "csr_row_sums",
           "csr_scale_cols", "csr_scale_rows", "csr_to_dense", "csr_to_scipy",
           "dense_adj_from_scipy", "sym_norm_adjacency"]
