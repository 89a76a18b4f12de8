"""Sparse tensor containers, the CSR conversions, products and scalings
(counterpart: dance_tpu/ops/sparse.py:18-210; ``csr_from_dense``,
``csr_to_scipy``, ``csr_to_dense``, ``csr_matvec``, ``csr_row_sums``,
``csr_col_sums``, ``csr_scale_rows`` and ``csr_scale_cols`` :62-120).

The JAX package registers these as pytrees so that ``jit`` sees static
shapes; here they are plain dataclasses of tensors with a ``.to(device)``.

Every sum over a CSR's entries runs in a fixed order, so that two runs on
the card give the same bits (``jax.ops.segment_sum`` does on the TPU): the
row sums over ``indptr``'s segments (:func:`~dance_tpu_torch.ops.segment.
segment_sum_csr`), the column sums over the same segments of ``Aᵀ``, whose
entry order (:meth:`CSRMatrix.col_order`) is built once per matrix and
kept on it until ``indices`` is replaced or edited in place, as the
transposed tiling is kept on a ``BSRMatrix``. ``index_add_`` adds with
atomics in any order on the card, and the port uses it on no CSR.
"""

from dataclasses import dataclass, field, replace
from typing import Callable, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from dance_tpu_torch.ops.bsr import BSRMatrix


def kept(owner, key: str, tensors, build: Callable):
    """``build()``, kept on ``owner`` under ``key`` until one of ``tensors``
    is replaced or edited in place (its version counter moves)."""
    cache = owner.__dict__.setdefault("_kept", {})
    hit = cache.get(key)
    if hit is not None and len(hit[0]) == len(tensors) and all(
            t0 is t and v == t._version for (t0, v), t in zip(hit[0], tensors)):
        return hit[1]
    value = build()
    cache[key] = (tuple((t, t._version) for t in tensors), value)
    return value


def index_order(index: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(perm, offsets)``: the stable permutation that sorts ``index`` (values
    in ``[0, n)``) and the start of each value's run in that order, so that
    ``offsets[i]:offsets[i + 1]`` of ``index[perm]`` are the entries equal
    to ``i``, in their first order."""
    perm = torch.sort(index, stable=True).indices
    bounds = torch.arange(n + 1, device=index.device, dtype=index.dtype)
    return perm, torch.searchsorted(index.index_select(0, perm), bounds)


@dataclass
class CSRMatrix:
    """CSR sparse matrix as tensors (counterpart: sparse.py:18-59)."""

    data: torch.Tensor     # (nnz,) f32
    indices: torch.Tensor  # (nnz,) int64 column index per entry
    indptr: torch.Tensor   # (n_rows + 1,) int64
    shape: Tuple[int, int]
    # the row ids and Aᵀ's entry order, stamped with what they were built from
    _kept: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    def row_ids(self) -> torch.Tensor:
        """Per-entry row id (counterpart: ``CSRMatrix.row_ids``, sparse.py:49),
        kept until ``indptr`` changes."""
        def build():
            counts = self.indptr[1:] - self.indptr[:-1]
            return torch.repeat_interleave(torch.arange(self.shape[0], device=self.indptr.device),
                                           counts, output_size=self.indices.shape[0])
        return kept(self, "rows", (self.indptr,), build)

    def col_order(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(perm, col_ptr)``: the entries of ``Aᵀ`` in CSR order (by column,
        then by row) and its row pointer (:func:`index_order` of
        ``indices``), kept until ``indices`` changes."""
        return kept(self, "cols", (self.indices,),
                    lambda: index_order(self.indices, self.shape[1]))

    def with_data(self, data: torch.Tensor) -> "CSRMatrix":
        """The same pattern with other values, sharing the kept orders."""
        out = replace(self, data=data)
        out._kept = self._kept
        return out

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
    """The dense matrix where ``mat`` lies, duplicate entries summed in their
    stored order (counterpart: sparse.py:77); ``perm`` and ``keys`` are
    distinct, so no entry is written twice."""
    from dance_tpu_torch.ops.segment import segment_sum_csr
    flat = mat.row_ids() * mat.shape[1] + mat.indices
    perm = torch.sort(flat, stable=True).indices
    keys, counts = torch.unique_consecutive(flat.index_select(0, perm), return_counts=True)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    sums = segment_sum_csr(mat.data.index_select(0, perm), offsets)
    out = mat.data.new_zeros(mat.shape[0] * mat.shape[1])
    return out.index_put((keys,), sums).reshape(mat.shape)


def csr_matvec(mat: CSRMatrix, v: torch.Tensor) -> torch.Tensor:
    """``A @ v`` by a gather and a segment sum (counterpart: sparse.py:83)."""
    from dance_tpu_torch.ops.segment import csr_spmm
    return csr_spmm(mat, v[:, None], mat.data)[:, 0]


def csr_row_sums(mat: CSRMatrix) -> torch.Tensor:
    """Counterpart: sparse.py:108."""
    from dance_tpu_torch.ops.segment import segment_sum_csr
    return segment_sum_csr(mat.data, mat.indptr)


def csr_col_sums(mat: CSRMatrix) -> torch.Tensor:
    """Counterpart: sparse.py:112; each column summed in row order (``perm``
    is a permutation: the gather's backward writes each entry once)."""
    from dance_tpu_torch.ops.segment import segment_sum_csr
    perm, col_ptr = mat.col_order()
    return segment_sum_csr(mat.data.index_select(0, perm), col_ptr)


def csr_scale_rows(mat: CSRMatrix, scale: torch.Tensor) -> CSRMatrix:
    """Row ``i`` times ``scale[i]``, without densifying (counterpart:
    sparse.py:116)."""
    from dance_tpu_torch.ops.segment import gather_dst
    return mat.with_data(mat.data * gather_dst(mat, scale))


def csr_scale_cols(mat: CSRMatrix, scale: torch.Tensor) -> CSRMatrix:
    """Column ``j`` times ``scale[j]`` (counterpart: sparse.py:121)."""
    from dance_tpu_torch.ops.segment import gather_src
    return mat.with_data(mat.data * gather_src(mat, scale))


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
    # the gene nodes and the sort of their gene indices, stamped as on a CSRMatrix
    _kept: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.w_diag.shape[0], self.w_diag.shape[0])

    def to(self, device) -> "AdaptiveBSR":
        return replace(self, bsr=self.bsr.to(device), w_diag=self.w_diag.to(device),
                       gene_idx=self.gene_idx.to(device), deg=self.deg.to(device))


__all__ = ["AdaptiveBSR", "CSRMatrix", "DenseAdj", "csr_col_sums", "csr_from_dense",
           "csr_from_scipy", "csr_matmat", "csr_matvec", "csr_rmatmat", "csr_row_sums",
           "csr_scale_cols", "csr_scale_rows", "csr_to_dense", "csr_to_scipy",
           "dense_adj_from_scipy", "index_order", "kept", "sym_norm_adjacency"]
