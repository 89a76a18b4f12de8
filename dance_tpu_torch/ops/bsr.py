"""Block-sparse (BSR) matrices and the two CUDA kernels over them.

Counterpart: the host side and the SpMM/SDDMM kernels of
dance_tpu/ops/pallas_kernels.py:26-285 — ``BSRMatrix`` (:29), ``bsr_from_scipy``
(:53), ``bsr_spmm`` (:101), ``bsr_sddmm`` (:159), ``bsr_transpose`` (:207),
``bsr_spmm_ad`` (:219-270) and ``unpermute`` (:775).

A BSR matrix here is the same list of dense 128 x 128 tiles sorted by
block-row, plus a tile-row pointer ``rowptr`` (tiles of block-row ``r`` are
``rowptr[r]:rowptr[r + 1]``), which the CUDA SpMM walks per block-row.

Each kernel has a wrapper and a plain PyTorch version of the same math
(a gather, ``bmm`` and ``index_add_``). The wrapper takes the plain version
only for tensors on the CPU; for CUDA tensors it launches the kernel
(``csrc/bsr_spmm.cu``, ``csrc/bsr_sddmm.cu``) or raises. Each wrapper counts
its launches in a plain int attribute, ``bsr_spmm.launches`` and
``bsr_sddmm.launches``.

Not in this slice (ROADMAP Queue 1/2): ``compute_dtype`` bf16 streaming,
``tile_expansion``, ``rcm_reorder``/``bsr_with_rcm``, ``bipartite_bsr`` and
the GAT and max kernels.
"""

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

BLOCK = 128


@dataclass
class BSRMatrix:
    """Dense nonzero tiles sorted by block-row (counterpart: pallas_kernels.py:29).

    ``shape`` is the padded (n_rows, n_cols), multiples of the tile edge. The
    tiles are treated as constants unless they require grad: the transposed
    tiling is then computed once and kept (:func:`bsr_transpose`)."""

    tiles: torch.Tensor       # (nb, block, block) f32
    block_rows: torch.Tensor  # (nb,) int32, sorted
    block_cols: torch.Tensor  # (nb,) int32
    rowptr: torch.Tensor      # (n_rows // block + 1,) int32
    shape: Tuple[int, int]
    _transpose: Optional["BSRMatrix"] = field(default=None, repr=False, compare=False)

    @property
    def nb(self) -> int:
        return self.tiles.shape[0]

    @property
    def block(self) -> int:
        return self.tiles.shape[1]

    def to(self, device) -> "BSRMatrix":
        return BSRMatrix(self.tiles.to(device), self.block_rows.to(device),
                         self.block_cols.to(device), self.rowptr.to(device), self.shape)


def _rowptr(block_rows: torch.Tensor, n_brows: int) -> torch.Tensor:
    counts = torch.bincount(block_rows.long(), minlength=n_brows)
    rowptr = torch.zeros(n_brows + 1, dtype=torch.int32, device=block_rows.device)
    rowptr[1:] = torch.cumsum(counts, 0)
    return rowptr


def bsr_from_scipy(adj: sp.spmatrix, block: int = BLOCK) -> BSRMatrix:
    """Host-side tiling of a scipy sparse matrix into sorted dense tiles, in the
    same tiles and order as the JAX package (pallas_kernels.py:53-88).

    That includes the zero tiles it adds to cover every block-row and
    block-column, which its TPU kernel needs; the CUDA kernel does not."""
    adj = sp.csr_matrix(adj)
    n, m = adj.shape
    np_, mp = -(-n // block) * block, -(-m // block) * block
    if (np_, mp) != (n, m):
        adj = sp.csr_matrix((adj.data, adj.indices, adj.indptr), shape=(n, m))
        adj.resize((np_, mp))
    bsr = adj.tobsr(blocksize=(block, block))
    bsr.sort_indices()
    block_rows = np.repeat(np.arange(len(bsr.indptr) - 1), np.diff(bsr.indptr))
    block_cols = np.asarray(bsr.indices)
    tiles = np.asarray(bsr.data, dtype=np.float32)
    miss_r = np.setdiff1d(np.arange(np_ // block), block_rows)
    miss_c = np.setdiff1d(np.arange(mp // block), block_cols)
    n_extra = max(len(miss_r), len(miss_c))
    if n_extra:
        # pair missing rows with missing cols where possible; 0 otherwise
        er = np.concatenate([miss_r, np.zeros(n_extra - len(miss_r), np.int64)])
        ec = np.concatenate([miss_c, np.zeros(n_extra - len(miss_c), np.int64)])
        block_rows = np.concatenate([block_rows, er])
        block_cols = np.concatenate([block_cols, ec])
        tiles = np.concatenate([tiles, np.zeros((n_extra, block, block), np.float32)])
        order = np.argsort(block_rows, kind="stable")
        block_rows, block_cols, tiles = block_rows[order], block_cols[order], tiles[order]
    rowptr = np.searchsorted(block_rows, np.arange(np_ // block + 1), side="left")
    return BSRMatrix(torch.from_numpy(np.ascontiguousarray(tiles)),
                     torch.from_numpy(block_rows.astype(np.int32)),
                     torch.from_numpy(block_cols.astype(np.int32)),
                     torch.from_numpy(rowptr.astype(np.int32)), (np_, mp))


def bsr_transpose(bsr: BSRMatrix) -> BSRMatrix:
    """Aᵀ in BSR form: transpose each tile, swap block row/col, re-sort by row
    (counterpart: pallas_kernels.py:207).

    The JAX package re-derives it in every backward; here it is computed once
    per matrix and kept on it, unless the tiles require grad."""
    if bsr._transpose is not None:
        return bsr._transpose
    order = torch.argsort(bsr.block_cols, stable=True)
    brows_t = bsr.block_cols[order]
    at = BSRMatrix(bsr.tiles.detach()[order].transpose(1, 2).contiguous(), brows_t,
                   bsr.block_rows[order], _rowptr(brows_t, bsr.shape[1] // bsr.block),
                   (bsr.shape[1], bsr.shape[0]))
    if not bsr.tiles.requires_grad:
        bsr._transpose = at
    return at


def unpermute(perm, arr: np.ndarray) -> np.ndarray:
    """Undo a node permutation on per-node output rows, ``out[perm] = arr``
    (counterpart: pallas_kernels.py:775). No-op when ``perm`` is None."""
    if perm is None:
        return arr
    out = np.empty_like(arr)
    out[np.asarray(perm)] = arr
    return out


# --------------------------------------------------------------------------
# Plain PyTorch versions: the CPU path and the oracle for the CUDA kernels
# --------------------------------------------------------------------------


def bsr_spmm_reference(bsr: BSRMatrix, b: torch.Tensor) -> torch.Tensor:
    """``A @ B`` as a tile gather, ``bmm`` and ``index_add_`` over block-rows."""
    n_rows, n_cols = bsr.shape
    blk, d = bsr.block, b.shape[1]
    b3 = b.reshape(n_cols // blk, blk, d)
    prod = torch.bmm(bsr.tiles, b3[bsr.block_cols.long()])
    out = torch.zeros((n_rows // blk, blk, d), dtype=prod.dtype, device=prod.device)
    return out.index_add_(0, bsr.block_rows.long(), prod).reshape(n_rows, d)


def bsr_sddmm_reference(block_rows: torch.Tensor, block_cols: torch.Tensor,
                        g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``out[k] = g[rows of tile k] @ b[cols of tile k]ᵀ`` as two gathers and a ``bmm``."""
    d = g.shape[1]
    g3 = g.reshape(-1, BLOCK, d)
    b3 = b.reshape(-1, BLOCK, d)
    return torch.bmm(g3[block_rows.long()], b3[block_cols.long()].transpose(1, 2))


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on the CPU; raise on a mix or on a device
    that is neither CPU nor CUDA."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"BSR kernels need all tensors on one CUDA device or all on "
                     f"the CPU; got {sorted(str(t.device) for t in tensors)}")


def _check_cuda_args(name: str, floats, ints):
    for t in floats:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 tensors only, got {t.dtype}")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: int32 index tensors only, got {t.dtype}")
    for t in (*floats, *ints):
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _launch(fn_name: str, device: torch.device, *args):
    from dance_tpu_torch.ops._build import load_kernels

    fn = getattr(load_kernels().lib, fn_name)
    # the library links its own CUDA runtime: it is told the device, and
    # launches on PyTorch's current stream of that device
    err = fn(*args, device.index, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with cudaError {err}")


def bsr_spmm(bsr: BSRMatrix, b: torch.Tensor) -> torch.Tensor:
    """``out = A @ B`` with A in BSR form and B (n_cols_padded, d) float32;
    returns (n_rows_padded, d) float32 (counterpart: pallas_kernels.py:101).

    Any ``d`` is taken; the kernel masks the ragged feature tile itself."""
    n_rows, n_cols = bsr.shape
    if b.dim() != 2 or b.shape[0] != n_cols:
        raise ValueError(f"bsr_spmm: b must be ({n_cols}, d), got {tuple(b.shape)}")
    if _on_cpu(bsr.tiles, bsr.block_cols, bsr.rowptr, b):
        return bsr_spmm_reference(bsr, b)
    if bsr.block != BLOCK or bsr.tiles.shape[2] != BLOCK:
        raise ValueError(f"bsr_spmm: the CUDA kernel takes {BLOCK}x{BLOCK} tiles")
    if bsr.rowptr.shape[0] != n_rows // BLOCK + 1 or bsr.block_cols.shape[0] != bsr.nb:
        raise ValueError("bsr_spmm: rowptr or block_cols do not match the tiles and shape")
    _check_cuda_args("bsr_spmm", (bsr.tiles, b), (bsr.block_cols, bsr.rowptr))
    if bsr.tiles.data_ptr() % 16:
        raise ValueError("bsr_spmm: tiles must be 16-byte aligned")
    d = b.shape[1]
    out = torch.empty((n_rows, d), dtype=torch.float32, device=b.device)
    if n_rows == 0 or d == 0:
        return out
    _launch("dtt_bsr_spmm_f32", b.device, bsr.tiles.data_ptr(), bsr.block_cols.data_ptr(),
            bsr.rowptr.data_ptr(), b.data_ptr(), out.data_ptr(), n_rows // BLOCK, d)
    bsr_spmm.launches += 1
    return out


bsr_spmm.launches = 0


def bsr_sddmm(block_rows: torch.Tensor, block_cols: torch.Tensor, g: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """``out[k] = g[rows_k] @ b[cols_k]ᵀ`` for each nonzero tile k: the dA term
    of the SpMM backward (counterpart: pallas_kernels.py:159). ``g`` is
    (n_rows_padded, d), ``b`` (n_cols_padded, d); returns (nb, 128, 128)."""
    if g.dim() != 2 or b.dim() != 2 or g.shape[1] != b.shape[1] \
            or g.shape[0] % BLOCK or b.shape[0] % BLOCK:
        raise ValueError(f"bsr_sddmm: g and b must be (n_padded, d) with the same d, "
                         f"got {tuple(g.shape)} and {tuple(b.shape)}")
    if block_rows.shape != block_cols.shape or block_rows.dim() != 1:
        raise ValueError("bsr_sddmm: block_rows and block_cols must be (nb,)")
    if _on_cpu(block_rows, block_cols, g, b):
        return bsr_sddmm_reference(block_rows, block_cols, g, b)
    _check_cuda_args("bsr_sddmm", (g, b), (block_rows, block_cols))
    nb = block_rows.shape[0]
    out = torch.empty((nb, BLOCK, BLOCK), dtype=torch.float32, device=g.device)
    if nb == 0:
        return out
    _launch("dtt_bsr_sddmm_f32", g.device, g.data_ptr(), b.data_ptr(),
            block_rows.data_ptr(), block_cols.data_ptr(), out.data_ptr(), nb, g.shape[1])
    bsr_sddmm.launches += 1
    return out


bsr_sddmm.launches = 0


class BSRSpMM(torch.autograd.Function):
    """Differentiable ``A @ B`` on the BSR kernels (counterpart:
    ``_bsr_spmm_core`` with ``_bsr_spmm_fwd``/``_bsr_spmm_bwd``,
    pallas_kernels.py:234-270).

    Backward: ``dB = Aᵀ ḡ`` with the SpMM kernel on the transposed tiling, and
    ``dA[k] = ḡ[row_k] B[col_k]ᵀ`` with the SDDMM kernel, only when the tiles
    require grad (AdaptiveBSR's tiles are constants)."""

    @staticmethod
    def forward(ctx, tiles, b, bsr):
        # ``tiles`` is ``bsr.tiles``, passed on its own so that autograd tracks it
        ctx.mat = bsr
        ctx.save_for_backward(b if tiles.requires_grad else None)
        return bsr_spmm(bsr, b)

    @staticmethod
    def backward(ctx, grad):
        (b,) = ctx.saved_tensors
        grad = grad.contiguous()
        mat = ctx.mat
        d_tiles = d_b = None
        if ctx.needs_input_grad[0]:
            d_tiles = bsr_sddmm(mat.block_rows, mat.block_cols, grad, b)
        if ctx.needs_input_grad[1]:
            d_b = bsr_spmm(bsr_transpose(mat), grad)
        return d_tiles, d_b, None


def bsr_spmm_ad(bsr: BSRMatrix, b: torch.Tensor) -> torch.Tensor:
    """Differentiable ``A @ B`` (counterpart: pallas_kernels.py:219). Gradients
    reach ``b`` and, where ``bsr.tiles`` requires grad, the tiles."""
    return BSRSpMM.apply(bsr.tiles, b, bsr)


__all__ = ["BLOCK", "BSRMatrix", "BSRSpMM", "bsr_from_scipy", "bsr_sddmm",
           "bsr_sddmm_reference", "bsr_spmm", "bsr_spmm_ad", "bsr_spmm_reference",
           "bsr_transpose", "unpermute"]
