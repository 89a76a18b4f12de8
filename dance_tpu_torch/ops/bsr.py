"""Block-sparse (BSR) matrices and the CUDA kernels over them.

Counterpart: the host side and the kernels of
dance_tpu/ops/pallas_kernels.py — ``BSRMatrix`` (:29), ``bsr_from_scipy``
(:53), ``bsr_spmm`` (:101), ``bsr_sddmm`` (:159), ``bsr_transpose`` (:207),
``bsr_spmm_ad`` (:219-270), the fused GAT ``bsr_gat`` (:354),
``bsr_gat_stats`` (:426), ``bsr_gat_grads`` (:507) and ``bsr_gat_ad``
(:615-650), ``rcm_reorder``/``bsr_with_rcm`` (:653-674) and ``unpermute``
(:775).

A BSR matrix here is the same list of dense 128 x 128 tiles sorted by
block-row, plus a tile-row pointer ``rowptr`` (tiles of block-row ``r`` are
``rowptr[r]:rowptr[r + 1]``), which the CUDA kernels walk per block-row. The
GAT backward also walks the tiles by block-column, through a column order
computed once per matrix (:func:`bsr_col_order`).

Each kernel has a wrapper and a plain PyTorch version of the same math
(gathers, ``bmm``, ``scatter_reduce`` and ``index_add_``). The wrapper takes
the plain version only for tensors on the CPU; for CUDA tensors it launches
the kernel (``csrc/bsr_spmm.cu``, ``csrc/bsr_sddmm.cu``, ``csrc/bsr_gat.cu``,
``csrc/bsr_gat_bwd.cu``) or raises. Each wrapper counts its launches in a
plain int attribute, e.g. ``bsr_spmm.launches``.

Not ported yet (ROADMAP Queue 1/2): ``compute_dtype`` bf16 streaming,
``tile_expansion``, ``bipartite_bsr``, the pure-XLA ``bsr_gat_scan`` (the
GAT plain versions take its place as the oracle) and the max kernel.
"""

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

BLOCK = 128
# attention-logit activations of the GAT kernels, by the code the C side takes
GAT_ACTS = {"leaky_relu": 0, "sigmoid": 1}


@dataclass
class BSRMatrix:
    """Dense nonzero tiles sorted by block-row (counterpart: pallas_kernels.py:29).

    ``shape`` is the padded (n_rows, n_cols), multiples of the tile edge. The
    tiles are treated as constants unless they require grad: the transposed
    tiling is then computed once and kept (:func:`bsr_transpose`), as is the
    column order of the tiles (:func:`bsr_col_order`)."""

    tiles: torch.Tensor       # (nb, block, block) f32
    block_rows: torch.Tensor  # (nb,) int32, sorted
    block_cols: torch.Tensor  # (nb,) int32
    rowptr: torch.Tensor      # (n_rows // block + 1,) int32
    shape: Tuple[int, int]
    _transpose: Optional["BSRMatrix"] = field(default=None, repr=False, compare=False)
    _col_order: Optional[Tuple[torch.Tensor, torch.Tensor]] = field(
        default=None, repr=False, compare=False)

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


def bsr_col_order(bsr: BSRMatrix) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(colptr, col_perm)``, both int32: the tiles of block-column ``c`` are
    ``col_perm[colptr[c]:colptr[c + 1]]``, in row order. The GAT backward sums
    by column through it in a fixed order, where the TPU kernel relied on its
    grid order (pallas_kernels.py:530-535). Computed once per matrix and kept."""
    if bsr._col_order is None:
        perm = torch.argsort(bsr.block_cols, stable=True)
        colptr = _rowptr(bsr.block_cols[perm], bsr.shape[1] // bsr.block)
        bsr._col_order = (colptr, perm.to(torch.int32))
    return bsr._col_order


def rcm_reorder(adj: sp.spmatrix):
    """Reverse-Cuthill-McKee permutation that bands a graph into fewer tiles;
    returns ``(perm, adj[perm][:, perm])`` (counterpart: pallas_kernels.py:653).
    Apply ``perm`` to node features and undo it on outputs (:func:`unpermute`)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    adj = sp.csr_matrix(adj)
    perm = reverse_cuthill_mckee(adj, symmetric_mode=True)
    return perm, adj[perm][:, perm]


def bsr_with_rcm(adj: sp.spmatrix, block: int = BLOCK):
    """RCM-reorder a square adjacency and tile it: ``(perm, bsr)`` with ``bsr``
    covering ``adj[perm][:, perm]`` (counterpart: pallas_kernels.py:666)."""
    perm, adj_p = rcm_reorder(adj)
    return np.asarray(perm), bsr_from_scipy(adj_p, block=block)


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


def _att_activation(raw: torch.Tensor, negative_slope: float, act: str) -> torch.Tensor:
    """Attention-logit nonlinearity (counterpart: pallas_kernels.py:310):
    leaky-ReLU (standard GAT) or sigmoid (STAGATE)."""
    if act == "sigmoid":
        return 1.0 / (1.0 + torch.exp(-raw))
    return torch.where(raw >= 0, raw, negative_slope * raw)


def _att_activation_grad(raw: torch.Tensor, negative_slope: float, act: str) -> torch.Tensor:
    """Derivative of :func:`_att_activation` (counterpart: pallas_kernels.py:318)."""
    if act == "sigmoid":
        s = 1.0 / (1.0 + torch.exp(-raw))
        return s * (1.0 - s)
    return torch.where(raw >= 0, 1.0, negative_slope)


def _gat_inputs(name: str, bsr: BSRMatrix, er: torch.Tensor, el: torch.Tensor,
                h: torch.Tensor, act: str):
    """Check the GAT inputs and zero-pad them to the tiling, as the JAX
    wrappers do: er to n_rows, el and h to n_cols (pallas_kernels.py:364-367)."""
    if act not in GAT_ACTS:
        raise ValueError(f"{name}: act must be one of {sorted(GAT_ACTS)}, got {act!r}")
    n_rows, n_cols = bsr.shape
    if er.dim() != 1 or el.dim() != 1 or h.dim() != 2 or h.shape[1] == 0 \
            or er.shape[0] > n_rows or el.shape[0] > n_cols or h.shape[0] > n_cols:
        raise ValueError(f"{name}: need er (<= {n_rows},), el (<= {n_cols},) and h "
                         f"(<= {n_cols}, d >= 1); got {tuple(er.shape)}, {tuple(el.shape)}, "
                         f"{tuple(h.shape)}")
    return (F.pad(er, (0, n_rows - er.shape[0])).contiguous(),
            F.pad(el, (0, n_cols - el.shape[0])).contiguous(),
            F.pad(h, (0, 0, 0, n_cols - h.shape[0])).contiguous())


def _tile_raw_logits(bsr: BSRMatrix, er: torch.Tensor, el: torch.Tensor):
    """Per tile, ``raw[k, i, j] = er_i + el_j`` and the edge mask ``tile != 0``
    (the tile values themselves are ignored, pallas_kernels.py:335-336)."""
    blk = bsr.block
    er3 = er.reshape(-1, blk)[bsr.block_rows.long()]
    el3 = el.reshape(-1, blk)[bsr.block_cols.long()]
    return er3[:, :, None] + el3[:, None, :], bsr.tiles != 0


def bsr_gat_reference(bsr: BSRMatrix, er: torch.Tensor, el: torch.Tensor, h: torch.Tensor, *,
                      negative_slope: float = 0.2, act: str = "leaky_relu",
                      return_stats: bool = False):
    """Fused GAT as a tile gather and a two-pass softmax: the per-row max with
    ``scatter_reduce(amax)``, then the normaliser and ``p @ h`` with ``bmm``
    and ``index_add_`` per block-row. Same contract as :func:`bsr_gat` /
    :func:`bsr_gat_stats`: rows with no edge give 0, ``m = -1e30``, ``l = 0``."""
    er, el, h = _gat_inputs("bsr_gat", bsr, er, el, h, act)
    n_rows, blk, d = bsr.shape[0], bsr.block, h.shape[1]
    rows = bsr.block_rows.long()
    raw, mask = _tile_raw_logits(bsr, er, el)
    logits = torch.where(mask, _att_activation(raw, negative_slope, act), -torch.inf)
    m = torch.full((n_rows // blk, blk), -1e30, dtype=h.dtype, device=h.device)
    m = m.scatter_reduce(0, rows[:, None].expand(-1, blk), logits.amax(2), "amax")
    p = torch.where(mask, torch.exp(logits - m[rows][:, :, None]), 0.0)
    l = torch.zeros_like(m).index_add_(0, rows, p.sum(2))
    acc = torch.zeros((n_rows // blk, blk, d), dtype=h.dtype, device=h.device)
    acc.index_add_(0, rows, torch.bmm(p, h.reshape(-1, blk, d)[bsr.block_cols.long()]))
    out = (acc / l.clamp(min=1e-12)[:, :, None]).reshape(n_rows, d)
    return (out, m.reshape(-1), l.reshape(-1)) if return_stats else out


def _gat_grad_inputs(bsr: BSRMatrix, g, out, m, l):
    n_rows = bsr.shape[0]
    if not (g.dim() == out.dim() == 2 and m.dim() == l.dim() == 1) \
            or max(g.shape[0], out.shape[0], m.shape[0], l.shape[0]) > n_rows:
        raise ValueError(f"bsr_gat_grads: need g, out (<= {n_rows}, d) and m, l "
                         f"(<= {n_rows},); got {tuple(g.shape)}, {tuple(out.shape)}, "
                         f"{tuple(m.shape)}, {tuple(l.shape)}")
    return [F.pad(t, (0, 0) * (t.dim() - 1) + (0, n_rows - t.shape[0])).contiguous()
            for t in (g, out, m, l)]


def bsr_gat_grads_reference(bsr: BSRMatrix, er: torch.Tensor, el: torch.Tensor,
                            h: torch.Tensor, g: torch.Tensor, out: torch.Tensor,
                            m: torch.Tensor, l: torch.Tensor, *, negative_slope: float = 0.2,
                            act: str = "leaky_relu"):
    """The flash backward of :func:`bsr_gat_reference` from its stats, with
    the same contract as :func:`bsr_gat_grads`: ``p`` from (m, l),
    ``r_i = ḡ_i·out_i``, ``da = p ⊙ (ḡhᵀ − r) ⊙ act'``; ``der`` sums da by
    row, ``del`` by column, ``dh = pᵀḡ`` (``bmm`` and ``index_add_``)."""
    n_er, n_el, n_src = er.shape[0], el.shape[0], h.shape[0]
    er, el, h = _gat_inputs("bsr_gat_grads", bsr, er, el, h, act)
    g, out, m, l = _gat_grad_inputs(bsr, g, out, m, l)
    blk, d = bsr.block, h.shape[1]
    if g.shape[1] != d or out.shape[1] != d:
        raise ValueError(f"bsr_gat_grads: g and out must have d = {d} columns")
    rows, cols = bsr.block_rows.long(), bsr.block_cols.long()
    r3 = (g * out).sum(1).reshape(-1, blk)[rows]
    g3 = g.reshape(-1, blk, d)[rows]
    raw, mask = _tile_raw_logits(bsr, er, el)
    logits = _att_activation(raw, negative_slope, act)
    p = torch.where(mask, torch.exp(logits - m.reshape(-1, blk)[rows][:, :, None]), 0.0)
    p = p / l.reshape(-1, blk)[rows].clamp(min=1e-12)[:, :, None]
    s = torch.bmm(g3, h.reshape(-1, blk, d)[cols].transpose(1, 2))
    da = p * (s - r3[:, :, None]) * _att_activation_grad(raw, negative_slope, act)
    n_brows, n_bcols = bsr.shape[0] // blk, bsr.shape[1] // blk
    der = er.new_zeros((n_brows, blk)).index_add_(0, rows, da.sum(2)).reshape(-1)
    del_ = el.new_zeros((n_bcols, blk)).index_add_(0, cols, da.sum(1)).reshape(-1)
    dh = h.new_zeros((n_bcols, blk, d)).index_add_(0, cols, torch.bmm(p.transpose(1, 2), g3))
    return der[:n_er], del_[:n_el], dh.reshape(-1, d)[:n_src]


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


def _check_tiling(name: str, bsr: BSRMatrix):
    """What the CUDA kernels that walk whole tiles need of the tiling."""
    if bsr.block != BLOCK or bsr.tiles.shape[2] != BLOCK \
            or bsr.shape[0] % BLOCK or bsr.shape[1] % BLOCK:
        raise ValueError(f"{name}: the CUDA kernel takes {BLOCK}x{BLOCK} tiles of a padded shape")
    if bsr.rowptr.shape[0] != bsr.shape[0] // BLOCK + 1 or bsr.block_cols.shape[0] != bsr.nb \
            or bsr.block_rows.shape[0] != bsr.nb:
        raise ValueError(f"{name}: rowptr, block_rows or block_cols do not match the tiles "
                         f"and shape")
    if bsr.tiles.data_ptr() % 16:
        raise ValueError(f"{name}: tiles must be 16-byte aligned")


def bsr_spmm(bsr: BSRMatrix, b: torch.Tensor) -> torch.Tensor:
    """``out = A @ B`` with A in BSR form and B (n_cols_padded, d) float32;
    returns (n_rows_padded, d) float32 (counterpart: pallas_kernels.py:101).

    Any ``d`` is taken; the kernel masks the ragged feature tile itself."""
    n_rows, n_cols = bsr.shape
    if b.dim() != 2 or b.shape[0] != n_cols:
        raise ValueError(f"bsr_spmm: b must be ({n_cols}, d), got {tuple(b.shape)}")
    if _on_cpu(bsr.tiles, bsr.block_cols, bsr.rowptr, b):
        return bsr_spmm_reference(bsr, b)
    _check_tiling("bsr_spmm", bsr)
    _check_cuda_args("bsr_spmm", (bsr.tiles, b), (bsr.block_cols, bsr.rowptr))
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


def _gat_forward(name: str, bsr: BSRMatrix, er, el, h, negative_slope: float, act: str,
                 stats: bool):
    erp, elp, hp = _gat_inputs(name, bsr, er, el, h, act)
    if _on_cpu(bsr.tiles, bsr.block_cols, bsr.rowptr, erp, elp, hp):
        return bsr_gat_reference(bsr, erp, elp, hp, negative_slope=negative_slope, act=act,
                                 return_stats=stats)
    _check_tiling(name, bsr)
    _check_cuda_args(name, (bsr.tiles, erp, elp, hp), (bsr.block_cols, bsr.rowptr))
    n_rows, d = bsr.shape[0], hp.shape[1]
    out = torch.empty((n_rows, d), dtype=torch.float32, device=hp.device)
    m = torch.empty(n_rows, dtype=torch.float32, device=hp.device)
    l = torch.empty_like(m)
    ptrs = [bsr.tiles.data_ptr(), bsr.block_cols.data_ptr(), bsr.rowptr.data_ptr(),
            erp.data_ptr(), elp.data_ptr(), hp.data_ptr(), out.data_ptr()]
    if stats:
        ptrs += [m.data_ptr(), l.data_ptr()]
    _launch("dtt_bsr_gat_stats_f32" if stats else "dtt_bsr_gat_f32", hp.device, *ptrs,
            n_rows // BLOCK, d, GAT_ACTS[act], negative_slope)
    (bsr_gat_stats if stats else bsr_gat).launches += 1
    return (out, m, l) if stats else out


def bsr_gat(bsr: BSRMatrix, er: torch.Tensor, el: torch.Tensor, h: torch.Tensor, *,
            negative_slope: float = 0.2, act: str = "leaky_relu") -> torch.Tensor:
    """Fused single-head GAT, ``out_i = Σ_j softmax_i(act(er_i + el_j)) h_j``
    over the edges ``tile != 0`` (counterpart: pallas_kernels.py:354).

    ``er`` (<= n_rows,) destination logits, ``el`` (<= n_cols,) source logits,
    ``h`` (<= n_cols, d) source features, all float32; zero-padded to the
    tiling. Returns (n_rows_padded, d). ``act`` is ``"leaky_relu"`` (slope
    ``negative_slope``) or ``"sigmoid"``."""
    return _gat_forward("bsr_gat", bsr, er, el, h, negative_slope, act, stats=False)


bsr_gat.launches = 0


def bsr_gat_stats(bsr: BSRMatrix, er: torch.Tensor, el: torch.Tensor, h: torch.Tensor, *,
                  negative_slope: float = 0.2, act: str = "leaky_relu"):
    """:func:`bsr_gat` that also returns the softmax stats ``(out, m, l)``: the
    per-row max ``m`` and normaliser ``l``, each (n_rows_padded,), that the
    flash backward needs (counterpart: pallas_kernels.py:426)."""
    return _gat_forward("bsr_gat_stats", bsr, er, el, h, negative_slope, act, stats=True)


bsr_gat_stats.launches = 0


def bsr_gat_grads(bsr: BSRMatrix, er: torch.Tensor, el: torch.Tensor, h: torch.Tensor,
                  g: torch.Tensor, out: torch.Tensor, m: torch.Tensor, l: torch.Tensor, *,
                  negative_slope: float = 0.2, act: str = "leaky_relu"):
    """Gradients ``(der, del, dh)`` of :func:`bsr_gat` from the forward's
    ``out, m, l`` and the output cotangent ``g`` (counterpart:
    pallas_kernels.py:507); shaped like ``er``, ``el`` and ``h``.

    The CUDA kernel sums columns through :func:`bsr_col_order` in a fixed
    order and uses no atomics, so its result is the same on every run. It
    needs a (2, nb, 128, 128) float32 scratch buffer, allocated here."""
    n_er, n_el, n_src = er.shape[0], el.shape[0], h.shape[0]
    erp, elp, hp = _gat_inputs("bsr_gat_grads", bsr, er, el, h, act)
    gp, outp, mp, lp = _gat_grad_inputs(bsr, g, out, m, l)
    if _on_cpu(bsr.tiles, bsr.block_rows, bsr.block_cols, erp, elp, hp, gp, outp, mp, lp):
        return bsr_gat_grads_reference(bsr, er, el, h, g, out, m, l,
                                       negative_slope=negative_slope, act=act)
    _check_tiling("bsr_gat_grads", bsr)
    n_rows, n_cols = bsr.shape
    d = hp.shape[1]
    if gp.shape[1] != d or outp.shape[1] != d:
        raise ValueError(f"bsr_gat_grads: g and out must have d = {d} columns")
    colptr, colperm = bsr_col_order(bsr)
    _check_cuda_args("bsr_gat_grads", (bsr.tiles, erp, elp, hp, gp, outp, mp, lp),
                     (bsr.block_rows, bsr.block_cols, bsr.rowptr, colptr, colperm))
    r = (gp * outp).sum(1)  # r_i = ḡ_i·out_i, outside the kernel as in JAX (:528)
    scratch = torch.empty((2, bsr.nb, BLOCK, BLOCK), dtype=torch.float32, device=hp.device)
    der = torch.empty(n_rows, dtype=torch.float32, device=hp.device)
    del_ = torch.empty(n_cols, dtype=torch.float32, device=hp.device)
    dh = torch.empty((n_cols, d), dtype=torch.float32, device=hp.device)
    _launch("dtt_bsr_gat_grads_f32", hp.device, bsr.tiles.data_ptr(), bsr.block_rows.data_ptr(),
            bsr.block_cols.data_ptr(), bsr.rowptr.data_ptr(), colptr.data_ptr(),
            colperm.data_ptr(), erp.data_ptr(), elp.data_ptr(), hp.data_ptr(), gp.data_ptr(),
            mp.data_ptr(), lp.data_ptr(), r.data_ptr(), scratch.data_ptr(), der.data_ptr(),
            del_.data_ptr(), dh.data_ptr(), bsr.nb, n_rows // BLOCK, n_cols // BLOCK, d,
            GAT_ACTS[act], negative_slope)
    bsr_gat_grads.launches += 1
    return der[:n_er], del_[:n_el], dh[:n_src]


bsr_gat_grads.launches = 0


class BSRGat(torch.autograd.Function):
    """Differentiable fused GAT (counterpart: ``_bsr_gat_core`` with
    ``_bsr_gat_fwd``/``_bsr_gat_bwd``, pallas_kernels.py:615-640): the forward
    keeps the softmax stats (:func:`bsr_gat_stats`), the backward is the flash
    backward (:func:`bsr_gat_grads`). The tiles get no gradient."""

    @staticmethod
    def forward(ctx, er, el, h, bsr, negative_slope, act):
        out, m, l = bsr_gat_stats(bsr, er, el, h, negative_slope=negative_slope, act=act)
        ctx.mat, ctx.negative_slope, ctx.act = bsr, negative_slope, act
        ctx.save_for_backward(er, el, h, out, m, l)
        return out

    @staticmethod
    def backward(ctx, grad):
        er, el, h, out, m, l = ctx.saved_tensors
        der, del_, dh = bsr_gat_grads(ctx.mat, er, el, h, grad.contiguous(), out, m, l,
                                      negative_slope=ctx.negative_slope, act=ctx.act)
        return der, del_, dh, None, None, None


def bsr_gat_ad(bsr: BSRMatrix, er: torch.Tensor, el: torch.Tensor, h: torch.Tensor, *,
               negative_slope: float = 0.2, act: str = "leaky_relu") -> torch.Tensor:
    """Differentiable :func:`bsr_gat` (counterpart: pallas_kernels.py:643).
    Where autograd records and an input requires grad, it runs
    :func:`bsr_gat_stats` forward and :func:`bsr_gat_grads` backward;
    otherwise the primal :func:`bsr_gat`, as JAX does outside ``grad``."""
    if torch.is_grad_enabled() and (er.requires_grad or el.requires_grad or h.requires_grad):
        return BSRGat.apply(er, el, h, bsr, negative_slope, act)
    return bsr_gat(bsr, er, el, h, negative_slope=negative_slope, act=act)


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


__all__ = ["BLOCK", "BSRGat", "BSRMatrix", "BSRSpMM", "GAT_ACTS", "bsr_col_order",
           "bsr_from_scipy", "bsr_gat", "bsr_gat_ad", "bsr_gat_grads",
           "bsr_gat_grads_reference", "bsr_gat_reference", "bsr_gat_stats", "bsr_sddmm",
           "bsr_sddmm_reference", "bsr_spmm", "bsr_spmm_ad", "bsr_spmm_reference",
           "bsr_transpose", "bsr_with_rcm", "rcm_reorder", "unpermute"]
