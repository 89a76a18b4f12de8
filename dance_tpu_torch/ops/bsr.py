"""Block-sparse (BSR) matrices and the CUDA kernels over them.

Counterpart: the host side and the kernels of
dance_tpu/ops/pallas_kernels.py — ``BSRMatrix`` (:29), ``bsr_from_scipy``
(:53), ``bsr_spmm`` (:101), ``bsr_sddmm`` (:159), ``bsr_transpose`` (:207),
``bsr_spmm_ad`` (:219-270) with their ``compute_dtype`` (bf16 streaming),
the fused GAT ``bsr_gat`` (:354), ``bsr_gat_stats`` (:426), ``bsr_gat_grads``
(:507) and ``bsr_gat_ad`` (:615-650), ``rcm_reorder``/``bsr_with_rcm`` (:653-674), ``unpermute``
(:775), ``bipartite_bsr`` (:677-695), the format rule ``tile_expansion``,
``resolve_use_bsr`` and ``choose_adj_format`` (:697-772) and the max
aggregation ``bsr_spmm_max`` (:786-863).

A BSR matrix here is the same list of dense 128 x 128 tiles sorted by
block-row, plus a tile-row pointer ``rowptr`` (tiles of block-row ``r`` are
``rowptr[r]:rowptr[r + 1]``), which the CUDA kernels walk per block-row.

Each kernel has a wrapper and a plain PyTorch version of the same math
(gathers, ``bmm``, ``scatter_reduce``, ``index_add_`` and ``amax``). The
wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel (``csrc/bsr_spmm.cu``, ``csrc/bsr_sddmm.cu``,
``csrc/bsr_gat.cu``, ``csrc/bsr_gat_bwd.cu``, ``csrc/bsr_spmm_max.cu``) or
raises. Each wrapper counts its launches in a plain int attribute, e.g.
``bsr_spmm.launches``, and the SpMM and SDDMM wrappers their bf16 launches
among them in ``launches_bf16``. The max aggregation ``bsr_spmm_max`` (:826) is
forward-only, as in JAX: differentiating through it raises.

The format rule keeps JAX's shape and parameters; its default crossovers
were measured on an H100 (``tools/time_formats.py``, PERF.md), not carried
over from the TPU. Off the card ``"auto"`` is CSR, as JAX's is off the TPU.

``compute_dtype=torch.bfloat16`` (JAX's ``compute_dtype=jnp.bfloat16``)
rounds the tiles and the dense operands to bf16 (round to nearest even, as
JAX's ``astype``) and sums their products in float32; the output stays
float32. JAX also takes float16 there; the port raises on any dtype but
bf16 and float32 (ROADMAP Queue 1, item 11).

Not ported yet (ROADMAP Queue 1): the pure-XLA ``bsr_gat_scan`` (the GAT
plain versions take its place as the oracle).
"""

import functools
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

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

    ``shape`` is the padded (n_rows, n_cols), multiples of the tile edge.
    Unless the tiles require grad, the transposed tiling is computed once and
    kept (:func:`bsr_transpose`), as are the edge bits (:func:`bsr_edge_mask`),
    the edge lists (:func:`bsr_edges`) and the tiles in bf16
    (:func:`bsr_compute_tiles`); the kernels' work schedules
    (:func:`device_schedule`) are kept always. Each kept value is stamped with
    the tensors it was built from and their version counters (the tiles,
    block rows and block columns; ``rowptr`` for the schedules), and is built
    again once one of them is replaced or edited in place. A matrix made by
    :func:`bsr_like` shares its pattern's block indices, ``rowptr``, work
    schedules and transposed pattern (``_pattern``)."""

    tiles: torch.Tensor       # (nb, block, block) f32
    block_rows: torch.Tensor  # (nb,) int32, sorted
    block_cols: torch.Tensor  # (nb,) int32
    rowptr: torch.Tensor      # (n_rows // block + 1,) int32
    shape: Tuple[int, int]
    _transpose: Optional["BSRMatrix"] = field(default=None, repr=False, compare=False)
    # the kernels' work schedules (DeviceSchedule), by (resident blocks, blocks per item)
    _schedules: dict = field(default_factory=dict, repr=False, compare=False)
    _edge_mask: Optional[torch.Tensor] = field(default=None, repr=False, compare=False)
    _edges: Optional["BSREdges"] = field(default=None, repr=False, compare=False)
    _tiles_bf16: Optional[torch.Tensor] = field(default=None, repr=False, compare=False)
    # the tile order of the transpose (by block column, stable), kept with it
    _transpose_order: Optional[torch.Tensor] = field(default=None, repr=False, compare=False)
    # the matrix whose pattern this one shares (:func:`bsr_like`)
    _pattern: Optional["BSRMatrix"] = field(default=None, repr=False, compare=False)
    # what the kept values above were built from (:func:`_drop_stale`)
    _tiles_stamp: tuple = field(default=(), repr=False, compare=False)
    _rowptr_stamp: tuple = field(default=(), repr=False, compare=False)

    @property
    def nb(self) -> int:
        return self.tiles.shape[0]

    @property
    def block(self) -> int:
        return self.tiles.shape[1]

    def to(self, device) -> "BSRMatrix":
        return BSRMatrix(self.tiles.to(device), self.block_rows.to(device),
                         self.block_cols.to(device), self.rowptr.to(device), self.shape)


def _stale(stamp: tuple, tensors) -> bool:
    """Whether ``stamp`` was taken of other tensors than ``tensors``, or of
    them before an in-place edit (their version counters moved since)."""
    return len(stamp) != len(tensors) or any(
        kept is not t or version != t._version for (kept, version), t in zip(stamp, tensors))


def _drop_stale(bsr: "BSRMatrix"):
    """Forget the values kept on ``bsr`` whose inputs changed since they were
    built: the transpose, edge bits, edge lists and bf16 tiles when the tiles,
    block rows or block columns were replaced or edited in place, the work schedules when
    ``rowptr`` was. JAX arrays cannot change under a kept value; torch
    tensors can, and a stale transpose gave the old ``Aᵀḡ`` silently."""
    tiles = (bsr.tiles, bsr.block_rows, bsr.block_cols)
    if _stale(bsr._tiles_stamp, tiles):
        bsr._transpose = bsr._transpose_order = bsr._edge_mask = bsr._edges = None
        bsr._tiles_bf16 = None
        bsr._tiles_stamp = tuple((t, t._version) for t in tiles)
    if _stale(bsr._rowptr_stamp, (bsr.rowptr,)):
        bsr._schedules.clear()
        bsr._rowptr_stamp = ((bsr.rowptr, bsr.rowptr._version),)


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

    The JAX package re-derives it in every backward; here it is kept on the
    matrix until its tiles change, unless they require grad. The transpose of
    a :func:`bsr_like` copy takes its pattern's transposed pattern (block
    indices, ``rowptr``, work schedules) and gathers only the tiles again."""
    _drop_stale(bsr)
    if bsr._transpose is not None:
        return bsr._transpose
    if bsr._pattern is not None:
        pt = bsr_transpose(bsr._pattern)
        at = bsr_like(pt, bsr.tiles.detach()[bsr._pattern._transpose_order].transpose(1, 2)
                      .contiguous())
    else:
        order = torch.argsort(bsr.block_cols, stable=True)
        brows_t = bsr.block_cols[order]
        at = BSRMatrix(bsr.tiles.detach()[order].transpose(1, 2).contiguous(), brows_t,
                       bsr.block_rows[order], _rowptr(brows_t, bsr.shape[1] // bsr.block),
                       (bsr.shape[1], bsr.shape[0]))
        bsr._transpose_order = order
    if not bsr.tiles.requires_grad:
        bsr._transpose = at
    return at


def bsr_like(bsr: BSRMatrix, tiles: torch.Tensor) -> BSRMatrix:
    """A matrix of ``bsr``'s pattern with other ``tiles`` of the same shape,
    such as its tiles after dropout on the weights (a zero slot stays zero, so
    the edges stay a subset). It shares the block indices, ``rowptr`` and the
    kernels' kept work schedules with ``bsr``; its transpose shares
    ``bsr``'s transposed pattern (:func:`bsr_transpose`). So a new copy at
    every step builds no schedule on the host and reads nothing back: only
    its tiles are new. JAX's ``_drop_adj`` rebuilds the matrix from the same
    block indices (predict_modality/scmogcn.py:221-223)."""
    if tiles.shape != bsr.tiles.shape:
        raise ValueError(f"bsr_like: tiles {tuple(tiles.shape)} do not match the pattern's "
                         f"{tuple(bsr.tiles.shape)}")
    _drop_stale(bsr)
    pattern = bsr._pattern if bsr._pattern is not None else bsr
    return BSRMatrix(tiles, bsr.block_rows, bsr.block_cols, bsr.rowptr, bsr.shape,
                     _schedules=bsr._schedules, _rowptr_stamp=bsr._rowptr_stamp,
                     _pattern=pattern)


# A split block-row's chunks hold at least this many tiles.
MIN_CHUNK = 4
ITEMS_PER_SLOT = 3  # work items each resident thread block takes, about


@dataclass(frozen=True)
class WorkSchedule:
    """Work items of the SpMM and GAT kernels (:func:`work_schedule`)."""

    items: np.ndarray  # (n_items, 4) int32: block-row, first tile, end tile, slot or -1
    rows: np.ndarray   # (n_split, 4) int32: block-row, first slot, chunks, 0
    n_slots: int       # partial results in the scratch buffers
    chunk: int         # most tiles in an item


def work_schedule(rowptr, slots: int, blocks_per_item: int = 1) -> WorkSchedule:
    """Split the block-rows of a tiling into work items of about equal size
    for a kernel that runs ``blocks_per_item`` thread blocks on each item
    (feature slabs, row halves), on a card where ``slots`` thread blocks of
    it are resident at once (blocks per SM x SMs).

    ``per_slot = nb * blocks_per_item / slots`` is the tile-steps each
    resident block would take if the work were even; the chunk size is
    ``C = max(MIN_CHUNK, ceil(per_slot / ITEMS_PER_SLOT))``, so that each
    block slot takes about three items. A block-row of ``n > C`` tiles
    becomes ``ceil(n / C)`` consecutive chunks whose sizes differ by at most
    one, each writing a partial result to its own scratch slot; a shorter
    row (an empty one too) is one item that writes the output itself.
    ``rows`` lists the split rows with their slots, which the kernels
    combine in chunk order, so the result does not depend on the order in
    which items run.
    Items are sorted longest first (stable), so the long ones start in the
    first wave."""
    rowptr = np.asarray(rowptr, np.int64)
    counts = np.diff(rowptr)
    per_slot = -(-int(rowptr[-1]) * blocks_per_item // slots)
    chunk = max(MIN_CHUNK, -(-per_slot // ITEMS_PER_SLOT))
    items, rows, slot = [], [], 0
    for r, (start, n) in enumerate(zip(rowptr[:-1].tolist(), counts.tolist())):
        k = max(1, -(-n // chunk))
        if k == 1:
            items.append((r, start, start + n, -1))
            continue
        bounds = [start + n * c // k for c in range(k + 1)]
        items += [(r, bounds[c], bounds[c + 1], slot + c) for c in range(k)]
        rows.append((r, slot, k, 0))
        slot += k
    items = np.asarray(items, np.int32).reshape(-1, 4)
    items = items[np.argsort(items[:, 1] - items[:, 2], kind="stable")]
    return WorkSchedule(items, np.asarray(rows, np.int32).reshape(-1, 4), slot, chunk)


# the kernels that run a work schedule, by the C symbol that reports their launch
_INFO_SYMBOLS = {"spmm": "dtt_bsr_spmm_info", "spmm_bf16": "dtt_bsr_spmm_bf16_info",
                 "gat": "dtt_bsr_gat_info", "max": "dtt_bsr_spmm_max_info"}
_INFO_FIELDS = ("threads", "smem_bytes", "blocks_per_sm", "registers", "slabs", "slab_width",
                "blocks_per_item")


@functools.lru_cache(maxsize=None)
def launch_geometry(kernel: str, d: int, device_index: int) -> dict:
    """How the scheduled kernel ``kernel`` (``"spmm"``, ``"spmm_bf16"``,
    ``"gat"`` or ``"max"``) launches at width ``d`` on CUDA device ``device_index``, as the
    compiled kernel reports it (``dtt_bsr_{spmm,gat,spmm_max}_info``): threads, dynamic shared
    memory, thread blocks resident per SM, registers, feature slabs and
    their width, thread blocks per work item; and the card's SMs. Kept per
    (kernel, d, device)."""
    import ctypes

    from dance_tpu_torch.ops._build import load_kernels

    info = (ctypes.c_int * len(_INFO_FIELDS))()
    err = getattr(load_kernels().lib, _INFO_SYMBOLS[kernel])(d, ctypes.addressof(info),
                                                           device_index)
    if err:
        raise RuntimeError(f"{_INFO_SYMBOLS[kernel]}: cudaError {err}")
    geo = dict(zip(_INFO_FIELDS, info))
    geo["sms"] = torch.cuda.get_device_properties(device_index).multi_processor_count
    return geo


@dataclass(frozen=True)
class DeviceSchedule:
    """A :class:`WorkSchedule` as a kernel runs it on one card."""

    schedule: WorkSchedule
    items: torch.Tensor  # schedule.items on the card
    rows: torch.Tensor   # schedule.rows on the card
    geometry: dict       # :func:`launch_geometry` it was made for


def device_schedule(bsr: BSRMatrix, kernel: str, d: int, device: torch.device) -> DeviceSchedule:
    """The work schedule that ``kernel`` (a key of :func:`launch_geometry`) runs on
    ``bsr`` at width ``d`` on ``device``: :func:`work_schedule` for the
    card's resident thread blocks and the kernel's blocks per item, from
    :func:`launch_geometry`. Kept on the matrix until its ``rowptr`` changes,
    and shared with its :func:`bsr_like` copies; ``device_schedule.builds``
    counts the schedules built."""
    _drop_stale(bsr)
    geo = launch_geometry(kernel, d, device.index)
    key = (geo["blocks_per_sm"] * geo["sms"], geo["blocks_per_item"])
    if key not in bsr._schedules:
        sched = work_schedule(bsr.rowptr.cpu().numpy(), *key)
        device_schedule.builds += 1
        bsr._schedules[key] = DeviceSchedule(sched, torch.from_numpy(sched.items).to(device),
                                             torch.from_numpy(sched.rows).to(device), geo)
    return bsr._schedules[key]


device_schedule.builds = 0  # schedules built on the host (each reads rowptr back once)


def bsr_edge_mask(bsr: BSRMatrix) -> torch.Tensor:
    """The edges ``tiles != 0`` as bits, (nb, 128, 4) int32: bit ``j`` of word
    ``w`` of row ``i`` is column ``32 w + j`` (NaN counts as an edge). The GAT
    kernels read it instead of the tiles, 1/32 of their bytes. Kept on the
    matrix until its tiles change, unless they require grad."""
    _drop_stale(bsr)
    if bsr._edge_mask is not None:
        return bsr._edge_mask
    nb, blk = bsr.nb, bsr.block
    edges = (bsr.tiles.detach() != 0).reshape(nb, blk, blk // 32, 32).to(torch.int32)
    # distinct bits add without carries: the sum is the word (bit 31 wraps)
    shift = torch.arange(32, dtype=torch.int32, device=edges.device)
    mask = (edges << shift).sum(-1, dtype=torch.int32).contiguous()
    if not bsr.tiles.requires_grad:
        bsr._edge_mask = mask
    return mask


@dataclass(frozen=True)
class BSREdges:
    """The edges of a BSR matrix (the slots ``!= 0``) as lists, from
    :func:`bsr_edges`; all int32, over the padded rows and columns."""

    rowptr: torch.Tensor   # (n_rows + 1,): the edges of row i are rowptr[i]:rowptr[i + 1]
    cols: torch.Tensor     # (nnz,): each edge's column
    rows: torch.Tensor     # (nnz,): each edge's row
    colptr: torch.Tensor   # (n_cols + 1,): column j's edges are colperm[colptr[j]:colptr[j + 1]]
    colperm: torch.Tensor  # (nnz,): edge ids in column order, ascending within a column

    @property
    def nnz(self) -> int:
        return self.cols.shape[0]


def bsr_edges(bsr: BSRMatrix) -> BSREdges:
    """The edges of ``bsr`` as row and column lists (:class:`BSREdges`).

    An edge is a slot ``!= 0``, so NaN counts as one, as in
    :func:`bsr_edge_mask` and the plain versions; pad tiles give none. Edge
    ids run by row, and within a row in tile order, then slot order; each
    column lists its edges in id order. Building them synchronises once
    (``torch.nonzero``); they are kept on the matrix until its tiles change,
    unless they require grad, so later calls read nothing back to the host."""
    _drop_stale(bsr)
    if bsr._edges is not None:
        return bsr._edges
    blk, (n_rows, n_cols) = bsr.block, bsr.shape
    t, i, j = torch.nonzero(bsr.tiles.detach() != 0, as_tuple=True)  # by tile, row, slot
    rows = bsr.block_rows.long()[t] * blk + i
    order = torch.argsort(rows, stable=True)  # tiles of a block-row stay in order
    rows, cols = rows[order], (bsr.block_cols.long()[t] * blk + j)[order]
    colperm = torch.argsort(cols, stable=True)

    def ptr(sorted_idx, n):  # searchsorted, where bincount would synchronise again
        bounds = torch.arange(n + 1, dtype=torch.int64, device=sorted_idx.device)
        return torch.searchsorted(sorted_idx, bounds).to(torch.int32)

    edges = BSREdges(ptr(rows, n_rows), cols.to(torch.int32), rows.to(torch.int32),
                     ptr(cols[colperm], n_cols), colperm.to(torch.int32))
    if not bsr.tiles.requires_grad:
        bsr._edges = edges
    return edges


def compute_dtype_of(name: str, compute_dtype) -> Optional[torch.dtype]:
    """The dtype a SpMM or SDDMM streams its operands in: ``None`` (float32)
    for ``None`` or ``torch.float32``, ``torch.bfloat16`` for itself. JAX
    takes float16 too (pallas_kernels.py:118-120); the port raises on it and
    on any other dtype."""
    if compute_dtype is None or compute_dtype == torch.float32:
        return None
    if compute_dtype == torch.bfloat16:
        return torch.bfloat16
    raise ValueError(f"{name}: compute_dtype must be torch.bfloat16 or None (float32), got "
                     f"{compute_dtype!r}; float16 streaming is not ported (ROADMAP Queue 1, "
                     f"item 11)")


def bsr_compute_tiles(bsr: BSRMatrix, compute_dtype: torch.dtype) -> torch.Tensor:
    """``bsr.tiles`` in ``compute_dtype`` (bf16), rounded to nearest even as
    JAX's ``astype``. JAX casts at every call (pallas_kernels.py:118-119);
    here the copy is made once and kept on the matrix until its tiles
    change, unless they require grad, as the transpose is."""
    _drop_stale(bsr)
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"bsr_compute_tiles: bf16 only, got {compute_dtype!r}")
    if bsr._tiles_bf16 is not None:
        return bsr._tiles_bf16
    tiles = bsr.tiles.detach().to(torch.bfloat16).contiguous()
    if not bsr.tiles.requires_grad:
        bsr._tiles_bf16 = tiles
    return tiles


# The defaults of the format rule on the card: crossovers measured on an H100
# by tools/time_formats.py (PERF.md, "Format crossovers"), one layer's sum
# forward + backward in each format. #1 streams every slot of its stored
# tiles at about 0.7-0.8 of the time cuBLAS takes per slot of the dense
# matrix, so dense wins once the tiles cover ~80 % of the matrix; it streams
# a slot at about 1/250 of what the CSR gather and sum took per edge (measured
# when that sum was an index_add_; the fixed-order sum is re-timed in chip_smoke's
# phase 75).
# The density test is the occupancy test for a tiling packed without waste.
DENSE_THRESHOLD = 0.8    # edges / (n m) at and above which the dense product wins
DENSE_OCCUPANCY = 0.8    # stored tiles' slots / (n m) at and above which it wins too
MAX_EXPANSION = 250.0    # stored slots per edge up to which #1 beats the CSR gather
# Not a crossover: the most device memory a dense adjacency may take.
DENSE_MAX_BYTES = 2 << 30


def tile_expansion(adj: sp.spmatrix, block: int = BLOCK) -> float:
    """Stored slots per edge of the BSR tiling, ``nonzero tiles x block² / nnz``
    (counterpart: pallas_kernels.py:697): the multiply-adds #1 does for each
    one an edge needs. ``inf`` for a matrix without entries."""
    coo = sp.coo_matrix(adj)
    if coo.nnz == 0:
        return float("inf")
    n_bcols = -(-coo.shape[1] // block)
    tiles = np.unique((coo.row // block).astype(np.int64) * n_bcols + coo.col // block).size
    return tiles * block * block / coo.nnz


def choose_adj_format(adj: sp.spmatrix, block: int = BLOCK, *, device,
                      max_expansion: float = MAX_EXPANSION, reorder: bool = True,
                      dense_threshold: float = DENSE_THRESHOLD,
                      dense_occupancy: float = DENSE_OCCUPANCY,
                      dense_max_bytes: int = DENSE_MAX_BYTES) -> str:
    """The device format of an adjacency that sums messages: ``"dense"``,
    ``"bsr"`` or ``"csr"`` (counterpart: pallas_kernels.py:732), by JAX's rule:

    - density ≥ ``dense_threshold`` and the dense (n, m) float32 matrix fits
      in ``dense_max_bytes``: ``"dense"`` (one cuBLAS product);
    - else, after an RCM reordering when ``reorder``, ``"dense"`` where the
      BSR tiles would cover ≥ ``dense_occupancy`` of the n m slots
      (``tile_expansion · density``) and the dense matrix fits;
    - else ``"bsr"`` (#1) when :func:`tile_expansion` ≤ ``max_expansion``,
      and ``"csr"`` (gather and fixed-order sum) above it.

    On a CPU ``device`` the answer is ``"csr"``, as JAX's is off the TPU: the
    plain BSR version there is the kernel's slow oracle. The defaults are the
    H100 crossovers at the top of this module."""
    if torch.device(device).type != "cuda":
        return "csr"
    adj = sp.csr_matrix(adj)
    n, m = adj.shape
    density = adj.nnz / max(n * m, 1)
    dense_fits = 4 * n * m <= dense_max_bytes
    if density >= dense_threshold and dense_fits:
        return "dense"
    if reorder:
        _, adj = rcm_reorder(adj)
    expansion = tile_expansion(adj, block)
    if dense_fits and expansion * density >= dense_occupancy:
        return "dense"
    return "bsr" if expansion <= max_expansion else "csr"


def resolve_adj_format(use_bsr, adj: Optional[sp.spmatrix] = None, block: int = BLOCK, *,
                       device, dense: bool = True, reorder: bool = True,
                       max_expansion: float = MAX_EXPANSION) -> str:
    """The format a model's ``use_bsr`` flag names: ``True`` is ``"bsr"``,
    ``False`` ``"csr"``, ``"auto"`` :func:`choose_adj_format` on ``adj``
    (never ``"dense"`` for a model without a dense route, ``dense=False``).
    The one place the flag is read; :func:`resolve_use_bsr` is its
    BSR-or-CSR form."""
    if isinstance(use_bsr, bool):
        return "bsr" if use_bsr else "csr"
    if use_bsr != "auto":
        raise ValueError(f"use_bsr must be True, False or 'auto', got {use_bsr!r}")
    if adj is None:
        raise ValueError("use_bsr='auto' needs the adjacency it decides on")
    return choose_adj_format(adj, block, device=device, max_expansion=max_expansion,
                             reorder=reorder, dense_max_bytes=DENSE_MAX_BYTES if dense else 0)


def resolve_use_bsr(use_bsr, adj: Optional[sp.spmatrix] = None, block: int = BLOCK, *,
                    device, max_expansion: float = MAX_EXPANSION,
                    reorder: bool = True) -> bool:
    """A ``use_bsr`` flag as a bool for a model whose adjacency is BSR or CSR
    (counterpart: pallas_kernels.py:711): :func:`resolve_adj_format` without
    the dense answer, so one rule decides both."""
    return resolve_adj_format(use_bsr, adj, block, device=device, dense=False, reorder=reorder,
                              max_expansion=max_expansion) == "bsr"


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


class BipartiteBSR(NamedTuple):
    """A rectangular adjacency tiled both ways (counterpart: pallas_kernels.py:677):
    ``fwd`` is the (rows x cols) matrix, ``bwd`` its transpose, each tiled
    from scipy, so that ``A @ H`` and ``Aᵀ @ H`` are each one forward #1."""

    fwd: BSRMatrix
    bwd: BSRMatrix


def bipartite_bsr(adj: sp.spmatrix, block: int = BLOCK) -> BipartiteBSR:
    """Tile a rectangular scipy adjacency and its transpose (counterpart:
    pallas_kernels.py:690)."""
    adj = sp.csr_matrix(adj)
    return BipartiteBSR(bsr_from_scipy(adj, block=block),
                        bsr_from_scipy(adj.T.tocsr(), block=block))


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


def _rounded(t: torch.Tensor, compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``t`` rounded to ``compute_dtype`` and back to float32 (``t`` itself
    for ``None``): the product of two bf16 values is exact in float32, so a
    float32 product of the rounded operands is what the kernels sum."""
    return t if compute_dtype is None else t.to(compute_dtype).float()


def bsr_spmm_reference(bsr: BSRMatrix, b: torch.Tensor,
                       compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``A @ B`` as a tile gather, ``bmm`` and ``index_add_`` over block-rows;
    with ``compute_dtype`` (bf16) on the rounded tiles and B, in float32."""
    compute_dtype = compute_dtype_of("bsr_spmm_reference", compute_dtype)
    n_rows, n_cols = bsr.shape
    blk, d = bsr.block, b.shape[1]
    b3 = _rounded(b, compute_dtype).reshape(n_cols // blk, blk, d)
    prod = torch.bmm(_rounded(bsr.tiles, compute_dtype), b3[bsr.block_cols.long()])
    out = torch.zeros((n_rows // blk, blk, d), dtype=prod.dtype, device=prod.device)
    return out.index_add_(0, bsr.block_rows.long(), prod).reshape(n_rows, d)


# tile-slot columns per step of the max plain version, as the TPU kernel's
# _MAX_CHUNK (pallas_kernels.py:801), and the most message elements it holds
_MAX_CHUNK = 8
_MAX_MSG_ELEMS = 1 << 25


def bsr_spmm_max_reference(bsr: BSRMatrix, b: torch.Tensor, *,
                           weighted: bool = True) -> torch.Tensor:
    """``out[i, k] = max_j a_ij * b[j, k]`` over the nonzero tile slots (or
    of ``b[j, k]`` with ``weighted=False``); rows without a nonzero slot give
    ``-inf``, and a NaN message gives NaN, as ``jnp.maximum`` does.

    Chunked as the TPU kernel is (pallas_kernels.py:815-821): per group of
    tiles and per 8 tile columns the (tiles, 128, 8, d) messages are masked
    and folded into each tile's running row max, so the whole (nb, 128, 128,
    d) message tensor never exists (51 GB at graph-sc's tiling); then each
    block-row takes the max over its tiles."""
    n_rows, n_cols = bsr.shape
    blk, d = bsr.block, b.shape[1]
    b3 = b.reshape(n_cols // blk, blk, d)
    step = max(1, _MAX_MSG_ELEMS // (blk * _MAX_CHUNK * max(d, 1)))
    part = b.new_empty((bsr.nb, blk, d))
    for t0 in range(0, bsr.nb, step):
        tiles = bsr.tiles[t0:t0 + step]
        hb = b3[bsr.block_cols[t0:t0 + step].long()]
        acc = b.new_full((tiles.shape[0], blk, d), -torch.inf)
        for c0 in range(0, blk, _MAX_CHUNK):
            a = tiles[:, :, c0:c0 + _MAX_CHUNK, None]   # (t, 128, CH, 1)
            h = hb[:, None, c0:c0 + _MAX_CHUNK, :]      # (t, 1, CH, d)
            msg = torch.where(a != 0, a * h if weighted else h, -torch.inf)
            acc = torch.maximum(acc, msg.amax(2))
        part[t0:t0 + step] = acc
    out = b.new_full((n_rows // blk, blk, d), -torch.inf)
    rowptr = bsr.rowptr.tolist()
    for r in range(n_rows // blk):
        if rowptr[r] < rowptr[r + 1]:
            out[r] = part[rowptr[r]:rowptr[r + 1]].amax(0)
    return out.reshape(n_rows, d)


def bsr_sddmm_reference(block_rows: torch.Tensor, block_cols: torch.Tensor,
                        g: torch.Tensor, b: torch.Tensor,
                        compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``out[k] = g[rows of tile k] @ b[cols of tile k]ᵀ`` as two gathers and a
    ``bmm``; with ``compute_dtype`` (bf16) on the rounded g and b, in float32."""
    compute_dtype = compute_dtype_of("bsr_sddmm_reference", compute_dtype)
    d = g.shape[1]
    g3 = _rounded(g, compute_dtype).reshape(-1, BLOCK, d)
    b3 = _rounded(b, compute_dtype).reshape(-1, BLOCK, d)
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


def _pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` zero-padded to ``n`` rows, contiguous; no copy when it is both."""
    if t.shape[0] != n:
        t = F.pad(t, (0, 0) * (t.dim() - 1) + (0, n - t.shape[0]))
    return t.contiguous()


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
    return _pad_rows(er, n_rows), _pad_rows(el, n_cols), _pad_rows(h, n_cols)


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
    return [_pad_rows(t, n_rows) for t in (g, out, m, l)]


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


def _check_cuda_args(name: str, floats, ints, dtype: torch.dtype = torch.float32):
    """What a kernel reads: ``floats`` in ``dtype`` (float32, or bf16 for the
    operands of the bf16 kernels), ``ints`` int32, all contiguous."""
    for t in floats:
        if t.dtype != dtype:
            kind = "float32" if dtype == torch.float32 else str(dtype)
            raise TypeError(f"{name}: {kind} tensors only, got {t.dtype}")
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


def _streamed(t: torch.Tensor, dtype: torch.dtype, multiple: int) -> torch.Tensor:
    """``t`` in ``dtype``, its columns zero-padded to a multiple of
    ``multiple``, contiguous and 16-byte aligned, so that the kernels copy its
    rows in 16-byte pieces; ``t`` itself when it is all that already."""
    t = t.to(dtype)
    if t.shape[1] % multiple:
        t = F.pad(t, (0, -t.shape[1] % multiple))
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def bsr_spmm(bsr: BSRMatrix, b: torch.Tensor, *, compute_dtype=None) -> torch.Tensor:
    """``out = A @ B`` with A in BSR form and B (n_cols_padded, d) float32;
    returns (n_rows_padded, d) float32 (counterpart: pallas_kernels.py:101).

    Any ``d`` is taken; the kernel masks the ragged feature slab itself. On
    the card it runs the work items of :func:`device_schedule` (kept on the
    matrix) and needs a (slots, 128, d) float32 scratch buffer for the
    partial sums of split block-rows, allocated here.

    ``compute_dtype=torch.bfloat16`` streams the tiles (:func:`bsr_compute_tiles`,
    kept on the matrix) and B (cast at every call, its columns padded to a
    multiple of 8) in bf16 and sums in float32; float32 is ``None``."""
    n_rows, n_cols = bsr.shape
    if b.dim() != 2 or b.shape[0] != n_cols:
        raise ValueError(f"bsr_spmm: b must be ({n_cols}, d), got {tuple(b.shape)}")
    compute_dtype = compute_dtype_of("bsr_spmm", compute_dtype)
    if _on_cpu(bsr.tiles, bsr.block_cols, bsr.rowptr, b):
        return bsr_spmm_reference(bsr, b, compute_dtype)
    _check_tiling("bsr_spmm", bsr)
    _check_cuda_args("bsr_spmm", (bsr.tiles, b), (bsr.block_cols, bsr.rowptr))
    d = b.shape[1]
    out = torch.empty((n_rows, d), dtype=torch.float32, device=b.device)
    if n_rows == 0 or d == 0:
        return out
    kernel = "spmm" if compute_dtype is None else "spmm_bf16"
    sched = device_schedule(bsr, kernel, d, b.device)
    scratch = torch.empty((sched.schedule.n_slots, BLOCK, d), dtype=torch.float32,
                          device=b.device)
    items = (sched.items.data_ptr(), sched.items.shape[0], sched.rows.data_ptr(),
             sched.rows.shape[0])
    if compute_dtype is None:
        _launch("dtt_bsr_spmm_f32", b.device, bsr.tiles.data_ptr(), bsr.block_cols.data_ptr(),
                *items, b.data_ptr(), out.data_ptr(), scratch.data_ptr(), d)
    else:
        tiles, bq = bsr_compute_tiles(bsr, compute_dtype), _streamed(b, compute_dtype, 8)
        _check_cuda_args("bsr_spmm", (tiles, bq), (), dtype=compute_dtype)
        _launch("dtt_bsr_spmm_bf16", b.device, tiles.data_ptr(), bsr.block_cols.data_ptr(),
                *items, bq.data_ptr(), out.data_ptr(), scratch.data_ptr(), d, bq.shape[1])
        bsr_spmm.launches_bf16 += 1
    bsr_spmm.launches += 1
    return out


bsr_spmm.launches = 0       # every launch of #1
bsr_spmm.launches_bf16 = 0  # the bf16 ones among them


def bsr_sddmm(block_rows: torch.Tensor, block_cols: torch.Tensor, g: torch.Tensor,
              b: torch.Tensor, *, compute_dtype=None) -> torch.Tensor:
    """``out[k] = g[rows_k] @ b[cols_k]ᵀ`` for each nonzero tile k: the dA term
    of the SpMM backward (counterpart: pallas_kernels.py:159). ``g`` is
    (n_rows_padded, d), ``b`` (n_cols_padded, d), float32; returns (nb, 128,
    128) float32. ``compute_dtype=torch.bfloat16`` rounds g and b to bf16
    and sums in float32.

    On the card g and b are copied only where the kernel needs it: cast to
    bf16, or their columns zero-padded to a multiple of 4 (float32) or 8
    (bf16) so that rows start on 16 bytes; zero columns add nothing."""
    if g.dim() != 2 or b.dim() != 2 or g.shape[1] != b.shape[1] \
            or g.shape[0] % BLOCK or b.shape[0] % BLOCK:
        raise ValueError(f"bsr_sddmm: g and b must be (n_padded, d) with the same d, "
                         f"got {tuple(g.shape)} and {tuple(b.shape)}")
    if block_rows.shape != block_cols.shape or block_rows.dim() != 1:
        raise ValueError("bsr_sddmm: block_rows and block_cols must be (nb,)")
    compute_dtype = compute_dtype_of("bsr_sddmm", compute_dtype)
    if _on_cpu(block_rows, block_cols, g, b):
        return bsr_sddmm_reference(block_rows, block_cols, g, b, compute_dtype)
    _check_cuda_args("bsr_sddmm", (g, b), (block_rows, block_cols))
    nb = block_rows.shape[0]
    out = torch.empty((nb, BLOCK, BLOCK), dtype=torch.float32, device=g.device)
    if nb == 0:
        return out
    dtype = torch.float32 if compute_dtype is None else compute_dtype
    multiple = 16 // dtype.itemsize
    gq, bq = _streamed(g, dtype, multiple), _streamed(b, dtype, multiple)
    _check_cuda_args("bsr_sddmm", (gq, bq), (), dtype=dtype)
    _launch("dtt_bsr_sddmm_f32" if compute_dtype is None else "dtt_bsr_sddmm_bf16", g.device,
            gq.data_ptr(), bq.data_ptr(), block_rows.data_ptr(), block_cols.data_ptr(),
            out.data_ptr(), nb, gq.shape[1])
    bsr_sddmm.launches += 1
    if compute_dtype is not None:
        bsr_sddmm.launches_bf16 += 1
    return out


bsr_sddmm.launches = 0       # every launch of #2
bsr_sddmm.launches_bf16 = 0  # the bf16 ones among them


def _gat_forward(name: str, bsr: BSRMatrix, er, el, h, negative_slope: float, act: str,
                 stats: bool):
    erp, elp, hp = _gat_inputs(name, bsr, er, el, h, act)
    if _on_cpu(bsr.tiles, bsr.block_cols, bsr.rowptr, erp, elp, hp):
        return bsr_gat_reference(bsr, erp, elp, hp, negative_slope=negative_slope, act=act,
                                 return_stats=stats)
    _check_tiling(name, bsr)
    _check_cuda_args(name, (bsr.tiles, erp, elp, hp), (bsr.block_cols, bsr.rowptr))
    if elp.data_ptr() % 16:  # the kernel copies el in 16-byte pieces
        elp = elp.clone()
    n_rows, d, dev = bsr.shape[0], hp.shape[1], hp.device
    sched = device_schedule(bsr, "gat", d, dev)
    n_slots = sched.schedule.n_slots
    mask = bsr_edge_mask(bsr)
    out = torch.empty((n_rows, d), dtype=torch.float32, device=dev)
    m = torch.empty(n_rows, dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    part = torch.empty((n_slots, BLOCK, d), dtype=torch.float32, device=dev)
    part_m = torch.empty((n_slots, BLOCK), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    ptrs = [mask.data_ptr(), bsr.block_cols.data_ptr(), sched.items.data_ptr(),
            sched.items.shape[0], sched.rows.data_ptr(), sched.rows.shape[0], erp.data_ptr(),
            elp.data_ptr(), hp.data_ptr(), out.data_ptr()]
    if stats:
        ptrs += [m.data_ptr(), l.data_ptr()]
    _launch("dtt_bsr_gat_stats_f32" if stats else "dtt_bsr_gat_f32", dev, *ptrs,
            part.data_ptr(), part_m.data_ptr(), part_l.data_ptr(), d, GAT_ACTS[act],
            negative_slope)
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

    The CUDA kernel walks the edge lists of :func:`bsr_edges` (kept on the
    matrix): by row for ``da`` and ``der``, then by column for ``del`` and
    ``dh``, each sum in edge order and without atomics, so its result is the
    same on every run. It needs ``da`` and ``p`` per edge and a mark per row
    and column (non-finite or huge values, which can make the plain
    version's off-edge terms NaN), allocated here."""
    n_er, n_el, n_src = er.shape[0], el.shape[0], h.shape[0]
    erp, elp, hp = _gat_inputs("bsr_gat_grads", bsr, er, el, h, act)
    gp, outp, mp, lp = _gat_grad_inputs(bsr, g, out, m, l)
    if _on_cpu(bsr.tiles, bsr.block_rows, bsr.block_cols, erp, elp, hp, gp, outp, mp, lp):
        return bsr_gat_grads_reference(bsr, er, el, h, g, out, m, l,
                                       negative_slope=negative_slope, act=act)
    _check_tiling("bsr_gat_grads", bsr)
    n_rows, n_cols = bsr.shape
    d, dev = hp.shape[1], hp.device
    if gp.shape[1] != d or outp.shape[1] != d:
        raise ValueError(f"bsr_gat_grads: g and out must have d = {d} columns")
    edges = bsr_edges(bsr)
    _check_cuda_args("bsr_gat_grads", (bsr.tiles, erp, elp, hp, gp, outp, mp, lp),
                     (bsr.block_rows, bsr.block_cols, edges.rowptr, edges.cols, edges.rows,
                      edges.colptr, edges.colperm))
    r = (gp * outp).sum(1)  # r_i = ḡ_i·out_i, outside the kernel as in JAX (:528)
    per_edge = torch.empty((2, edges.nnz), dtype=torch.float32, device=dev)  # da, p
    marks = torch.empty(1 + n_rows + n_cols, dtype=torch.int32, device=dev)
    der = torch.empty(n_rows, dtype=torch.float32, device=dev)
    del_ = torch.empty(n_cols, dtype=torch.float32, device=dev)
    dh = torch.empty((n_cols, d), dtype=torch.float32, device=dev)
    _launch("dtt_bsr_gat_grads_f32", dev, bsr.tiles.data_ptr(), bsr.block_rows.data_ptr(),
            bsr.block_cols.data_ptr(), edges.rowptr.data_ptr(), edges.cols.data_ptr(),
            edges.rows.data_ptr(), edges.colptr.data_ptr(), edges.colperm.data_ptr(),
            erp.data_ptr(), elp.data_ptr(), hp.data_ptr(), gp.data_ptr(), mp.data_ptr(),
            lp.data_ptr(), r.data_ptr(), per_edge.data_ptr(), marks.data_ptr(), der.data_ptr(),
            del_.data_ptr(), dh.data_ptr(), bsr.nb, edges.nnz, n_rows, n_cols, d,
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
    require grad (AdaptiveBSR's tiles are constants), both in the forward's
    ``compute_dtype`` as in JAX (:251-262). JAX takes dA from an einsum in
    float32 and from the SDDMM kernel only under a compute dtype; the port
    always takes it from the kernel."""

    @staticmethod
    def forward(ctx, tiles, b, bsr, compute_dtype):
        # ``tiles`` is ``bsr.tiles``, passed on its own so that autograd tracks it
        ctx.mat, ctx.compute_dtype = bsr, compute_dtype
        ctx.save_for_backward(b if tiles.requires_grad else None)
        return bsr_spmm(bsr, b, compute_dtype=compute_dtype)

    @staticmethod
    def backward(ctx, grad):
        (b,) = ctx.saved_tensors
        grad = grad.contiguous()
        mat, dtype = ctx.mat, ctx.compute_dtype
        d_tiles = d_b = None
        if ctx.needs_input_grad[0]:
            d_tiles = bsr_sddmm(mat.block_rows, mat.block_cols, grad, b, compute_dtype=dtype)
        if ctx.needs_input_grad[1]:
            d_b = bsr_spmm(bsr_transpose(mat), grad, compute_dtype=dtype)
        return d_tiles, d_b, None, None


def bsr_spmm_ad(bsr: BSRMatrix, b: torch.Tensor, *, compute_dtype=None) -> torch.Tensor:
    """Differentiable ``A @ B`` (counterpart: pallas_kernels.py:219). Gradients
    reach ``b`` and, where ``bsr.tiles`` requires grad, the tiles.
    ``compute_dtype=torch.bfloat16`` streams both directions in bf16 with
    float32 sums (:func:`bsr_spmm`, :func:`bsr_sddmm`)."""
    return BSRSpMM.apply(bsr.tiles, b, bsr, compute_dtype_of("bsr_spmm_ad", compute_dtype))


class BSRSpMMMax(torch.autograd.Function):
    """Forward-only max aggregation, as in JAX, which has no VJP for it
    (pallas_kernels.py:831-833). Its backward raises, on the CPU as on the
    card, so that no gradient is silently wrong or missing."""

    @staticmethod
    def forward(ctx, tiles, b, bsr, weighted):
        # ``tiles`` is ``bsr.tiles``, passed on its own so that autograd tracks it
        n_rows, n_cols = bsr.shape
        if b.dim() != 2 or b.shape[0] != n_cols:
            raise ValueError(f"bsr_spmm_max: b must be ({n_cols}, d), got {tuple(b.shape)}")
        if _on_cpu(bsr.tiles, bsr.block_cols, bsr.rowptr, b):
            return bsr_spmm_max_reference(bsr, b, weighted=weighted)
        _check_tiling("bsr_spmm_max", bsr)
        _check_cuda_args("bsr_spmm_max", (bsr.tiles, b), (bsr.block_cols, bsr.rowptr))
        d = b.shape[1]
        out = torch.empty((n_rows, d), dtype=torch.float32, device=b.device)
        if n_rows == 0 or d == 0:
            return out
        sched = device_schedule(bsr, "max", d, b.device)
        # the weighted form reads the tile rows (a_ij and the edges); the
        # unweighted one only the edge bits, 1/32 of the bytes
        edges = bsr.tiles if weighted else bsr_edge_mask(bsr)
        scratch = torch.empty((sched.schedule.n_slots, BLOCK, d), dtype=torch.float32,
                              device=b.device)
        _launch("dtt_bsr_spmm_max_f32", b.device, edges.data_ptr(), bsr.block_cols.data_ptr(),
                sched.items.data_ptr(), sched.items.shape[0], sched.rows.data_ptr(),
                sched.rows.shape[0], b.data_ptr(), out.data_ptr(), scratch.data_ptr(), d,
                int(weighted))
        bsr_spmm_max.launches += 1
        return out

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError("bsr_spmm_max (BSR max aggregation) is forward-only, as in the "
                           "JAX package: train max aggregation on the CSR adjacency")


def bsr_spmm_max(bsr: BSRMatrix, b: torch.Tensor, *, weighted: bool = True) -> torch.Tensor:
    """Max aggregation over the BSR nonzero pattern, ``out[i, k] = max_j
    a_ij * b[j, k]`` (``b[j, k]`` with ``weighted=False``), with ``b``
    (n_cols_padded, d) float32; returns (n_rows_padded, d) float32
    (counterpart: pallas_kernels.py:826). A zero slot means "no edge": rows
    without one give ``-inf``, and NaN propagates. Any ``d`` is taken. On the
    card it runs the work items of :func:`device_schedule` (kept on the
    matrix) and needs a (slots, 128, d) float32 scratch buffer for the
    partial maxima of split block-rows, allocated here.

    Runs through :class:`BSRSpMMMax`: where an input requires grad, so does
    the output, and its backward raises."""
    return BSRSpMMMax.apply(bsr.tiles, b, bsr, weighted)


bsr_spmm_max.launches = 0

__all__ = ["BLOCK", "BSREdges", "BSRGat", "BSRMatrix", "BSRSpMM", "BSRSpMMMax",
           "BipartiteBSR", "DENSE_MAX_BYTES", "DENSE_OCCUPANCY", "DENSE_THRESHOLD",
           "DeviceSchedule", "GAT_ACTS", "MAX_EXPANSION", "WorkSchedule",
           "bipartite_bsr", "bsr_edge_mask", "bsr_edges", "bsr_from_scipy", "bsr_gat",
           "bsr_gat_ad", "bsr_gat_grads", "bsr_gat_grads_reference",
           "bsr_compute_tiles", "bsr_gat_reference", "bsr_gat_stats", "bsr_like", "bsr_sddmm",
           "bsr_sddmm_reference", "bsr_spmm", "bsr_spmm_ad", "bsr_spmm_max",
           "bsr_spmm_max_reference", "bsr_spmm_reference", "bsr_transpose",
           "bsr_with_rcm", "choose_adj_format", "compute_dtype_of", "device_schedule",
           "launch_geometry",
           "rcm_reorder", "resolve_adj_format", "resolve_use_bsr", "tile_expansion", "unpermute",
           "work_schedule"]
