"""Shared inputs of the dance_tpu_torch tests; imports no JAX, so the card's
tests (test_torch_cuda.py) can use it where JAX is not installed."""

import numpy as np
import scipy.sparse as sp
import torch

from dance_tpu_torch.ops import bsr as tbsr


def _adj(n, m, density, seed, empty_rows=()):
    """Random sparse matrix; the listed row ranges are emptied so that whole
    block-rows have no tiles."""
    adj = sp.random(n, m, density=density, random_state=seed, format="lil",
                    dtype=np.float32)
    for lo, hi in empty_rows:
        adj[lo:hi] = 0
    return sp.csr_matrix(adj)


CASES = {
    "square_with_empty_block_rows": lambda: _adj(400, 400, 0.02, 0, [(128, 256)]),
    "rectangular": lambda: _adj(300, 200, 0.05, 1),
    "exact_blocks_dense": lambda: _adj(256, 384, 0.3, 2),
}


def no_pad(bsr: tbsr.BSRMatrix) -> tbsr.BSRMatrix:
    """The same matrix without the all-zero pad tiles bsr_from_scipy adds:
    the CUDA kernel must not need them."""
    keep = torch.nonzero(bsr.tiles.abs().sum(dim=(1, 2)) != 0).ravel()
    rows = bsr.block_rows[keep]
    return tbsr.BSRMatrix(bsr.tiles[keep].contiguous(), rows, bsr.block_cols[keep],
                          tbsr._rowptr(rows, bsr.shape[0] // bsr.block), bsr.shape)


# tiles of each block-row of skewed_bsr: one long row, short ones, empty ones
SKEWED_ROW_TILES = (2, 110, 0, 1, 2, 0, 1)


def skewed_bsr(seed: int = 0, n_bcols: int = 120) -> tbsr.BSRMatrix:
    """A tiling as skewed as a bipartite cell-gene graph's: one block-row of
    110 tiles, the others 0-2, and no pad tiles. Tiles are 10 % dense with
    standard-normal values; each row's block-columns are distinct and
    sorted."""
    rng = np.random.default_rng(seed)
    blk = tbsr.BLOCK
    rows = np.repeat(np.arange(len(SKEWED_ROW_TILES)), SKEWED_ROW_TILES)
    cols = np.concatenate([np.sort(rng.choice(n_bcols, n, replace=False))
                           for n in SKEWED_ROW_TILES])
    tiles = rng.standard_normal((len(rows), blk, blk)) * (rng.random((len(rows), blk, blk)) < 0.1)
    rows_t = torch.from_numpy(rows.astype(np.int32))
    return tbsr.BSRMatrix(torch.from_numpy(tiles.astype(np.float32)), rows_t,
                          torch.from_numpy(cols.astype(np.int32)),
                          tbsr._rowptr(rows_t, len(SKEWED_ROW_TILES)),
                          (len(SKEWED_ROW_TILES) * blk, n_bcols * blk))


def signed(adj: sp.csr_matrix) -> sp.csr_matrix:
    """Weights shifted to [-0.5, 0.5), zeros dropped: negative weights make a
    max aggregation's masking of empty slots matter."""
    adj = adj.copy()
    adj.data = adj.data - np.float32(0.5)
    adj.eliminate_zeros()
    return adj


def max_edge_case():
    """A 300 x 260 tiling with empty rows and a whole empty block-row, the
    pad tiles of bsr_from_scipy, a NaN weight, and NaN, +inf and -inf in the
    features: the max aggregation's edge semantics. Returns (bsr, h)."""
    rng = np.random.default_rng(7)
    adj = signed(_adj(300, 260, 0.05, 7, [(128, 256), (10, 12)]))
    adj = sp.lil_matrix(adj)
    adj[5, 3] = np.nan
    bsr = tbsr.bsr_from_scipy(sp.csr_matrix(adj))
    h = rng.standard_normal((bsr.shape[1], 9)).astype(np.float32)
    h[7, 0], h[8, 1], h[9, 2] = np.nan, np.inf, -np.inf
    h[:, 3] = np.inf
    return bsr, torch.from_numpy(h)


def gat_inputs(bsr: tbsr.BSRMatrix, d: int, seed: int):
    """er, el, h and an output cotangent g for the GAT ops on ``bsr``, unpadded
    (er and g one row short of the tiling, el and h two short)."""
    rng = np.random.default_rng(seed)
    n_rows, n_cols = bsr.shape[0] - 1, bsr.shape[1] - 2
    return tuple(torch.from_numpy(a.astype(np.float32)) for a in (
        rng.normal(0, 1, n_rows), rng.normal(0, 1, n_cols),
        rng.standard_normal((n_cols, d)), rng.standard_normal((n_rows, d))))


def spatial_case(n: int, d: int, seed: int, k: int = 3):
    """Structured spatial data: ``k`` domains, each a cluster of spots and a
    gene profile; returns (features, radius graph, domain labels)."""
    from dance_tpu_torch.ops.neighbors import radius_graph

    rng = np.random.default_rng(seed)
    dom = rng.integers(0, k, n)
    xy = (rng.random((n, 2)) + dom[:, None] * 2).astype(np.float32)
    x = (np.eye(k)[dom] @ rng.random((k, d)) * 4 + rng.random((n, d))).astype(np.float32)
    return x, radius_graph(xy, 0.6), dom


def dense(bsr: tbsr.BSRMatrix) -> np.ndarray:
    out = np.zeros(bsr.shape, np.float64)
    blk = bsr.block
    for t, r, c in zip(bsr.tiles.numpy(), bsr.block_rows.numpy(), bsr.block_cols.numpy()):
        out[r * blk:(r + 1) * blk, c * blk:(c + 1) * blk] += t
    return out
