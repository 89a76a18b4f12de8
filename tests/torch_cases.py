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


def dense(bsr: tbsr.BSRMatrix) -> np.ndarray:
    out = np.zeros(bsr.shape, np.float64)
    blk = bsr.block
    for t, r, c in zip(bsr.tiles.numpy(), bsr.block_rows.numpy(), bsr.block_cols.numpy()):
        out[r * blk:(r + 1) * blk, c * blk:(c + 1) * blk] += t
    return out
