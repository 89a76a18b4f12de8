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
