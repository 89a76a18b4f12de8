"""The values kept on a ``BSRMatrix`` follow its tensors: the transpose, the
edge bits, the edge lists and the work schedules are built again after the
tiles (or ``rowptr``) are replaced or edited in place
(dance_tpu_torch/ops/bsr.py, ``_drop_stale``).

JAX arrays are immutable, so the JAX package cannot meet this case; the
check is against the dense product on the CPU plain versions, exactly (the
tiles are doubled, so every product doubles without rounding).
"""

import numpy as np
import scipy.sparse as sp
import torch

from dance_tpu_torch.ops import bsr as tbsr
from torch_cases import dense


def _tiling(n=200, seed=0):
    adj = sp.random(n, n, density=0.05, random_state=seed, format="csr", dtype=np.float32)
    return tbsr.bsr_from_scipy(adj)


def _grad_b(bsr, g):
    b = torch.linspace(-1, 1, bsr.shape[1] * g.shape[1]).reshape(-1, g.shape[1])
    b.requires_grad_(True)
    (tbsr.bsr_spmm_ad(bsr, b) * g).sum().backward()
    return b.grad


def test_spmm_ad_grad_follows_in_place_tile_edit():
    """Forward and backward, then ``tiles.mul_(2)``: the second ``dB = Aᵀḡ``
    is twice the first, not the first again from a kept transpose."""
    bsr = _tiling()
    g = torch.randn((bsr.shape[0], 16), generator=torch.Generator().manual_seed(0))
    first = _grad_b(bsr, g)
    np.testing.assert_allclose(first.numpy(), dense(bsr).T @ g.numpy().astype(np.float64),
                               rtol=1e-5, atol=1e-5)
    bsr.tiles.mul_(2.0)
    second = _grad_b(bsr, g)
    assert torch.equal(second, 2 * first)
    # a replaced tile tensor is followed too
    bsr.tiles = bsr.tiles / 2
    assert torch.equal(_grad_b(bsr, g), first)


def test_transpose_edge_bits_and_edge_lists_follow_in_place_edits():
    bsr = _tiling(seed=1)
    kept = (tbsr.bsr_transpose(bsr), tbsr.bsr_edge_mask(bsr), tbsr.bsr_edges(bsr))
    assert tbsr.bsr_transpose(bsr) is kept[0] and tbsr.bsr_edge_mask(bsr) is kept[1] \
        and tbsr.bsr_edges(bsr) is kept[2]
    t, i, j = (int(v[0]) for v in torch.nonzero(bsr.tiles, as_tuple=True))
    bsr.tiles[t, i, j] = 0.0        # one edge gone
    bsr.tiles[t, i, (j + 1) % 128] = 3.0  # and maybe one more
    fresh = tbsr.bsr_from_scipy(sp.csr_matrix(dense(bsr).astype(np.float32)))
    at = tbsr.bsr_transpose(bsr)
    assert at is not kept[0]
    np.testing.assert_array_equal(dense(at), dense(bsr).T)
    mask = tbsr.bsr_edge_mask(bsr)
    assert not torch.equal(mask, kept[1])
    ref = tbsr.bsr_edge_mask(tbsr.BSRMatrix(bsr.tiles.clone(), bsr.block_rows, bsr.block_cols,
                                            bsr.rowptr, bsr.shape))
    assert torch.equal(mask, ref)
    edges, want = tbsr.bsr_edges(bsr), tbsr.bsr_edges(fresh)
    assert edges is not kept[2]
    for name in ("rowptr", "cols", "rows", "colptr", "colperm"):
        assert torch.equal(getattr(edges, name), getattr(want, name)), name
    # an edit of the block columns (the tiles' places) is followed as well
    bsr.block_cols.copy_(bsr.block_cols)
    assert tbsr.bsr_transpose(bsr) is not at


def test_work_schedule_follows_rowptr(monkeypatch):
    geometry = {"blocks_per_sm": 2, "sms": 4, "blocks_per_item": 1}
    monkeypatch.setattr(tbsr, "launch_geometry", lambda kernel, d, index: geometry)
    bsr = _tiling(seed=2)
    cpu = torch.device("cpu")
    first = tbsr.device_schedule(bsr, "spmm", 8, cpu)
    assert tbsr.device_schedule(bsr, "spmm", 8, cpu) is first
    bsr.tiles.mul_(2.0)  # the schedule depends on rowptr only
    assert tbsr.device_schedule(bsr, "spmm", 8, cpu) is first
    bsr.rowptr.add_(0)
    second = tbsr.device_schedule(bsr, "spmm", 8, cpu)
    assert second is not first
    np.testing.assert_array_equal(second.schedule.items, first.schedule.items)


def test_trainable_tiles_keep_nothing():
    bsr = _tiling(seed=3)
    bsr.tiles.requires_grad_(True)
    tbsr.bsr_transpose(bsr)
    assert bsr._transpose is None and bsr._edges is None
