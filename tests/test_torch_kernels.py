"""Port parity for the BSR SpMM/SDDMM kernels (dance_tpu_torch.ops.bsr).

The JAX side runs the Pallas kernels as tests/test_gnn.py does on the CPU (in
interpret mode). Inputs are made with numpy from a seed and handed to both
packages. Here the wrappers run their plain PyTorch versions; the CUDA
kernels are held against those on the card in test_torch_cuda.py.

Tolerances: float32 throughout. Tiling and index arrays are compared
bit-exactly; products are compared at rtol 1e-5 (the two sides sum the same
terms in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dance_tpu.ops import pallas_kernels as jpk
from dance_tpu_torch.ops import bsr as tbsr
from torch_cases import CASES, dense, no_pad

RTOL, ATOL = 1e-5, 1e-5


@pytest.mark.parametrize("case", sorted(CASES))
def test_bsr_from_scipy_matches_jax(case):
    adj = CASES[case]()
    j = jpk.bsr_from_scipy(adj)
    t = tbsr.bsr_from_scipy(adj)
    assert t.shape == j.shape
    np.testing.assert_array_equal(t.tiles.numpy(), np.asarray(j.blocks))
    np.testing.assert_array_equal(t.block_rows.numpy(), np.asarray(j.block_rows))
    np.testing.assert_array_equal(t.block_cols.numpy(), np.asarray(j.block_cols))
    brows = np.asarray(j.block_rows)
    n_brows = j.shape[0] // jpk.BLOCK
    expect = np.concatenate([[0], np.cumsum(np.bincount(brows, minlength=n_brows))])
    np.testing.assert_array_equal(t.rowptr.numpy(), expect)
    assert t.block_rows.dtype == t.block_cols.dtype == t.rowptr.dtype == torch.int32


@pytest.mark.parametrize("case", sorted(CASES))
def test_bsr_transpose_matches_jax(case):
    adj = CASES[case]()
    jt = jpk.bsr_transpose(jpk.bsr_from_scipy(adj))
    bsr = tbsr.bsr_from_scipy(adj)
    tt = tbsr.bsr_transpose(bsr)
    assert tt.shape == jt.shape
    np.testing.assert_array_equal(tt.tiles.numpy(), np.asarray(jt.blocks))
    np.testing.assert_array_equal(tt.block_rows.numpy(), np.asarray(jt.block_rows))
    np.testing.assert_array_equal(tt.block_cols.numpy(), np.asarray(jt.block_cols))
    np.testing.assert_array_equal(tt.rowptr.numpy(), tbsr._rowptr(tt.block_rows,
                                                                  tt.shape[0] // 128).numpy())
    np.testing.assert_array_equal(dense(tt), dense(bsr).T)
    # constant tiles: computed once and kept
    assert tbsr.bsr_transpose(bsr) is tt


def test_bsr_transpose_not_kept_for_trainable_tiles():
    bsr = tbsr.bsr_from_scipy(CASES["rectangular"]())
    bsr.tiles.requires_grad_(True)
    assert tbsr.bsr_transpose(bsr) is not tbsr.bsr_transpose(bsr)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [16, 100, 140])
def test_spmm_reference_matches_jax(case, d):
    adj = CASES[case]()
    rng = np.random.default_rng(d)
    bsr = tbsr.bsr_from_scipy(adj)
    b = rng.standard_normal((bsr.shape[1], d)).astype(np.float32)
    ref = np.asarray(jpk.bsr_spmm(jpk.bsr_from_scipy(adj), jnp.asarray(b)))
    out = tbsr.bsr_spmm_reference(bsr, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    # the plain version needs no pad tiles: empty block-rows come out zero
    out_np = tbsr.bsr_spmm_reference(no_pad(bsr), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(out_np, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out[:adj.shape[0]], adj @ b[:adj.shape[1]], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("d", [96, 130])
def test_sddmm_reference_matches_jax(d):
    adj = CASES["square_with_empty_block_rows"]()
    rng = np.random.default_rng(d)
    bsr = tbsr.bsr_from_scipy(adj)
    g = rng.standard_normal((bsr.shape[0], d)).astype(np.float32)
    b = rng.standard_normal((bsr.shape[1], d)).astype(np.float32)
    jb = jpk.bsr_from_scipy(adj)
    ref = np.asarray(jpk.bsr_sddmm(jb.block_rows, jb.block_cols, jnp.asarray(g),
                                   jnp.asarray(b)))
    out = tbsr.bsr_sddmm_reference(bsr.block_rows, bsr.block_cols, torch.from_numpy(g),
                                   torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("trainable_tiles", [False, True])
def test_spmm_ad_grads_match_jax(trainable_tiles):
    adj = CASES["rectangular"]()
    rng = np.random.default_rng(7)
    bsr = tbsr.bsr_from_scipy(adj)
    b = rng.standard_normal((bsr.shape[1], 40)).astype(np.float32)
    w = rng.standard_normal((bsr.shape[0], 40)).astype(np.float32)
    jb = jpk.bsr_from_scipy(adj)

    def jloss(blocks, bb):
        m = jpk.BSRMatrix(blocks, jb.block_rows, jb.block_cols, jb.shape)
        return jnp.sum(jpk.bsr_spmm_ad(m, bb) * w)

    jd_tiles, jd_b = jax.grad(jloss, argnums=(0, 1))(jb.blocks, jnp.asarray(b))

    tb = torch.from_numpy(b).requires_grad_(True)
    if trainable_tiles:
        bsr.tiles.requires_grad_(True)
    loss = (tbsr.bsr_spmm_ad(bsr, tb) * torch.from_numpy(w)).sum()
    loss.backward()
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jd_b), rtol=RTOL, atol=1e-4)
    if trainable_tiles:
        np.testing.assert_allclose(bsr.tiles.grad.numpy(), np.asarray(jd_tiles),
                                   rtol=RTOL, atol=1e-4)
    else:
        assert bsr.tiles.grad is None


def test_spmm_ad_skips_sddmm_for_constant_tiles(monkeypatch):
    def fail(*_):
        raise AssertionError("dA computed for constant tiles")

    monkeypatch.setattr(tbsr, "bsr_sddmm", fail)
    bsr = tbsr.bsr_from_scipy(CASES["rectangular"]())
    b = torch.ones((bsr.shape[1], 8), requires_grad=True)
    tbsr.bsr_spmm_ad(bsr, b).sum().backward()
    assert b.grad.shape == b.shape


def test_cpu_wrappers_run_plain_version_and_count_nothing():
    bsr = tbsr.bsr_from_scipy(CASES["rectangular"]())
    b = torch.randn((bsr.shape[1], 24), generator=torch.Generator().manual_seed(0))
    g = torch.randn((bsr.shape[0], 24), generator=torch.Generator().manual_seed(1))
    n_spmm, n_sddmm = tbsr.bsr_spmm.launches, tbsr.bsr_sddmm.launches
    torch.testing.assert_close(tbsr.bsr_spmm(bsr, b), tbsr.bsr_spmm_reference(bsr, b),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        tbsr.bsr_sddmm(bsr.block_rows, bsr.block_cols, g, b),
        tbsr.bsr_sddmm_reference(bsr.block_rows, bsr.block_cols, g, b), rtol=0, atol=0)
    assert (tbsr.bsr_spmm.launches, tbsr.bsr_sddmm.launches) == (n_spmm, n_sddmm)


def test_wrappers_reject_bad_inputs():
    bsr = tbsr.bsr_from_scipy(CASES["rectangular"]())
    with pytest.raises(ValueError, match="must be"):
        tbsr.bsr_spmm(bsr, torch.zeros((bsr.shape[1] + 1, 4)))
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        tbsr.bsr_spmm(bsr, torch.zeros((bsr.shape[1], 4), device="meta"))
    with pytest.raises(ValueError, match="same d"):
        tbsr.bsr_sddmm(bsr.block_rows, bsr.block_cols, torch.zeros((bsr.shape[0], 4)),
                       torch.zeros((bsr.shape[1], 5)))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from dance_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(tmp_path / "build")
    assert not (tmp_path / "build").exists()


def test_build_key_covers_every_kernel_source():
    from dance_tpu_torch.ops import _build

    assert {p.name for p in _build.sources()} == {"bsr_spmm.cu", "bsr_sddmm.cu", "bsr_gat.cu",
                                                  "bsr_gat_bwd.cu"}
    text = "".join(p.read_text() for p in _build.sources())
    for symbol in _build.SIGNATURES:
        assert f'extern "C" int {symbol}(' in text
    assert len(_build.source_hash()) == 16


def test_unpermute_matches_jax():
    rng = np.random.default_rng(0)
    perm = rng.permutation(10)
    arr = rng.standard_normal((10, 3))
    np.testing.assert_array_equal(tbsr.unpermute(perm, arr), jpk.unpermute(perm, arr))
    assert tbsr.unpermute(None, arr) is arr

