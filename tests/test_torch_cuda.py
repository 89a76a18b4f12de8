"""dance_tpu_torch on the card: the hand-written CUDA kernels against their
plain PyTorch versions, and the scDeepSort and STAGATE fits on the card
against the CPU.

Every test here is marked ``cuda`` and skips where ``torch.cuda.is_available()``
is False. This file imports no JAX, so it runs on a machine with only
PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: float32 with TF32 off; kernel and plain version sum the same
terms in another order, so outputs agree at rtol 1e-5 (atol 1e-4 for sums
of ~100 products of unit normals). The GAT kernels use expf where the plain
version uses torch.exp (each within an ulp or two), so the same bounds hold.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dance_tpu_torch.graph import Graph
from dance_tpu_torch.modules.single_modality.cell_type_annotation import ScDeepSort
from dance_tpu_torch.modules.spatial.spatial_domain import Stagate
from dance_tpu_torch.ops import bsr as tbsr
from torch_cases import CASES, gat_inputs, no_pad, spatial_case

RTOL, ATOL = 1e-5, 1e-5

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run `python -m pytest -m cuda` on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [1, 100, 256])
@pytest.mark.parametrize("pad_tiles", [True, False])
def test_spmm_matches_plain(cuda, case, d, pad_tiles):
    bsr = tbsr.bsr_from_scipy(CASES[case]())
    bsr = bsr if pad_tiles else no_pad(bsr)
    b = torch.randn((bsr.shape[1], d), generator=torch.Generator().manual_seed(d))
    ref = tbsr.bsr_spmm_reference(bsr, b)
    n = tbsr.bsr_spmm.launches
    out = tbsr.bsr_spmm(bsr.to(cuda), b.to(cuda))
    torch.cuda.synchronize()
    assert tbsr.bsr_spmm.launches == n + 1
    torch.testing.assert_close(out.cpu(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d", [1, 96, 130, 256])
def test_sddmm_matches_plain(cuda, d):
    bsr = tbsr.bsr_from_scipy(CASES["square_with_empty_block_rows"]())
    g = torch.randn((bsr.shape[0], d), generator=torch.Generator().manual_seed(d))
    b = torch.randn((bsr.shape[1], d), generator=torch.Generator().manual_seed(d + 1))
    ref = tbsr.bsr_sddmm_reference(bsr.block_rows, bsr.block_cols, g, b)
    n = tbsr.bsr_sddmm.launches
    out = tbsr.bsr_sddmm(bsr.block_rows.to(cuda), bsr.block_cols.to(cuda), g.to(cuda),
                         b.to(cuda))
    torch.cuda.synchronize()
    assert tbsr.bsr_sddmm.launches == n + 1
    torch.testing.assert_close(out.cpu(), ref, rtol=RTOL, atol=1e-4)


def test_spmm_ad_grads_match_cpu(cuda):
    adj = CASES["rectangular"]()
    grads = []
    for device in (torch.device("cpu"), cuda):
        bsr = tbsr.bsr_from_scipy(adj).to(device)
        bsr.tiles.requires_grad_(True)
        b = torch.linspace(-1, 1, bsr.shape[1] * 40).reshape(-1, 40).to(device)
        b.requires_grad_(True)
        (tbsr.bsr_spmm_ad(bsr, b) ** 2).sum().backward()
        grads.append((b.grad.cpu(), bsr.tiles.grad.cpu()))
    for got, want in zip(grads[1], grads[0]):
        torch.testing.assert_close(got, want, rtol=RTOL, atol=1e-4)


def test_wrappers_reject_bad_inputs(cuda):
    bsr = tbsr.bsr_from_scipy(CASES["rectangular"]()).to(cuda)
    with pytest.raises(TypeError, match="float32"):
        tbsr.bsr_spmm(bsr, torch.zeros((bsr.shape[1], 4), device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        tbsr.bsr_spmm(bsr, torch.zeros((4, bsr.shape[1]), device=cuda).T)
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        tbsr.bsr_spmm(bsr, torch.zeros((bsr.shape[1], 4)))


def test_fit_matches_cpu(cuda):
    rng = np.random.default_rng(14)
    expr = sp.random(300, 140, density=0.1, random_state=14, dtype=np.float32, format="csr")
    graph = Graph.from_cell_feature_matrix(expr, rng.random((300, 32), dtype=np.float32),
                                           rng.random((140, 32), dtype=np.float32))
    labels = rng.integers(0, 5, 300)
    runs = []
    for device in (torch.device("cpu"), cuda):
        m = ScDeepSort(dim_in=32, dim_hid=64, num_layers=2, seed=0, device=device)
        n = tbsr.bsr_spmm.launches
        m.fit(graph, labels, epochs=3, lr=1e-2, use_bsr=True)
        runs.append(([h["loss"] for h in m.history], m.predict_proba(graph),
                     tbsr.bsr_spmm.launches - n))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-4)
    np.testing.assert_allclose(runs[1][1], runs[0][1], rtol=1e-4, atol=1e-5)
    assert runs[0][2] == 0 and runs[1][2] >= 4 * 3


@pytest.mark.parametrize("act", ["leaky_relu", "sigmoid"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [1, 10, 130, 512])
@pytest.mark.parametrize("pad_tiles", [True, False])
def test_gat_matches_plain(cuda, act, case, d, pad_tiles):
    bsr = tbsr.bsr_from_scipy(CASES[case]())
    bsr = bsr if pad_tiles else no_pad(bsr)
    er, el, h, _ = gat_inputs(bsr, d, seed=d)
    ref = tbsr.bsr_gat_reference(bsr, er, el, h, act=act, return_stats=True)
    n_gat, n_stats = tbsr.bsr_gat.launches, tbsr.bsr_gat_stats.launches
    dev = bsr.to(cuda)
    out = tbsr.bsr_gat(dev, er.to(cuda), el.to(cuda), h.to(cuda), act=act)
    stats = tbsr.bsr_gat_stats(dev, er.to(cuda), el.to(cuda), h.to(cuda), act=act)
    torch.cuda.synchronize()
    assert (tbsr.bsr_gat.launches, tbsr.bsr_gat_stats.launches) == (n_gat + 1, n_stats + 1)
    torch.testing.assert_close(out.cpu(), ref[0], rtol=RTOL, atol=ATOL)
    for got, want in zip(stats, ref):
        torch.testing.assert_close(got.cpu(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("act", ["leaky_relu", "sigmoid"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [1, 130, 512])
def test_gat_grads_match_plain(cuda, act, case, d):
    bsr = tbsr.bsr_from_scipy(CASES[case]())
    er, el, h, g = gat_inputs(bsr, d, seed=d)
    out, m, l = tbsr.bsr_gat_reference(bsr, er, el, h, act=act, return_stats=True)
    ref = tbsr.bsr_gat_grads_reference(bsr, er, el, h, g, out, m, l, act=act)
    n = tbsr.bsr_gat_grads.launches
    got = tbsr.bsr_gat_grads(bsr.to(cuda), *(t.to(cuda) for t in (er, el, h, g, out, m, l)),
                             act=act)
    torch.cuda.synchronize()
    assert tbsr.bsr_gat_grads.launches == n + 1
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.cpu(), b, rtol=RTOL, atol=1e-4)


def test_gat_grads_deterministic(cuda):
    bsr = tbsr.bsr_from_scipy(CASES["exact_blocks_dense"]()).to(cuda)
    er, el, h, g = (t.to(cuda) for t in gat_inputs(bsr, 512, seed=3))
    out, m, l = tbsr.bsr_gat_stats(bsr, er, el, h, act="sigmoid")
    runs = [tbsr.bsr_gat_grads(bsr, er, el, h, g, out, m, l, act="sigmoid") for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_gat_ad_grads_match_cpu(cuda):
    bsr = tbsr.bsr_from_scipy(CASES["square_with_empty_block_rows"]())
    grads = []
    for device in (torch.device("cpu"), cuda):
        er, el, h, w = (t.to(device).requires_grad_(i < 3)
                        for i, t in enumerate(gat_inputs(bsr, 64, seed=5)))
        out = tbsr.bsr_gat_ad(bsr.to(device), er, el, h, act="sigmoid")
        (out[:w.shape[0]] * w).sum().backward()
        grads.append([t.grad.cpu() for t in (er, el, h)])
    for got, want in zip(grads[1], grads[0]):
        torch.testing.assert_close(got, want, rtol=RTOL, atol=1e-4)


def test_gat_wrappers_reject_bad_inputs(cuda):
    bsr = tbsr.bsr_from_scipy(CASES["rectangular"]()).to(cuda)
    er, el, h, _ = (t.to(cuda) for t in gat_inputs(bsr, 8, seed=0))
    with pytest.raises(ValueError, match="act must be"):
        tbsr.bsr_gat(bsr, er, el, h, act="relu")
    with pytest.raises(TypeError, match="float32"):
        tbsr.bsr_gat(bsr, er, el, h.double())
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        tbsr.bsr_gat_stats(bsr, er, el, h.cpu())


@pytest.mark.parametrize("use_bsr", [True, False])
def test_stagate_fit_matches_cpu(cuda, use_bsr):
    x, adj, _ = spatial_case(n=300, d=40, seed=2)
    runs = []
    for device in (torch.device("cpu"), cuda):
        counts = [f.launches for f in (tbsr.bsr_gat, tbsr.bsr_gat_stats, tbsr.bsr_gat_grads)]
        m = Stagate(hidden_dims=(40, 32, 8), device=device, seed=0)
        m.fit((x, adj), epochs=5, use_bsr=use_bsr)
        runs.append(([h["loss"] for h in m.history], m.z,
                     [f.launches - c for f, c in zip(
                         (tbsr.bsr_gat, tbsr.bsr_gat_stats, tbsr.bsr_gat_grads), counts)]))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-4)
    np.testing.assert_allclose(runs[1][1], runs[0][1], rtol=1e-4, atol=1e-4)
    assert runs[0][2] == [0, 0, 0]
    assert runs[1][2] == ([2, 10, 10] if use_bsr else [0, 0, 0])
