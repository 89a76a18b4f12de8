"""dance_tpu_torch on the card: the hand-written CUDA kernels against their
plain PyTorch versions, the scDeepSort, STAGATE, graph-sc, scTAG, scDSC,
scMoGNN, DSTG and stdGCN fits on the card against the CPU, scHeteroNet's
hop tilings and HetConv steps, the dense single-modality models
(ACTINN, scDeepCluster, scDCC, DeepImpute) and optax's AMSGrad, the scanpy
surface, ScTransform, GCNConv, the atlas similarity's metrics and the
vmapped sweep on the card against the CPU.

Every test here is marked ``cuda`` and skips where ``torch.cuda.is_available()``
is False. This file imports no JAX, so it runs on a machine with only
PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: float32 with TF32 off; the SpMM and GAT kernels take their
products on the tensor cores in 3xTF32, within float32's own rounding of the
IEEE products (tests/test_torch_schedule.py), and sum the same terms in
another order, so outputs agree at rtol 1e-5 (atol 1e-4 for sums of ~100 to
~1,400 products of unit normals). The GAT kernels use expf where the plain
version uses torch.exp (each within an ulp or two), so the same bounds hold.
The GAT backward walks the edges (dot products by warp reductions, sums in
edge order), so it sums in another order still: atol 1e-4 as before. The
BSR max kernel and its plain version take the max of the same float32
products, so they agree exactly (NaN where either has NaN). The bf16 SpMM
and SDDMM (``compute_dtype``) are held against the plain versions on the
same rounded operands, whose products are exact in float32: the same
bounds hold.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dance_tpu_torch.graph import Graph
from dance_tpu_torch.modules.single_modality.cell_type_annotation import ScDeepSort
from dance_tpu_torch.modules.spatial.spatial_domain import Stagate
from dance_tpu_torch.ops import bsr as tbsr
from torch_cases import (CASES, NONFINITE_WIDTHS, assert_weights, bipartite_case, cell_knn_bsr,
                         deconvo_case, deconvo_tilings, gat_inputs, gat_nonfinite_case,
                         heteronet_hops, knn_bsr, max_edge_case, nb_counts, no_pad, signed,
                         skewed_bsr, spatial_case, typed_counts)

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


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("d", [1, 8, 200, 257, 512])
def test_spmm_skewed_matches_plain_and_repeats_bit_equal(cuda, d, transposed):
    """One block-row of 110 tiles (cut into chunks whose partial sums a
    second pass adds), the others 0-2 tiles, empty block-rows, no pad tiles;
    transposed, 120 block-rows of 0-2 tiles."""
    bsr = skewed_bsr(seed=d)
    bsr = tbsr.bsr_transpose(bsr) if transposed else bsr
    b = torch.randn((bsr.shape[1], d), generator=torch.Generator().manual_seed(d))
    ref = tbsr.bsr_spmm_reference(bsr, b)
    dev, bd = bsr.to(cuda), b.to(cuda)
    n = tbsr.bsr_spmm.launches
    runs = [tbsr.bsr_spmm(dev, bd) for _ in range(2)]
    torch.cuda.synchronize()
    assert tbsr.bsr_spmm.launches == n + 2
    assert torch.equal(runs[0], runs[1])
    torch.testing.assert_close(runs[0].cpu(), ref, rtol=RTOL, atol=1e-4)


def test_spmm_nonfinite_inputs_match_plain(cuda):
    """±inf and NaN in B, over a tiling with pad tiles and empty rows: the
    3xTF32 product gives what the float32 product gives (0 * inf = NaN).
    Finite values within half a TF32 ulp of FLT_MAX, which round to ±inf,
    stay finite."""
    bsr = tbsr.bsr_from_scipy(CASES["square_with_empty_block_rows"]())
    b = torch.randn((bsr.shape[1], 40), generator=torch.Generator().manual_seed(4))
    b[3, 0], b[130, 1], b[5, 2] = torch.inf, -torch.inf, torch.nan
    b[:, 3] = torch.inf
    b[7, 4] = 3e38
    b.view(torch.int32)[9, 5] = 0x7FFFFFFF  # the card's own NaN: a full payload
    b[11, 6], b[20, 7] = 3.4028e38, -torch.finfo(torch.float32).max
    ref = tbsr.bsr_spmm_reference(bsr, b)
    out = tbsr.bsr_spmm(bsr.to(cuda), b.to(cuda)).cpu()
    assert torch.isinf(ref).any() and torch.isnan(ref).any()
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=1e-4, equal_nan=True)


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


def _edge_tilings():
    tilings = {"knn": lambda: knn_bsr(), "skewed": lambda: skewed_bsr(seed=5)}
    tilings.update({case: (lambda make=make: tbsr.bsr_from_scipy(make()))
                    for case, make in CASES.items()})
    return tilings


EDGE_TILINGS = _edge_tilings()


@pytest.mark.parametrize("act", ["leaky_relu", "sigmoid"])
@pytest.mark.parametrize("case", sorted(EDGE_TILINGS))
@pytest.mark.parametrize("d", [1, 30, 130, 512, 513])
def test_gat_grads_match_plain(cuda, act, case, d):
    """The dense cases, a kNN tiling of ~1 % density and the skewed one, at
    widths within one lane's columns (1, 30), one register chunk (130, 512)
    and past it (513)."""
    bsr = EDGE_TILINGS[case]()
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


@pytest.mark.parametrize("act", ["leaky_relu", "sigmoid"])
@pytest.mark.parametrize("d", [1, 8, 200, 257, 512])
def test_gat_skewed_matches_plain_and_repeats_bit_equal(cuda, act, d):
    bsr = skewed_bsr(seed=d)
    er, el, h, _ = gat_inputs(bsr, d, seed=d)
    ref = tbsr.bsr_gat_reference(bsr, er, el, h, act=act, return_stats=True)
    dev = bsr.to(cuda)
    args = [t.to(cuda) for t in (er, el, h)]
    n_gat, n_stats = tbsr.bsr_gat.launches, tbsr.bsr_gat_stats.launches
    outs = [tbsr.bsr_gat(dev, *args, act=act) for _ in range(2)]
    stats = [tbsr.bsr_gat_stats(dev, *args, act=act) for _ in range(2)]
    torch.cuda.synchronize()
    assert (tbsr.bsr_gat.launches, tbsr.bsr_gat_stats.launches) == (n_gat + 2, n_stats + 2)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], stats[0][0])
    assert all(torch.equal(a, b) for a, b in zip(*stats))
    torch.testing.assert_close(outs[0].cpu(), ref[0], rtol=RTOL, atol=ATOL)
    for got, want in zip(stats[0], ref):
        torch.testing.assert_close(got.cpu(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("act", ["leaky_relu", "sigmoid"])
def test_gat_nonfinite_features_match_plain(cuda, act):
    bsr = tbsr.bsr_from_scipy(CASES["square_with_empty_block_rows"]())
    er, el, h, _ = gat_inputs(bsr, 40, seed=4)
    h[3, 0], h[130, 1], h[5, 2] = torch.inf, -torch.inf, torch.nan
    h[:, 3] = torch.inf
    h.view(torch.int32)[9, 4] = 0x7FFFFFFF  # the card's own NaN: a full payload
    h[11, 5], h[20, 6] = 3.4028e38, -torch.finfo(torch.float32).max  # round past FLT_MAX
    ref = tbsr.bsr_gat_reference(bsr, er, el, h, act=act, return_stats=True)
    got = tbsr.bsr_gat_stats(bsr.to(cuda), er.to(cuda), el.to(cuda), h.to(cuda), act=act)
    assert torch.isnan(ref[0]).any()
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.cpu(), b, rtol=RTOL, atol=ATOL, equal_nan=True)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def test_gat_grads_deterministic(cuda):
    """Two runs give equal bits: both activations, a dense tiling and a
    kNN one of ~1 % density."""
    for tiling in (tbsr.bsr_from_scipy(CASES["exact_blocks_dense"]()), knn_bsr()):
        bsr = tiling.to(cuda)
        er, el, h, g = (t.to(cuda) for t in gat_inputs(bsr, 512, seed=3))
        for act in ("sigmoid", "leaky_relu"):
            out, m, l = tbsr.bsr_gat_stats(bsr, er, el, h, act=act)
            runs = [tbsr.bsr_gat_grads(bsr, er, el, h, g, out, m, l, act=act) for _ in range(2)]
            for a, b in zip(*runs):
                assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("act", ["leaky_relu", "sigmoid"])
@pytest.mark.parametrize("d", NONFINITE_WIDTHS)
def test_gat_grads_nonfinite_inputs_match_plain(cuda, d, act):
    """±inf, NaN, 0x7fffffff and ±3.4e38 in h and ḡ, some in rows and columns
    without edges: the repair pass puts NaN where the plain version's off-edge
    terms do, at widths of one chunk of the passes' registers or less (d up
    to 512, STAGATE's) and past it (513)."""
    bsr, er, el, h, g = gat_nonfinite_case(d)
    out, m, l = tbsr.bsr_gat_reference(bsr, er, el, h, act=act, return_stats=True)
    args = (er, el, h, g, out[:g.shape[0]], m, l)
    ref = tbsr.bsr_gat_grads_reference(bsr, *args, act=act)
    got = tbsr.bsr_gat_grads(bsr.to(cuda), *(t.to(cuda) for t in args), act=act)
    for a, b in zip(got, ref):
        assert torch.isnan(b).any()
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-4, equal_nan=True)


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


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [1, 70, 200])
@pytest.mark.parametrize("pad_tiles", [True, False])
@pytest.mark.parametrize("weighted", [True, False])
def test_spmm_max_matches_plain(cuda, case, d, pad_tiles, weighted):
    bsr = tbsr.bsr_from_scipy(signed(CASES[case]()))
    bsr = bsr if pad_tiles else no_pad(bsr)
    b = torch.randn((bsr.shape[1], d), generator=torch.Generator().manual_seed(d))
    ref = tbsr.bsr_spmm_max_reference(bsr, b, weighted=weighted)
    n = tbsr.bsr_spmm_max.launches
    out = tbsr.bsr_spmm_max(bsr.to(cuda), b.to(cuda), weighted=weighted)
    torch.cuda.synchronize()
    assert tbsr.bsr_spmm_max.launches == n + 1
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=0)


def test_spmm_max_edge_semantics_match_plain(cuda):
    bsr, h = max_edge_case()
    for weighted in (True, False):
        ref = tbsr.bsr_spmm_max_reference(bsr, h, weighted=weighted)
        out = tbsr.bsr_spmm_max(bsr.to(cuda), h.to(cuda), weighted=weighted).cpu()
        torch.testing.assert_close(out, ref, rtol=0, atol=0, equal_nan=True)
        assert torch.isnan(out).any() and torch.isneginf(out).any() and torch.isinf(out).any()


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("d", [1, 9, 200, 257])
def test_spmm_max_skewed_split_rows_match_plain_bit_equal(cuda, d, weighted):
    """One block-row of 110 tiles, cut into chunks whose partial maxima a
    second kernel combines; NaN and ±inf in h; two runs give equal bits."""
    bsr = skewed_bsr(seed=d)
    b = torch.randn((bsr.shape[1], d), generator=torch.Generator().manual_seed(d))
    b[3, 0], b[300, d // 2], b[301, d - 1] = torch.nan, torch.inf, -torch.inf
    ref = tbsr.bsr_spmm_max_reference(bsr, b, weighted=weighted)
    dev, bd = bsr.to(cuda), b.to(cuda)
    n = tbsr.bsr_spmm_max.launches
    runs = [tbsr.bsr_spmm_max(dev, bd, weighted=weighted) for _ in range(2)]
    torch.cuda.synchronize()
    assert tbsr.bsr_spmm_max.launches == n + 2
    (sched,) = dev._schedules.values()
    assert len(sched.schedule.rows) > 0  # the long block-row was split
    assert torch.equal(_bits(runs[0]), _bits(runs[1]))
    torch.testing.assert_close(runs[0].cpu(), ref, rtol=0, atol=0, equal_nan=True)


def test_spmm_max_backward_raises_and_segment_spmm_launches(cuda):
    from dance_tpu_torch.ops.segment import spmm

    adj = signed(CASES["square_with_empty_block_rows"]())
    h = torch.randn((400, 16), generator=torch.Generator().manual_seed(0)).to(cuda)
    n = tbsr.bsr_spmm_max.launches
    out = spmm(tbsr.bsr_from_scipy(adj).to(cuda), h.requires_grad_(True), op="max")
    assert tbsr.bsr_spmm_max.launches == n + 1 and out.shape == (400, 16)
    with pytest.raises(RuntimeError, match="forward-only"):
        out[torch.isfinite(out)].sum().backward()


def test_spmm_max_wrapper_rejects_bad_inputs(cuda):
    bsr = tbsr.bsr_from_scipy(CASES["rectangular"]()).to(cuda)
    with pytest.raises(TypeError, match="float32"):
        tbsr.bsr_spmm_max(bsr, torch.zeros((bsr.shape[1], 4), device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        tbsr.bsr_spmm_max(bsr, torch.zeros((4, bsr.shape[1]), device=cuda).T)
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        tbsr.bsr_spmm_max(bsr, torch.zeros((bsr.shape[1], 4)))


@pytest.mark.parametrize("use_bsr,agg", [(True, "sum"), (True, "mean"), (False, "max")])
def test_graphsc_fit_matches_cpu(cuda, use_bsr, agg):
    from dance_tpu_torch.modules.single_modality.clustering import GraphSC

    rng = np.random.default_rng(15)
    expr = sp.random(300, 140, density=0.15, random_state=15, dtype=np.float32, format="csr")
    graph = Graph.from_cell_feature_matrix(expr, rng.random((300, 16), dtype=np.float32),
                                           rng.random((140, 16), dtype=np.float32),
                                           normalize_edges=False)
    runs = []
    for device in (torch.device("cpu"), cuda):
        n = tbsr.bsr_spmm.launches
        m = GraphSC(agg=agg, hidden_dim=32, hidden_1=16, dropout=0.0, n_clusters=3,
                    device=device, seed=0)
        m.fit(graph, epochs=4, lr=1e-3, use_bsr=use_bsr)
        runs.append(([h["loss"] for h in m.history], m.z, tbsr.bsr_spmm.launches - n))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-4)
    np.testing.assert_allclose(runs[1][1], runs[0][1], rtol=1e-4, atol=1e-4)
    assert runs[0][2] == 0 and runs[1][2] == (4 * 2 + 1 if use_bsr else 0)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("d", [8, 32, 128, 3000])
def test_spmm_cell_knn_tiling_matches_plain_and_repeats_bit_equal(cuda, d, transposed):
    """scTAG's and scDSC's kind of tiling (under 2 % of the stored slots are
    edges) at their widths, up to scTAG's 3,000 input genes (24 feature
    slabs), and ``Aᵀ`` as the backward runs it."""
    bsr = cell_knn_bsr()
    assert int((bsr.tiles != 0).sum()) < 0.02 * bsr.tiles.numel()
    bsr = tbsr.bsr_transpose(bsr) if transposed else bsr
    b = torch.randn((bsr.shape[1], d), generator=torch.Generator().manual_seed(d))
    ref = tbsr.bsr_spmm_reference(bsr, b)
    dev, bd = bsr.to(cuda), b.to(cuda)
    runs = [tbsr.bsr_spmm(dev, bd) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    torch.testing.assert_close(runs[0].cpu(), ref, rtol=RTOL, atol=ATOL)


def test_spmm_ad_grad_follows_in_place_tile_edit(cuda):
    """The transpose kept on the matrix is built again after ``tiles.mul_``:
    the second ``dB = Aᵀḡ`` is twice the first (tests/test_torch_bsr_cache.py
    on the CPU)."""
    bsr = cell_knn_bsr(n=600).to(cuda)
    g = torch.randn((bsr.shape[0], 16), generator=torch.Generator().manual_seed(1)).to(cuda)

    def grad_b():
        b = torch.linspace(-1, 1, bsr.shape[1] * 16, device=cuda).reshape(-1, 16)
        b.requires_grad_(True)
        (tbsr.bsr_spmm_ad(bsr, b) * g).sum().backward()
        return b.grad

    first = grad_b()
    bsr.tiles.mul_(2.0)
    second = grad_b()
    torch.testing.assert_close(second, 2 * first, rtol=0, atol=0)
    want = tbsr.bsr_spmm_reference(tbsr.bsr_transpose(bsr.to("cpu")), g.cpu())
    torch.testing.assert_close(second.cpu(), want, rtol=RTOL, atol=ATOL)


def _cell_inputs(n=300, g=40, seed=16):
    from dance_tpu_torch.ops.neighbors import knn_graph

    rng = np.random.default_rng(seed)
    types = rng.integers(0, 3, n)
    pts = (rng.normal(0, 3, (3, 6))[types] + rng.normal(0, 1, (n, 6))).astype(np.float32)
    x = (rng.normal(0, 1, (n, g)) + types[:, None] * 0.5).astype(np.float32)
    x_raw = rng.poisson(np.exp(rng.normal(0, 1, (3, g)))[types]).astype(np.float32)
    return (knn_graph(pts, 8, mode="gauss"), x, x_raw, x_raw.sum(1)), types


@pytest.mark.parametrize("use_bsr", [True, False])
def test_sctag_fit_matches_cpu(cuda, use_bsr):
    from dance_tpu_torch.modules.single_modality.clustering import ScTAG

    inputs, types = _cell_inputs()
    runs = []
    for device in (torch.device("cpu"), cuda):
        n = tbsr.bsr_spmm.launches
        m = ScTAG(n_clusters=3, hidden_dim=32, latent_dim=6, dec_dim=(16, 32), device=device)
        m.fit(inputs, types, pretrain_epochs=3, epochs=4, lr=1e-3, use_bsr=use_bsr)
        runs.append(([h["loss"] for h in m.pretrain_history + m.history], m.q, m.z,
                     tbsr.bsr_spmm.launches - n))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-4)
    for got, want in zip(runs[1][1:3], runs[0][1:3]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # per epoch 3 x 3 hops (k = 3), 3 encodes for k-means
    assert runs[0][3] == 0 and runs[1][3] == ((3 + 4) * 9 + 6 if use_bsr else 0)


@pytest.mark.parametrize("use_bsr", [True, False])
def test_scdsc_fit_matches_cpu(cuda, use_bsr):
    from dance_tpu_torch.modules.single_modality.clustering import ScDSC

    inputs, types = _cell_inputs(seed=17)
    runs = []  # q from the refresh at epoch 0, before any DEC step (see the next test)
    for device in (torch.device("cpu"), cuda):
        n = tbsr.bsr_spmm.launches
        m = ScDSC(n_input=inputs[1].shape[1], n_clusters=3, device=device, n_enc_1=64,
                  n_enc_2=32, n_enc_3=32, n_z1=32, n_z2=16, n_z3=8, n_dec_1=32, n_dec_2=32,
                  n_dec_3=64)
        m.fit(inputs, types, pt_epochs=3, epochs=4, lr=1e-4, use_bsr=use_bsr)
        runs.append(([h["loss"] for h in m.pretrain_history + m.history], m.q,
                     tbsr.bsr_spmm.launches - n))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-4)
    np.testing.assert_allclose(runs[1][1], runs[0][1], rtol=1e-4, atol=1e-4)
    assert runs[0][2] == 0 and runs[1][2] == (4 * 14 if use_bsr else 0)


@pytest.mark.parametrize("use_bsr", [True, False])
def test_scdsc_dec_stage_matches_cpu(cuda, use_bsr):
    """After 11 DEC epochs on the CPU (a refresh at epoch 10), the CPU fit's
    weights copied to the card: the refresh's q, the loss, the GCN's predict
    and every gradient agree, with sigma 1 (as fitted) and 0.5 (all seven
    aggregations and their backward carry gradient). Shared weights keep
    Adam's amplified rounding out of the comparison."""
    from chip_smoke import scdsc_dec_state
    from dance_tpu_torch.modules.single_modality.clustering import ScDSC

    inputs, types = _cell_inputs(seed=17)
    models = []
    for device in (torch.device("cpu"), cuda):
        m = ScDSC(n_input=inputs[1].shape[1], n_clusters=3, device=device, n_enc_1=64,
                  n_enc_2=32, n_enc_3=32, n_z1=32, n_z2=16, n_z3=8, n_dec_1=32, n_dec_2=32,
                  n_dec_3=64)
        m.fit(inputs, types, pt_epochs=3, epochs=11 if device.type == "cpu" else 0, lr=1e-4,
              use_bsr=use_bsr)
        models.append(m)
    cpu, card = models
    card.model.load_state_dict(cpu.model.state_dict())
    for sigma in (1.0, 0.5):
        got, want = scdsc_dec_state(card, inputs, sigma), scdsc_dec_state(cpu, inputs, sigma)
        assert got[0] == pytest.approx(want[0], rel=1e-5)
        for g, w in zip(got[1:3], want[1:3]):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
        for name, w in want[3].items():
            scale = float(np.abs(w).max()) or 1.0
            np.testing.assert_allclose(got[3][name], w, rtol=0, atol=1e-4 * scale, err_msg=name)


def _dropped(bsr: tbsr.BSRMatrix, seed: int = 0) -> tbsr.BSRMatrix:
    """``bsr`` with edge dropout at 0.3 on its tiles, as scMoGNN's layers do."""
    gen = torch.Generator(device=bsr.tiles.device).manual_seed(seed)
    keep = torch.rand(bsr.tiles.shape, generator=gen, device=bsr.tiles.device) < 0.7
    return tbsr.bsr_like(bsr, torch.where(keep, bsr.tiles / 0.7, 0.0))


@pytest.mark.parametrize("dropped", [False, True])
@pytest.mark.parametrize("which", ["f2c", "c2f"])
@pytest.mark.parametrize("d", [48, 96])
def test_spmm_rectangular_tiling_matches_plain_and_repeats_bit_equal(cuda, d, which, dropped):
    """#1 on scMoGNN's rectangular tilings at the trunk's widths: ``f2c``
    (every tile of 47 x 8 stored) and ``c2f`` (8 block-rows of 47 tiles, split
    by the work schedule), and on a dropped copy of the tiles, whose
    transpose (the backward's ``Aᵀḡ``) shares the pattern's."""
    pair = dict(zip(("f2c", "c2f"), bipartite_case()))
    bsr = pair[which].to(cuda)
    bsr = _dropped(bsr) if dropped else bsr
    for mat in (bsr, tbsr.bsr_transpose(bsr)):
        b = torch.randn((mat.shape[1], d), generator=torch.Generator().manual_seed(d)).to(cuda)
        runs = [tbsr.bsr_spmm(mat, b) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1])
        ref = tbsr.bsr_spmm_reference(mat.to("cpu"), b.cpu())
        torch.testing.assert_close(runs[0].cpu(), ref, rtol=RTOL, atol=1e-4)
    c2f = pair["c2f"].to(cuda)
    sched = tbsr.device_schedule(c2f, "spmm", d, c2f.tiles.device)
    assert len(sched.schedule.rows) == 8  # every long row of c2f is split


def test_dropped_copies_build_no_schedule(cuda):
    """Fresh dropped tiles at every step: after the first step's forward and
    ``Aᵀḡ``, no work schedule is built on the host again."""
    f2c = bipartite_case().fwd.to(cuda)
    h = torch.randn((f2c.shape[1], 48), device=cuda, requires_grad=True)
    builds = []
    for step in range(4):
        out = tbsr.bsr_spmm_ad(_dropped(f2c, seed=step), h)
        out.sum().backward()
        torch.cuda.synchronize()
        builds.append(tbsr.device_schedule.builds)
    assert builds[1:] == [builds[0]] * 3


@pytest.mark.parametrize("use_bsr", [True, False, "auto"])
def test_scmogcn_fit_matches_cpu(cuda, use_bsr):
    """A small scMoGNN fit (300 cells, 80 features, 2 layers of 16, dropout
    off) on the card and on the CPU from the same seed: losses, validation
    RMSEs and predictions; #1 runs 11 times an epoch on BSR: 2 layers x 2
    relations forward, 3 Aᵀḡ (the last layer's feature update reaches no
    output) and the validation forward's 4."""
    from dance_tpu_torch.modules.multi_modality.predict_modality import ScMoGCNWrapper

    rng = np.random.default_rng(18)
    x = (rng.poisson(2.0, (300, 80)) * (rng.random((300, 80)) < 0.1)).astype(np.float32)
    y = (np.log1p(x) @ rng.random((80, 4)) / 20).astype(np.float32)
    runs = []
    for device in (torch.device("cpu"), cuda):
        n = tbsr.bsr_spmm.launches
        m = ScMoGCNWrapper(hidden_size=16, conv_layers=2, edge_dropout=0.0, model_dropout=0.0,
                           device=device, seed=0)
        m.fit(x, y, epochs=5, use_bsr=use_bsr)
        launched = tbsr.bsr_spmm.launches - n
        runs.append(([h["loss"] for h in m.history], [h["val"] for h in m.history],
                      m.predict(), launched, m._graph.fmt))
    for got, want in zip(runs[1][:3], runs[0][:3]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert runs[0][3] == 0 and runs[1][3] == (5 * 11 if runs[1][4] == "bsr" else 0)
    assert runs[0][4] == ("bsr" if use_bsr is True else "csr")
    assert runs[1][4] == {True: "bsr", False: "csr", "auto": "dense"}[use_bsr]


_DECONVO_TILINGS = {}


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("d", [8, 32, 256])
@pytest.mark.parametrize("tiling", ["dstg", "stdgcn_exp", "stdgcn_sp"])
def test_spmm_deconvo_tilings_match_plain_and_repeat_bit_equal(cuda, tiling, d, transposed):
    """#1 on DSTG's link graph and stdGCN's two towers under their shared RCM
    order, at DSTG's widths (8 types out, 32 hidden) and stdGCN's 256, below
    and above every width the other paths run, and ``Aᵀ`` as the backward
    runs it (through the transposed tiling, though the graphs are
    symmetric). The two towers' tilings keep their own transposes and work
    schedules."""
    if not _DECONVO_TILINGS:
        _DECONVO_TILINGS.update(deconvo_tilings())
    bsr = _DECONVO_TILINGS[tiling].to(cuda)
    mat = tbsr.bsr_transpose(bsr) if transposed else bsr
    b = torch.randn((mat.shape[1], d), generator=torch.Generator().manual_seed(d)).to(cuda)
    n = tbsr.bsr_spmm.launches
    runs = [tbsr.bsr_spmm(mat, b) for _ in range(2)]
    torch.cuda.synchronize()
    assert tbsr.bsr_spmm.launches - n == 2 and torch.equal(runs[0], runs[1])
    ref = tbsr.bsr_spmm_reference(mat.to("cpu"), b.cpu())
    torch.testing.assert_close(runs[0].cpu(), ref, rtol=RTOL, atol=ATOL)
    if tiling == "stdgcn_sp":
        other = _DECONVO_TILINGS["stdgcn_exp"].to(cuda)
        assert tbsr.bsr_transpose(other) is not tbsr.bsr_transpose(bsr)
        dev = bsr.tiles.device
        assert tbsr.device_schedule(other, "spmm", d, dev) is not \
            tbsr.device_schedule(bsr, "spmm", d, dev)


@pytest.mark.parametrize("use_bsr", [True, False])
def test_dstg_fit_matches_cpu(cuda, use_bsr):
    """A small DSTG fit (400 spots) on the card and on the CPU from the same
    seed: losses and predictions; #1 runs 4 times an epoch (2 aggregations
    forward, 2 ``Aᵀḡ``) and twice in ``predict``."""
    from dance_tpu_torch.modules.spatial.cell_type_deconvo import DSTG, dstg_preprocess

    x_ref, labels, x_spots, _, _ = deconvo_case(300, 200, 4, 300, seed=2)
    inp = dstg_preprocess(x_ref, labels, x_spots, n_pseudo=100, k_filter=30, num_cc=10,
                          device="cpu")
    runs = []
    for device in (torch.device("cpu"), cuda):
        n = tbsr.bsr_spmm.launches
        m = DSTG(seed=0, device=device).fit((inp.x, inp.adj), inp.y, max_epochs=20,
                                            use_bsr=use_bsr)
        runs.append(([h["loss"] for h in m.history], m.predict(), tbsr.bsr_spmm.launches - n))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-4)
    np.testing.assert_allclose(runs[1][1], runs[0][1], rtol=1e-4, atol=1e-5)
    assert runs[0][2] == 0 and runs[1][2] == (4 * 20 + 2 if use_bsr else 0)


@pytest.mark.parametrize("use_bsr", [True, "auto"])
def test_stdgcn_fit_matches_cpu(cuda, use_bsr, monkeypatch):
    """A small stdGCN fit (400 spots, 5 epochs, early stopping on, dropout
    off) on the card and on the CPU from the same seed and the same graphs
    (built on the CPU): losses and predictions within the larger of 1e-4 and
    4 x the CPU's own spread between its CSR and dense fits, since Adam
    moves a weight whose gradient is at rounding level by up to the learning
    rate on it (chip_smoke.deconvo_card_vs_cpu also holds one step from the
    same weights at 1e-5). #1 runs 12 times an epoch on BSR (4 tower
    aggregations forward, 4 ``Aᵀḡ``, 4 in the validation forward) and 4
    times in ``predict``; ``"auto"`` is dense on the card for these graphs."""
    from dance_tpu_torch.modules.spatial.cell_type_deconvo import StdGCN
    from dance_tpu_torch.modules.spatial.cell_type_deconvo import stdgcn as st
    from dance_tpu_torch.transforms import PseudoMixture

    x_ref, labels, x_spots, _, coords = deconvo_case(300, 200, 4, 300, seed=3)
    mix, portions, _ = PseudoMixture(n_pseudo=100)(x_ref, labels)
    feat = np.log1p(np.concatenate([mix, x_spots])).astype(np.float32)
    y = np.concatenate([portions, np.zeros((300, 4))]).astype(np.float32)
    graphs = st.build_stdgcn_adjacencies(feat, coords, 100, device="cpu")
    monkeypatch.setattr(st, "build_stdgcn_adjacencies", lambda *a, **k: graphs)
    runs = {}
    fmt = st.resolve_adj_format
    for label, device, flag in (("card", cuda, use_bsr), ("bsr", torch.device("cpu"), True),
                                ("csr", torch.device("cpu"), False),
                                ("dense", torch.device("cpu"), "dense")):
        n = tbsr.bsr_spmm.launches
        m = StdGCN(dropout=0.0, seed=0, device=device)
        monkeypatch.setattr(st, "resolve_adj_format",
                            (lambda *a, **k: "dense") if flag == "dense" else fmt)
        m.fit((feat, coords), y, max_epochs=5, use_bsr=flag if flag != "dense" else "auto")
        runs[label] = (np.array([h["loss"] for h in m.history]), m.predict(),
                       tbsr.bsr_spmm.launches - n, m.fmt)

    def gaps(a, b):  # relative loss gap, prediction gap
        return np.abs(a[0] / b[0] - 1).max(), np.abs(a[1] - b[1]).max()

    # the BSR fits split the labelled spots in the RCM order, the CSR and
    # dense fits in the input order: the spread compares those two
    got = gaps(runs["card"], runs["bsr"] if use_bsr is True else runs["dense"])
    spread = gaps(runs["csr"], runs["dense"])
    assert all(g <= max(1e-4, 4 * s) for g, s in zip(got, spread)), (got, spread)
    epochs = len(runs["card"][0])
    assert runs["card"][3] == ("bsr" if use_bsr is True else "dense")
    assert runs["card"][2] == (12 * epochs + 4 if use_bsr is True else 0)


_HOPS = []


def _hops():
    if not _HOPS:
        _HOPS.extend(heteronet_hops())
    return _HOPS


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hop", [0, 1])
def test_spmm_heteronet_hops_match_plain_and_repeat_bit_equal(cuda, hop, d, transposed):
    """#1 on scHeteroNet's one-hop and strict two-hop tilings of a 5-NN graph
    with hub rows, at the two HetConv layers' widths, and ``Aᵀ`` as the
    backward runs it: the two-hop stores every tile and most slots hold an
    edge (long sums: up to ~1,500 terms a row)."""
    bsr = _hops()[hop].to(cuda)
    fill = int(torch.count_nonzero(bsr.tiles)) / bsr.tiles.numel()
    assert fill > 0.5 if hop else fill < 0.05
    mat = tbsr.bsr_transpose(bsr) if transposed else bsr
    b = torch.randn((mat.shape[1], d), generator=torch.Generator().manual_seed(d)).to(cuda)
    n = tbsr.bsr_spmm.launches
    runs = [tbsr.bsr_spmm(mat, b) for _ in range(2)]
    torch.cuda.synchronize()
    assert tbsr.bsr_spmm.launches - n == 2 and torch.equal(runs[0], runs[1])
    ref = tbsr.bsr_spmm_reference(mat.to("cpu"), b.cpu())
    torch.testing.assert_close(runs[0].cpu(), ref, rtol=RTOL, atol=ATOL)


def test_two_hops_sharing_an_order_keep_their_own_caches(cuda):
    """The two hops tiled under one RCM order keep their own transposes and
    work schedules, and a backward through both gives each its own ``Aᵀḡ``."""
    one, two = (h.to(cuda) for h in _hops())
    assert tbsr.bsr_transpose(one) is not tbsr.bsr_transpose(two)
    dev = one.tiles.device
    assert tbsr.device_schedule(one, "spmm", 64, dev) is not \
        tbsr.device_schedule(two, "spmm", 64, dev)
    h = torch.randn((one.shape[1], 64), generator=torch.Generator().manual_seed(1))
    g = torch.randn((one.shape[0], 128), generator=torch.Generator().manual_seed(2))
    grads = []
    for a1, a2, x in ((one, two, h.to(cuda)), (*(m.to("cpu") for m in _hops()), h)):
        x = x.clone().requires_grad_()
        torch.cat([tbsr.bsr_spmm_ad(a1, x), tbsr.bsr_spmm_ad(a2, x)], 1).backward(g.to(x.device))
        grads.append(x.grad.cpu())
    torch.testing.assert_close(grads[0], grads[1], rtol=RTOL, atol=1e-4)


def test_hetconv_step_with_one_hop_dense_one_bsr_matches_cpu(cuda):
    """One scHeteroNet forward and backward of the cross-entropy with the
    one-hop on BSR tiles and the two-hop dense (``"auto"``'s per-hop
    upgrade), on the card against the CPU on CSR, from the same weights:
    logits, the concatenation and the gradient of every weight the HetConv
    stack feeds; #1 runs 2 + 2 times (the one-hop's forward and ``Aᵀḡ`` in
    both layers). The ZINB decoder is left out: with it, a unit of its ReLU
    layers within rounding of its kink flips between any two formats, on
    the CPU too (6e-5 apart on an H100 and on the CPU alike)."""
    from dance_tpu_torch.modules.single_modality.cell_type_annotation import scheteronet as sh
    from dance_tpu_torch.ops.sparse import csr_from_scipy, dense_adj_from_scipy

    from dance_tpu_torch.ops.neighbors import knn_graph

    rng = np.random.default_rng(3)
    x = np.log1p(rng.poisson(1.0, (600, 40))).astype(np.float32)
    y = torch.from_numpy(rng.integers(0, 3, 600))
    a1, a2 = sh.build_hop_adjacencies(tbsr.rcm_reorder(knn_graph(x, 5))[1])
    runs = []
    for device, hop1, hop2 in ((torch.device("cpu"), csr_from_scipy(a1), csr_from_scipy(a2)),
                               (cuda, tbsr.bsr_from_scipy(a1), dense_adj_from_scipy(a2))):
        net = sh._HeteroNet(40, 3, n_genes=40)
        net.reset_parameters(torch.Generator().manual_seed(0))
        net.to(device)
        n = tbsr.bsr_spmm.launches
        logits, h = net(hop1.to(device), hop2.to(device), torch.from_numpy(x).to(device))
        torch.nn.functional.cross_entropy(logits, y.to(device)).backward()
        torch.cuda.synchronize()
        runs.append((logits.detach().cpu(), h.detach().cpu(),
                     {k: p.grad.cpu() for k, p in net.named_parameters() if p.grad is not None},
                     tbsr.bsr_spmm.launches - n))
    torch.testing.assert_close(runs[1][0], runs[0][0], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(runs[1][1], runs[0][1], rtol=RTOL, atol=ATOL)
    scale = max(float(g.abs().max()) for g in runs[0][2].values())
    for k, g in runs[0][2].items():
        torch.testing.assert_close(runs[1][2][k], g, rtol=0, atol=1e-4 * scale, msg=k)
    assert runs[0][3] == 0 and runs[1][3] == 4


# -- the dense single-modality models ------------------------------------------

def test_amsgrad_on_card_matches_cpu(cuda):
    from dance_tpu_torch.utils.optim import amsgrad

    gen = torch.Generator().manual_seed(0)
    p0 = torch.randn(64, 32, generator=gen)
    grads = torch.randn(300, 64, 32, generator=gen) * torch.rand(300, 1, 1, generator=gen) * 4
    out = {}
    for label, dev in (("cpu", torch.device("cpu")), ("card", cuda)):
        p = torch.nn.Parameter(p0.clone().to(dev))
        opt = amsgrad([p], lr=1e-3)
        for g in grads:
            p.grad = g.to(dev)
            opt.step()
        out[label] = p.detach().cpu()
    torch.testing.assert_close(out["card"], out["cpu"], rtol=0, atol=1e-6 * float(p0.abs().max()))


def _pair(make, fit, cuda):
    """The same model made and fitted on the CPU and on ``cuda``."""
    return {"cpu": fit(make(torch.device("cpu"))), "card": fit(make(cuda))}


def test_actinn_fit_matches_cpu(cuda):
    from dance_tpu_torch.modules.single_modality.cell_type_annotation import (
        ACTINN, actinn_preprocess)

    counts, types, names = typed_counts(48, 40, seed=1)
    x, _ = actinn_preprocess(counts, names)
    runs = _pair(lambda dev: ACTINN(hidden_dims=(16, 8, 4), device=dev),
                 lambda m: m.fit(x, types, batch_size=16, num_epochs=2, seed=3), cuda)
    card, ref = runs["card"], runs["cpu"]
    np.testing.assert_allclose([h["loss"] for h in card.history],
                               [h["loss"] for h in ref.history], rtol=1e-5)
    assert_weights({k: v.cpu().numpy() for k, v in card.model.state_dict().items()},
                   {k: v.numpy() for k, v in ref.model.state_dict().items()}, 0.01, 6)
    np.testing.assert_allclose(card.predict_proba(x), ref.predict_proba(x), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("method", ["scdeepcluster", "scdcc"])
def test_zinb_clustering_fit_matches_cpu(cuda, method, monkeypatch):
    """One pretrain and two DEC epochs (and scDCC's constraint steps) on both
    devices from the same weights, centres and noise (drawn on the CPU)."""
    from dance_tpu_torch.modules.single_modality.clustering import (
        ScDCC, ScDeepCluster, scdcc_preprocess, scdeepcluster, scdeepcluster_preprocess)
    from dance_tpu_torch.ops.cluster import KMeansResult
    from dance_tpu_torch.transforms import generate_random_pair

    def cpu_noise(self, shape, gen):
        g = self.__dict__.setdefault("_test_noise", torch.Generator().manual_seed(4))
        return torch.randn(shape, generator=g).to(self.device)

    monkeypatch.setattr(ScDeepCluster, "_noise", cpu_noise)
    counts, types, names = typed_counts(60, 40, seed=2)
    mu0 = np.random.default_rng(5).standard_normal((3, 4)).astype(np.float32)
    kw = dict(pt_epochs=1, pt_batch_size=16, epochs=2, batch_size=16, tol=0.0)
    layers = dict(encodeLayer=(16, 8), decodeLayer=(8, 16))
    if method == "scdcc":
        inp = scdcc_preprocess(counts, names, types, n_top_genes=30)
        ml1, ml2, cl1, cl2, _ = generate_random_pair(inp.labels, range(len(inp.labels)), 40)
        monkeypatch.setattr(scdeepcluster, "kmeans", lambda z, k, **_: KMeansResult(
            torch.zeros(z.shape[0], dtype=torch.long), torch.from_numpy(mu0), torch.zeros(())))
        runs = _pair(lambda dev: ScDCC(inp.x.shape[1], 4, 3, device=dev, **layers),
                     lambda m: m.fit(inp.inputs, ml_ind1=ml1, ml_ind2=ml2, cl_ind1=cl1,
                                     cl_ind2=cl2, **kw), cuda)
    else:
        inp = scdeepcluster_preprocess(counts, names, types)
        runs = _pair(lambda dev: ScDeepCluster(inp.x.shape[1], 4, device=dev, **layers),
                     lambda m: m.fit(inp.inputs, n_clusters=3, init_centroid=mu0,
                                     y_pred_init=np.zeros(len(inp.labels), int), **kw), cuda)
    card, ref = runs["card"], runs["cpu"]
    for stage in ("pretrain_history", "history"):
        np.testing.assert_allclose([h["loss"] for h in getattr(card, stage)],
                                   [h["loss"] for h in getattr(ref, stage)], rtol=1e-4)
    np.testing.assert_allclose(card.q, ref.q, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(card.mu.detach().cpu().numpy(), ref.mu.detach().numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("reference_protocol", [False, True])
def test_deepimpute_fit_matches_cpu(cuda, reference_protocol):
    from dance_tpu_torch.modules.single_modality.imputation import (DeepImpute,
                                                                    deepimpute_preprocess)

    counts, _, names = typed_counts(60, 40, seed=3)
    inp = deepimpute_preprocess(counts, names, seed=3, sub_outputdim=16, n_top=3)
    runs = _pair(lambda dev: DeepImpute(inp.predictors, inp.targets, sub_outputdim=16,
                                        hidden_dim=8, dropout=0.0, device=dev,
                                        reference_protocol=reference_protocol),
                 lambda m: m.fit(inp.x, inp.x, mask=inp.train_mask, batch_size=16,
                                 n_epochs=3, patience=5), cuda)
    card, ref = runs["card"], runs["cpu"]
    for key in ("loss", "val"):
        np.testing.assert_allclose([h[key] for h in card.history],
                                   [h[key] for h in ref.history], rtol=1e-4)
    assert_weights({k: v.cpu().numpy() for k, v in card.net.state_dict().items()},
                   {k: v.numpy() for k, v in ref.net.state_dict().items()}, 1e-3, 12)
    np.testing.assert_allclose(card.predict(inp.x, mask=inp.train_mask),
                               ref.predict(inp.x, mask=inp.train_mask), rtol=1e-4, atol=1e-5)


# bf16 streaming (compute_dtype) and #2 written for the tensor cores: the
# kernels against the plain versions on the rounded operands, which sum the
# same exact float32 products in another order (RTOL, atol 1e-4 as above)

BF16 = torch.bfloat16


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [1, 50, 96, 200, 256])
@pytest.mark.parametrize("pad_tiles", [True, False])
def test_spmm_bf16_matches_plain(cuda, case, d, pad_tiles):
    bsr = tbsr.bsr_from_scipy(CASES[case]())
    bsr = bsr if pad_tiles else no_pad(bsr)
    b = torch.randn((bsr.shape[1], d), generator=torch.Generator().manual_seed(d))
    ref = tbsr.bsr_spmm_reference(bsr, b, BF16)
    n = tbsr.bsr_spmm.launches, tbsr.bsr_spmm.launches_bf16
    out = tbsr.bsr_spmm(bsr.to(cuda), b.to(cuda), compute_dtype=BF16)
    torch.cuda.synchronize()
    assert (tbsr.bsr_spmm.launches, tbsr.bsr_spmm.launches_bf16) == (n[0] + 1, n[1] + 1)
    torch.testing.assert_close(out.cpu(), ref, rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("d", [1, 8, 50, 200, 257])
def test_spmm_bf16_skewed_matches_plain_and_repeats_bit_equal(cuda, d, transposed):
    bsr = skewed_bsr(seed=d)
    bsr = tbsr.bsr_transpose(bsr) if transposed else bsr
    b = torch.randn((bsr.shape[1], d), generator=torch.Generator().manual_seed(d))
    ref = tbsr.bsr_spmm_reference(bsr, b, BF16)
    dev, bd = bsr.to(cuda), b.to(cuda)
    runs = [tbsr.bsr_spmm(dev, bd, compute_dtype=BF16) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    torch.testing.assert_close(runs[0].cpu(), ref, rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("dtype", [None, BF16])
@pytest.mark.parametrize("case", ["square_with_empty_block_rows", "skewed"])
@pytest.mark.parametrize("d", [1, 50, 96, 130, 200, 256])
def test_sddmm_tensor_cores_match_plain_and_repeat_bit_equal(cuda, dtype, case, d):
    """#2 in float32 (3xTF32) and bf16, ragged widths included (the wrapper
    pads g and b with zero columns to 16-byte rows)."""
    bsr = skewed_bsr(seed=d) if case == "skewed" else tbsr.bsr_from_scipy(CASES[case]())
    g = torch.randn((bsr.shape[0], d), generator=torch.Generator().manual_seed(d))
    b = torch.randn((bsr.shape[1], d), generator=torch.Generator().manual_seed(d + 1))
    ref = tbsr.bsr_sddmm_reference(bsr.block_rows, bsr.block_cols, g, b, dtype)
    rows, cols, gd, bd = (t.to(cuda) for t in (bsr.block_rows, bsr.block_cols, g, b))
    n = tbsr.bsr_sddmm.launches, tbsr.bsr_sddmm.launches_bf16
    runs = [tbsr.bsr_sddmm(rows, cols, gd, bd, compute_dtype=dtype) for _ in range(2)]
    torch.cuda.synchronize()
    assert (tbsr.bsr_sddmm.launches, tbsr.bsr_sddmm.launches_bf16) == \
        (n[0] + 2, n[1] + 2 * (dtype is not None))
    assert torch.equal(runs[0], runs[1])
    torch.testing.assert_close(runs[0].cpu(), ref, rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("dtype", [None, BF16])
def test_sddmm_nonfinite_inputs_match_plain(cuda, dtype):
    """±inf and NaN (the card's full-payload NaN too) in g and b: #2 gives
    what the float32 product of the (rounded) operands gives, 0 * inf = NaN
    included; the 3xTF32 split passes them through as #1's does."""
    bsr = tbsr.bsr_from_scipy(CASES["rectangular"]())
    g = torch.randn((bsr.shape[0], 40), generator=torch.Generator().manual_seed(5))
    b = torch.randn((bsr.shape[1], 40), generator=torch.Generator().manual_seed(6))
    g[3, 0], g[130, 1], b[5, 2] = torch.inf, -torch.inf, torch.nan
    b[:, 3] = torch.inf
    g.view(torch.int32)[9, 5] = 0x7FFFFFFF
    b[11, 6] = 1e30
    ref = tbsr.bsr_sddmm_reference(bsr.block_rows, bsr.block_cols, g, b, dtype)
    out = tbsr.bsr_sddmm(bsr.block_rows.to(cuda), bsr.block_cols.to(cuda), g.to(cuda),
                         b.to(cuda), compute_dtype=dtype).cpu()
    assert torch.isinf(ref).any() and torch.isnan(ref).any()
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=1e-4, equal_nan=True)


def test_spmm_ad_bf16_grads_match_cpu(cuda):
    adj = CASES["rectangular"]()
    grads = []
    for device in (torch.device("cpu"), cuda):
        bsr = tbsr.bsr_from_scipy(adj).to(device)
        bsr.tiles.requires_grad_(True)
        b = torch.linspace(-1, 1, bsr.shape[1] * 40).reshape(-1, 40).to(device)
        b.requires_grad_(True)
        (tbsr.bsr_spmm_ad(bsr, b, compute_dtype=BF16) ** 2).sum().backward()
        grads.append((b.grad.cpu(), bsr.tiles.grad.cpu()))
    for got, want in zip(grads[1], grads[0]):
        torch.testing.assert_close(got, want, rtol=RTOL, atol=1e-4)


def test_spmm_ad_bf16_grad_follows_in_place_tile_edit(cuda):
    """The bf16 tiles and the transpose kept on the matrix are built again
    after ``tiles.mul_``: the second bf16 ``dB = Aᵀḡ`` is twice the first."""
    bsr = cell_knn_bsr(n=600).to(cuda)
    g = torch.randn((bsr.shape[0], 16), generator=torch.Generator().manual_seed(1)).to(cuda)

    def grad_b():
        b = torch.linspace(-1, 1, bsr.shape[1] * 16, device=cuda).reshape(-1, 16)
        b.requires_grad_(True)
        (tbsr.bsr_spmm_ad(bsr, b, compute_dtype=BF16) * g).sum().backward()
        return b.grad

    first = grad_b()
    kept = tbsr.bsr_compute_tiles(bsr, BF16)
    bsr.tiles.mul_(2.0)
    second = grad_b()
    assert tbsr.bsr_compute_tiles(bsr, BF16) is not kept
    torch.testing.assert_close(second, 2 * first, rtol=0, atol=0)
    want = tbsr.bsr_spmm_reference(tbsr.bsr_transpose(bsr.to("cpu")), g.cpu(), BF16)
    torch.testing.assert_close(second.cpu(), want, rtol=RTOL, atol=ATOL)


def test_bf16_wrappers_reject_bad_inputs(cuda):
    bsr = tbsr.bsr_from_scipy(CASES["rectangular"]()).to(cuda)
    b = torch.zeros((bsr.shape[1], 4), device=cuda)
    g = torch.zeros((bsr.shape[0], 4), device=cuda)
    with pytest.raises(ValueError, match="ROADMAP"):
        tbsr.bsr_spmm(bsr, b, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="ROADMAP"):
        tbsr.bsr_sddmm(bsr.block_rows, bsr.block_cols, g, b, compute_dtype=torch.float16)
    with pytest.raises(TypeError, match="float32"):
        tbsr.bsr_spmm(bsr, b.to(torch.float64), compute_dtype=BF16)
    with pytest.raises(TypeError, match="float32"):
        tbsr.bsr_sddmm(bsr.block_rows, bsr.block_cols, g.to(BF16), b, compute_dtype=BF16)
    with pytest.raises(ValueError, match="same d"):
        tbsr.bsr_sddmm(bsr.block_rows, bsr.block_cols, g, b[:, :3], compute_dtype=BF16)
    with pytest.raises(ValueError, match="must be"):
        tbsr.bsr_spmm(bsr, b[:-1], compute_dtype=BF16)
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        tbsr.bsr_sddmm(bsr.block_rows, bsr.block_cols, g.cpu(), b, compute_dtype=BF16)


def test_bf16_fit_matches_cpu(cuda):
    rng = np.random.default_rng(14)
    expr = sp.random(300, 140, density=0.1, random_state=14, dtype=np.float32, format="csr")
    graph = Graph.from_cell_feature_matrix(expr, rng.random((300, 32), dtype=np.float32),
                                           rng.random((140, 32), dtype=np.float32))
    labels = rng.integers(0, 5, 300)
    runs = []
    for device in (torch.device("cpu"), cuda):
        m = ScDeepSort(dim_in=32, dim_hid=64, num_layers=2, seed=0, device=device)
        n = tbsr.bsr_spmm.launches_bf16
        m.fit(graph, labels, epochs=3, lr=1e-2, use_bsr=True, bsr_dtype=BF16)
        runs.append(([h["loss"] for h in m.history], m.predict_proba(graph),
                     tbsr.bsr_spmm.launches_bf16 - n))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-4)
    np.testing.assert_allclose(runs[1][1], runs[0][1], rtol=1e-4, atol=1e-5)
    assert runs[0][2] == 0 and runs[1][2] >= 4 * 3


# --------------------------------------------------------------------------
# the scanpy surface on the card against the CPU, and #1 on stdGCN's towers
# under ComBat's integration
# --------------------------------------------------------------------------

_COMBAT_TILINGS = {}


@pytest.mark.parametrize("tiling", ["stdgcn_exp", "stdgcn_sp"])
def test_spmm_stdgcn_combat_tilings_match_plain(cuda, tiling):
    """#1 at stdGCN's width 256 on its towers under the shared RCM order of
    the graphs that ComBat's integration gives, and their transposes."""
    if not _COMBAT_TILINGS:
        _COMBAT_TILINGS.update(deconvo_tilings(batch_removal="combat"))
    bsr = _COMBAT_TILINGS[tiling].to(cuda)
    for mat in (bsr, tbsr.bsr_transpose(bsr)):
        b = torch.randn((mat.shape[1], 256), generator=torch.Generator().manual_seed(7)).to(cuda)
        n = tbsr.bsr_spmm.launches
        out = tbsr.bsr_spmm(mat, b)
        torch.cuda.synchronize()
        assert tbsr.bsr_spmm.launches - n == 1
        torch.testing.assert_close(out.cpu(), tbsr.bsr_spmm_reference(mat.to("cpu"), b.cpu()),
                                   rtol=RTOL, atol=ATOL)


def test_combat_regress_out_and_wilcoxon_match_cpu(cuda):
    """float64 on both: ComBat, regress-out (before their float32 cast) and
    the Wilcoxon statistics within 1e-9."""
    from dance_tpu_torch.sc import pp as tpp
    from dance_tpu_torch.sc import tl as ttl

    counts, types, names = typed_counts(n=300, g=60, n_types=4, seed=21)
    x = np.log1p(counts)
    batch = np.array(["a", "b"])[np.random.default_rng(21).integers(0, 2, len(x))]
    cpu = torch.device("cpu")
    covs = np.column_stack([np.ones(len(x)), counts.sum(1), np.full(len(x), 2.0)])
    for fn in (lambda d: tpp._combat(torch.from_numpy(x.astype(np.float64)).to(d), batch),
               lambda d: tpp._regress_out(torch.from_numpy(x.astype(np.float64)).to(d),
                                          torch.from_numpy(covs).to(d))):
        card, ref = fn(cuda).cpu().numpy(), fn(cpu).numpy()
        np.testing.assert_allclose(card, ref, rtol=1e-9, atol=1e-9)
    res = [ttl.rank_genes_groups(x, types.astype(str), method="wilcoxon", pts=True,
                                 gene_names=names, device=d) for d in (cuda, cpu)]
    for key in ("scores", "pvals", "pvals_adj", "logfoldchanges", "pts", "pts_rest"):
        for g in res[1][key]:
            np.testing.assert_array_equal(res[0]["names"][g], res[1]["names"][g])
            np.testing.assert_allclose(res[0][key][g], res[1][key][g], rtol=1e-9, atol=1e-300,
                                       err_msg=f"{g} {key}")


def test_umap_epochs_and_scrublet_match_cpu(cuda):
    """Five UMAP epochs from the same handed-in negatives, and Scrublet's
    scores (cells with counts: no coinciding points), within 1e-4."""
    from dance_tpu_torch.sc import pp as tpp
    from dance_tpu_torch.sc import tl as ttl

    rng = np.random.default_rng(22)
    rep = (rng.standard_normal((3, 8)) * 4)[rng.integers(0, 3, 200)] + rng.standard_normal(
        (200, 8))
    _, conn = tpp.neighbors((rep - rep.mean(0)).astype(np.float32), n_neighbors=10,
                            device="cpu")
    n_edges = sp.triu(conn.maximum(conn.T), k=1).nnz
    negs = rng.integers(0, 200, (5, n_edges))
    card, ref = (ttl.umap(conn, n_epochs=5, negatives=negs, device=d)
                 for d in (cuda, torch.device("cpu")))
    np.testing.assert_allclose(card, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    counts = typed_counts(n=200, g=60, seed=22)[0]
    counts = counts[counts.sum(1) > 0]
    (s_card, _, t_card), (s_ref, _, t_ref) = (tpp.scrublet(counts, device=d)
                                              for d in (cuda, torch.device("cpu")))
    np.testing.assert_allclose(s_card, s_ref, atol=1e-4)


def test_sctransform_matches_cpu(cuda):
    """ScTransform's GLM flavour, card against CPU from the same step-1
    draw: β rtol 1e-3, θ rtol 1e-2 (float32 GLM and Newton steps), the
    residuals within 1e-3 absolute; the analytic flavour at float32
    rounding. No kernel runs."""
    from dance_tpu_torch.transforms.normalize import ScTransform

    x = nb_counts(400, 150, seed=23)
    n = tbsr.bsr_spmm.launches
    card, ref = (ScTransform(n_genes=80, random_state=3, device=d)(x)
                 for d in (cuda, torch.device("cpu")))
    assert tbsr.bsr_spmm.launches == n
    np.testing.assert_allclose(card["X"], ref["X"], atol=1e-3)
    for key, rtol in (("Intercept_step1_sct", 1e-3), ("log_umi_step1_sct", 1e-3),
                      ("theta_sct", 1e-2), ("Intercept_sct", 1e-3)):
        ok = ~np.isnan(ref["var"][key])
        np.testing.assert_array_equal(np.isnan(card["var"][key]), ~ok, err_msg=key)
        np.testing.assert_allclose(card["var"][key][ok], ref["var"][key][ok], rtol=rtol,
                                   atol=1e-6, err_msg=key)
    card, ref = (ScTransform(flavor="analytic", device=d)(x) for d in (cuda, torch.device("cpu")))
    np.testing.assert_allclose(card["X"], ref["X"], rtol=1e-5, atol=1e-5)


def test_gcnconv_on_bsr_launches_spmm_and_matches_csr(cuda):
    """GCNConv on a BSR adjacency runs #1 forward and for Aᵀḡ; its output and
    gradients agree with the same layer on the CSR and dense forms, on the
    card, at rtol 1e-4."""
    from dance_tpu_torch.nn.gnn import GCNConv, SAGEConv
    from dance_tpu_torch.ops.neighbors import knn_graph
    from dance_tpu_torch.ops.sparse import (csr_from_scipy, dense_adj_from_scipy,
                                            sym_norm_adjacency)

    pts = np.random.default_rng(24).normal(0, 1, (1000, 20)).astype(np.float32)
    _, scipy_adj = sym_norm_adjacency(knn_graph(pts, 15, mode="gauss"))
    scipy_adj = sp.csr_matrix(scipy_adj, dtype=np.float32)
    adj = tbsr.bsr_from_scipy(scipy_adj)
    layer = GCNConv(32, 16).to(cuda)
    n_nodes = scipy_adj.shape[0]  # the tiling pads its rows to whole blocks
    h = torch.randn((n_nodes, 32), generator=torch.Generator().manual_seed(24)).to(cuda)
    g = torch.randn((n_nodes, 16), generator=torch.Generator().manual_seed(25)).to(cuda)
    outs = {}
    for name, a in (("bsr", adj.to(cuda)), ("csr", csr_from_scipy(scipy_adj).to(cuda)),
                    ("dense", dense_adj_from_scipy(scipy_adj).to(cuda))):
        layer.zero_grad()
        hh = h.clone().requires_grad_(True)
        n = tbsr.bsr_spmm.launches
        out = layer(a, hh)
        (out * g).sum().backward()
        torch.cuda.synchronize()
        assert (tbsr.bsr_spmm.launches - n) == (2 if name == "bsr" else 0), name
        outs[name] = (out.detach().cpu(), hh.grad.cpu(), layer.linear.weight.grad.cpu())
    for name in ("csr", "dense"):
        for got, want in zip(outs["bsr"], outs[name]):
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="degrees"):
        SAGEConv(32, 16).to(cuda)(adj.to(cuda), h)


def test_csr_spmm_reruns_bit_equal(cuda):
    """Eight runs of the fixed-order CSR ``spmm`` (forward, ``dh`` and ``dw``),
    of the mean with trained per-edge scales and of the 1-D sums (row and
    column sums, a single-head ``edge_softmax`` and its gradient) give equal
    bits on the card, on a kNN graph with hub columns (many edges into one
    source)."""
    from dance_tpu_torch.ops import segment as tseg
    from dance_tpu_torch.ops.sparse import csr_col_sums, csr_from_scipy, csr_row_sums

    rng = np.random.default_rng(31)
    n = 4000
    cols = np.where(rng.random((n, 24)) < 0.2, rng.integers(0, 8, (n, 24)),
                    rng.integers(0, n, (n, 24)))
    adj = sp.csr_matrix((rng.standard_normal(n * 24).astype(np.float32),
                         (np.repeat(np.arange(n), 24), cols.ravel())), shape=(n, n))
    a = csr_from_scipy(adj).to(cuda)
    h0 = torch.randn((n, 256), generator=torch.Generator().manual_seed(31)).to(cuda)
    g = torch.randn((n, 256), generator=torch.Generator().manual_seed(32)).to(cuda)
    logits0, ge = (torch.randn(a.indices.shape[0], generator=torch.Generator().manual_seed(s))
                   .to(cuda) for s in (33, 34))
    runs = []
    for _ in range(8):
        h = h0.clone().requires_grad_(True)
        w = a.data.clone().requires_grad_(True)
        out = tseg.csr_spmm(a, h, w)
        mean = tseg.aggregate(a, tseg.gather_src(a, h) * w[:, None], op="mean")
        ((out + mean) * g).sum().backward()
        logits = logits0.clone().requires_grad_(True)
        alpha = tseg.edge_softmax(a, logits)
        (alpha * ge).sum().backward()
        runs.append([out.detach(), mean.detach(), h.grad, w.grad, csr_row_sums(a),
                     csr_col_sums(a), alpha.detach(), logits.grad])
    for run in runs[1:]:
        for x, y in zip(run, runs[0]):
            assert torch.equal(_bits(x), _bits(y))
    dense = torch.from_numpy(adj.toarray()).to(cuda)
    torch.testing.assert_close(runs[0][0], dense @ h0, rtol=1e-4, atol=1e-4)



def test_adaptive_sage_bsr_reruns_bit_equal(cuda):
    """Eight runs of scDeepSort's BSR ``AdaptiveSAGE`` layer, forward and
    backward, give equal bits in its output, dh, dα and dW on the card: only
    the gene nodes gather their alpha, and its gradient is a fixed-order
    sum. The card's dα within 1e-4 of the CPU's."""
    import copy

    from dance_tpu_torch.nn.gnn import AdaptiveSAGE

    rng = np.random.default_rng(35)
    expr = sp.random(3000, 500, density=0.05, random_state=35, dtype=np.float32, format="csr")
    graph = Graph.from_cell_feature_matrix(expr, rng.random((3000, 8), dtype=np.float32),
                                           rng.random((500, 8), dtype=np.float32))
    gen = torch.Generator().manual_seed(35)
    layer = AdaptiveSAGE(64, 64)
    n = graph.num_nodes
    h0, g = torch.randn((n, 64), generator=gen), torch.randn((n, 64), generator=gen)
    alpha0 = 1.0 + 0.1 * torch.randn(502, generator=gen)
    runs = {}
    for dev, reruns in ((cuda, 8), (torch.device("cpu"), 1)):
        adj = graph.to_adaptive_bsr(device=dev)
        net = copy.deepcopy(layer).to(dev).eval()
        runs[dev.type] = []
        for _ in range(reruns):
            h = h0.to(dev).requires_grad_(True)
            alpha = alpha0.to(dev).requires_grad_(True)
            net.zero_grad(set_to_none=True)
            out = net(adj, h, adj.gene_idx, alpha)
            out.backward(g.to(dev))
            runs[dev.type].append([out.detach(), h.grad, alpha.grad, net.linear.weight.grad])
    card = runs[cuda.type]
    for run in card[1:]:
        for x, y in zip(run, card[0]):
            assert torch.equal(_bits(x), _bits(y))
    dalpha, ref = card[0][2].cpu(), runs["cpu"][0][2]
    assert ref[:500].abs().min() > 0  # every gene's alpha takes a gradient
    torch.testing.assert_close(dalpha, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))


def test_umap_and_tfidf_reruns_bit_equal(cuda):
    """Eight UMAP layouts (50 epochs from one spectral start and one draw of
    negatives) and eight LSI TF-IDF normalisations give equal bits on the
    card: the layout's update and the TF-IDF's row and column sums run in a
    fixed order. The TF-IDF within 1e-12 of the CPU's (float64)."""
    from dance_tpu_torch.sc import pp as tpp
    from dance_tpu_torch.sc import tl as ttl
    from dance_tpu_torch.transforms.preprocess import lsiTransformer

    rng = np.random.default_rng(36)
    rep = (rng.standard_normal((3, 8)) * 4)[rng.integers(0, 3, 500)] + rng.standard_normal(
        (500, 8))
    _, conn = tpp.neighbors((rep - rep.mean(0)).astype(np.float32), n_neighbors=10,
                            device="cpu")
    n_edges = sp.triu(conn.maximum(conn.T), k=1).nnz
    negs = rng.integers(0, 500, (50, n_edges))
    layouts = [ttl.umap(conn, n_epochs=50, negatives=negs, device=cuda) for _ in range(8)]
    assert np.isfinite(layouts[0]).all()
    for layout in layouts[1:]:
        np.testing.assert_array_equal(layout.view(np.int32), layouts[0].view(np.int32))
    peaks = sp.random(400, 3000, density=0.05, random_state=36, dtype=np.float32, format="csr")
    peaks.data = 1.0 + (peaks.data > 0.8).astype(np.float32)
    runs = [lsiTransformer(device=cuda)._normalized(peaks) for _ in range(8)]
    for run in runs[1:]:
        assert torch.equal(run.indices(), runs[0].indices())
        assert torch.equal(_bits(run.values()), _bits(runs[0].values()))
    ref = lsiTransformer(device=torch.device("cpu"))._normalized(peaks)
    torch.testing.assert_close(runs[0].values().cpu(), ref.values(), rtol=1e-12, atol=0)


def test_atlas_metrics_match_cpu(cuda):
    """The atlas similarity's pairwise metrics on the card against the CPU:
    float32 at rtol 1e-4 (sums in another order), the float64 Bures and
    spectral distances at rtol 1e-6; the squared distances are full float32
    even with TF32 on."""
    from dance_tpu_torch.atlas.sc_similarity import anndata_similarity as A
    from dance_tpu_torch.data import AnnData

    rng = np.random.default_rng(37)
    names = np.array([f"G{k}" for k in range(300)])
    pair = []
    for n, seed in ((400, 0), (300, 1)):
        x = rng.poisson(rng.gamma(0.6, 1.0, (3, 300))[rng.integers(0, 3, n)] * 2.0)
        a = AnnData(x.astype(np.float32))
        a.var_names = names
        pair.append(a)
    sims = {dev: A.AnnDataSimilarity(*pair, init_random_state=0, n_runs=1, device=dev)
            for dev in (cuda, torch.device("cpu"))}
    x1, x2 = sims[cuda].sample_cells(0)
    for name, rtol in (("compute_mmd", 1e-4), ("wasserstein_dist", 1e-4),
                       ("get_Hausdorff", 1e-4), ("chamfer_distance", 1e-4),
                       ("energy_distance_metric", 1e-4), ("get_sinkhorn2", 1e-4),
                       ("bures_distance", 1e-6), ("spectral_distance", 1e-6)):
        got = getattr(sims[cuda], name)(x1, x2)
        want = getattr(sims[torch.device("cpu")], name)(x1, x2)
        np.testing.assert_allclose(got, want, rtol=rtol, err_msg=name)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        d = A.pdist2(torch.from_numpy(x1).float().to(cuda), torch.from_numpy(x2).float().to(cuda))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    want = A.pdist2(torch.from_numpy(x1).float(), torch.from_numpy(x2).float())
    np.testing.assert_allclose(d.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5 * float(want.max()))


def test_run_vmapped_matches_cpu(cuda):
    """``SweepRunner.run_vmapped`` on a tiny MLP from the same weights in
    every trial, on the card against the CPU: scores and final losses at
    rtol 1e-4."""
    from dance_tpu_torch.pipeline import SweepRunner

    rng = np.random.default_rng(38)
    x = torch.from_numpy(rng.standard_normal((64, 6)).astype(np.float32))
    y = torch.from_numpy((x[:, :3].sum(1) > 0).numpy().astype(np.int64))
    w = {"w1": rng.standard_normal((6, 8)).astype(np.float32) * 0.5,
         "b1": np.zeros(8, np.float32),
         "w2": rng.standard_normal((8, 2)).astype(np.float32) * 0.5,
         "b2": np.zeros(2, np.float32)}

    def make_trial(device, with_score):
        def nll(p, bx, by):
            logp = torch.log_softmax(torch.tanh(bx @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"], -1)
            return -torch.gather(logp, 1, by[:, None]).mean()

        def loss_fn(p, batch, hyper):
            return nll(p, *batch) + hyper["lambd"] * sum((v ** 2).sum() for v in p.values())

        def make(configs):
            return (lambda seed: {k: torch.from_numpy(v.copy()) for k, v in w.items()}, loss_fn,
                    (x.to(device), y.to(device)),
                    (lambda p, batch: nll(p, *batch)) if with_score else None)

        return make

    space = {"lr": {"values": [0.03, 0.01]}, "lambd": {"values": [0.0, 0.05]}}
    for with_score in (False, True):
        runs = [SweepRunner(space, method="grid").run_vmapped(
            make_trial(dev, with_score), num_steps=15, metric="m", device=dev)
            for dev in (cuda, torch.device("cpu"))]
        got, want = ([r["m"] for r in run.records] for run in runs)
        np.testing.assert_allclose(got, want, rtol=1e-4)
        assert runs[0]._last_stacked_params["w1"].device.type == "cuda"
