"""The adjacency-format rule of the port (dance_tpu_torch.ops.bsr:
``tile_expansion``, ``choose_adj_format``, ``resolve_use_bsr``,
``resolve_adj_format``) against the JAX package's (pallas_kernels.py:697-772),
the models' ``use_bsr="auto"``, the dense ``to_adaptive_bsr`` and the
pattern-sharing ``bsr_like`` copies.

The rule is the same function of a scipy matrix in both packages, so with the
same explicit thresholds the answers must be equal. JAX's takes the TPU
branch only when ``jax.default_backend()`` is ``"tpu"``: the tests patch that
name in this process only; the port's takes the card's branch for a CUDA
``device`` (a ``torch.device`` object, no card needed to name one). Exact
comparisons throughout, except the dense adjacency's product at 1e-6.
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dance_tpu.graph import Graph as JGraph
from dance_tpu.ops import pallas_kernels as jpk
from dance_tpu_torch.graph import Graph
from dance_tpu_torch.ops import bsr as tbsr
from dance_tpu_torch.ops.sparse import DenseAdj

CUDA = torch.device("cuda")  # only named: the rule reads its type
CPU = torch.device("cpu")


def _matrices():
    """Rectangular and square, banded and scattered, empty rows, one empty matrix."""
    rng = np.random.default_rng(0)
    out = {"rect": sp.random(300, 140, density=0.05, random_state=1, format="csr",
                             dtype=np.float32),
           "wide": sp.random(90, 400, density=0.2, random_state=2, format="csr",
                             dtype=np.float32),
           "dense": sp.random(200, 200, density=0.9, random_state=3, format="csr",
                              dtype=np.float32),
           "empty": sp.csr_matrix((130, 260), dtype=np.float32)}
    n = 600
    rows = np.repeat(np.arange(n), 6)
    cols = np.clip(rows + rng.integers(-20, 21, rows.size), 0, n - 1)
    band = sp.csr_matrix((np.ones(rows.size, np.float32), (rows, cols)), shape=(n, n))
    perm = rng.permutation(n)
    out["band"], out["shuffled band"] = band, band[perm][:, perm].tocsr()
    return out


MATRICES = _matrices()
RULES = [dict(max_expansion=e, dense_threshold=t, dense_occupancy=o)
         for e, t, o in [(150.0, 0.02, 0.25), (250.0, 0.8, 0.8), (20.0, 0.5, 0.5),
                         (1e4, 1.0, 2.0)]]


def _answer(fn, *args, **kw):
    """``fn``'s answer, or the type of what it raised (both packages' RCM step
    takes square matrices only)."""
    try:
        return fn(*args, **kw)
    except IndexError as e:
        return type(e)


@pytest.fixture
def jax_on_tpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("block", [32, 128])
def test_tile_expansion_matches_jax(name, block):
    a = MATRICES[name]
    assert tbsr.tile_expansion(a, block) == jpk.tile_expansion(a, block)


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("reorder", [True, False])
def test_choose_adj_format_matches_jax(name, reorder, jax_on_tpu):
    a = MATRICES[name]
    for rule in RULES:
        for max_bytes in (2 << 30, 0):
            got = _answer(tbsr.choose_adj_format, a, 32, device=CUDA, reorder=reorder,
                          dense_max_bytes=max_bytes, **rule)
            want = _answer(jpk.choose_adj_format, a, 32, reorder=reorder,
                           dense_max_bytes=max_bytes, **rule)
            assert got == want, (rule, max_bytes)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_resolve_use_bsr_matches_jax(name, jax_on_tpu):
    a = MATRICES[name]
    for max_expansion in (5.0, 40.0, 150.0, 250.0, 1e4):
        for reorder in (True, False):
            got = _answer(tbsr.resolve_use_bsr, "auto", a, 32, device=CUDA, reorder=reorder,
                          max_expansion=max_expansion)
            want = _answer(jpk.resolve_use_bsr, "auto", a, 32, reorder=reorder,
                           max_expansion=max_expansion)
            assert got == want, (max_expansion, reorder)
    for flag in (True, False):
        assert tbsr.resolve_use_bsr(flag, device=CUDA) is jpk.resolve_use_bsr(flag, a)


def test_defaults_pick_the_measured_formats():
    """The H100 crossovers: a tiling that covers ~all of its matrix is dense
    (scMoGNN's f2c), a quarter- or third-covered one BSR (scDeepSort,
    graph-sc), and expansion past 250 CSR."""
    assert (tbsr.DENSE_THRESHOLD, tbsr.DENSE_OCCUPANCY, tbsr.MAX_EXPANSION) == (0.8, 0.8, 250.0)
    assert tbsr.choose_adj_format(MATRICES["wide"], device=CUDA, reorder=False) == "dense"
    assert tbsr.choose_adj_format(MATRICES["band"], 32, device=CUDA, reorder=False) == "bsr"
    assert tbsr.choose_adj_format(MATRICES["band"], 32, device=CUDA, reorder=False,
                                  max_expansion=1.0) == "csr"


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_auto_is_csr_off_the_card(name):
    a = MATRICES[name]
    assert tbsr.choose_adj_format(a, device=CPU) == "csr"
    assert tbsr.resolve_use_bsr("auto", a, device=CPU) is False
    assert tbsr.resolve_adj_format("auto", a, device=CPU) == "csr"
    assert tbsr.resolve_adj_format(True, device=CPU) == "bsr"


def test_resolve_rejects_other_flags():
    for flag in ("yes", 1, None):
        with pytest.raises(ValueError, match="use_bsr must be"):
            tbsr.resolve_adj_format(flag, MATRICES["rect"], device=CPU)
    with pytest.raises(ValueError, match="needs the adjacency"):
        tbsr.resolve_use_bsr("auto", device=CUDA)


# --------------------------------------------------------------------------
# The models read the rule: the right variant, and "auto" as their default
# --------------------------------------------------------------------------


def _record_rule(monkeypatch, answer="csr"):
    calls = []

    def rule(adj, block=128, *, device, reorder=True, dense_max_bytes=tbsr.DENSE_MAX_BYTES,
             **kw):
        calls.append({"shape": adj.shape, "device": torch.device(device).type,
                      "reorder": reorder, "dense": dense_max_bytes > 0})
        return answer
    monkeypatch.setattr(tbsr, "choose_adj_format", rule)
    return calls


def _fit_scdeepsort():
    from dance_tpu_torch.modules.single_modality.cell_type_annotation import ScDeepSort
    rng = np.random.default_rng(0)
    expr = sp.random(40, 20, density=0.3, random_state=0, format="csr", dtype=np.float32)
    g = Graph.from_cell_feature_matrix(expr, rng.random((40, 6), dtype=np.float32),
                                       rng.random((20, 6), dtype=np.float32))
    ScDeepSort(dim_in=6, dim_hid=8, num_layers=1, device="cpu").fit(
        g, rng.integers(0, 3, 40), epochs=1)
    return (60, 60)


def _fit_graphsc():
    from dance_tpu_torch.modules.single_modality.clustering import GraphSC
    rng = np.random.default_rng(1)
    expr = sp.random(40, 20, density=0.3, random_state=1, format="csr", dtype=np.float32)
    g = Graph.from_cell_feature_matrix(expr, rng.random((40, 6), dtype=np.float32),
                                       rng.random((20, 6), dtype=np.float32))
    GraphSC(hidden_dim=8, hidden_1=6, n_clusters=2, device="cpu").fit(g, epochs=1)
    return (60, 60)


def _knn(n=60, seed=2):
    from dance_tpu_torch.ops.neighbors import knn_graph
    pts = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return knn_graph(pts, 5, mode="gauss", include_self=False, symmetrize=True)


def _fit_stagate():
    from dance_tpu_torch.modules.spatial.spatial_domain import Stagate
    x = np.random.default_rng(3).normal(size=(60, 12)).astype(np.float32)
    Stagate(hidden_dims=(12, 8, 4), device="cpu").fit((x, _knn()), epochs=1, n_clusters=2)
    return (60, 60)


def _clustering_inputs(seed=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(60, 12)).astype(np.float32)
    raw = rng.poisson(2.0, (60, 12)).astype(np.float32)
    return _knn(seed=seed), x, raw, raw.sum(1) + 1


def _fit_sctag():
    from dance_tpu_torch.modules.single_modality.clustering import ScTAG
    ScTAG(n_clusters=2, hidden_dim=8, latent_dim=4, dec_dim=(6, 8), k=1, device="cpu").fit(
        _clustering_inputs(), pretrain_epochs=1, epochs=1)
    return (60, 60)


def _fit_scdsc():
    from dance_tpu_torch.modules.single_modality.clustering import ScDSC
    ScDSC(n_clusters=2, n_input=12, n_enc_1=8, n_enc_2=8, n_enc_3=8, n_dec_1=8, n_dec_2=8,
          n_dec_3=8, n_z1=8, n_z2=8, n_z3=4, device="cpu").fit(
        _clustering_inputs(5), pt_epochs=1, epochs=1)
    return (60, 60)


def _fit_scmogcn():
    from dance_tpu_torch.modules.multi_modality.predict_modality import ScMoGCNWrapper
    rng = np.random.default_rng(6)
    x, y = rng.poisson(0.5, (50, 30)).astype(np.float32), rng.random((50, 3), np.float32)
    ScMoGCNWrapper(hidden_size=8, conv_layers=2, device="cpu").fit(x, y, epochs=1)
    return (50, 30)


# model -> (fit, the rule's reorder, whether it may answer "dense")
MODELS = {"ScDeepSort": (_fit_scdeepsort, False, True), "GraphSC": (_fit_graphsc, False, True),
          "Stagate": (_fit_stagate, True, False), "ScTAG": (_fit_sctag, True, False),
          "ScDSC": (_fit_scdsc, True, False), "ScMoGCNWrapper": (_fit_scmogcn, False, True)}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_models_default_to_auto(model, monkeypatch):
    """Each graph model's default ``use_bsr`` is ``"auto"`` (as in JAX), and
    it asks the rule about its own adjacency on its device, with the JAX
    package's reorder flag and with or without the dense answer."""
    fit, reorder, dense = MODELS[model]
    calls = _record_rule(monkeypatch)
    shape = fit()
    assert len(calls) >= 1
    assert calls[0] == {"shape": shape, "device": "cpu", "reorder": reorder, "dense": dense}


# --------------------------------------------------------------------------
# Graph.to_adaptive_bsr(dense=True)
# --------------------------------------------------------------------------


def test_to_adaptive_bsr_dense_matches_jax():
    rng = np.random.default_rng(7)
    expr = sp.random(150, 70, density=0.1, random_state=7, format="csr", dtype=np.float32)
    cf, gf = rng.random((150, 5), dtype=np.float32), rng.random((70, 5), dtype=np.float32)
    ja = JGraph.from_cell_feature_matrix(expr, cf, gf).to_adaptive_bsr(dense=True)
    t = Graph.from_cell_feature_matrix(expr, cf, gf)
    ta = t.to_adaptive_bsr(dense=True, device="cpu")
    assert isinstance(ta.bsr, DenseAdj) and ta.n_genes == ja.n_genes
    np.testing.assert_array_equal(ta.bsr.mat.numpy(), np.asarray(ja.bsr.mat))
    np.testing.assert_array_equal(ta.bsr.degrees.numpy(), np.asarray(ja.bsr.degrees))
    for field in ("w_diag", "gene_idx", "deg"):
        np.testing.assert_array_equal(getattr(ta, field).numpy(), np.asarray(getattr(ja, field)))
    # the dense and the tiled off-diagonal are the same matrix
    tb = t.to_adaptive_bsr(device="cpu")
    h = torch.from_numpy(rng.standard_normal((220, 3)).astype(np.float32))
    np.testing.assert_allclose((ta.bsr.mat @ h).numpy(),
                               tbsr.bsr_spmm(tb.bsr, torch.nn.functional.pad(
                                   h, (0, 0, 0, tb.bsr.shape[1] - 220)))[:220].numpy(),
                               rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# bsr_like: a copy that shares everything but its tiles
# --------------------------------------------------------------------------


def test_bsr_like_shares_pattern_and_transposed_pattern():
    a = tbsr.bsr_from_scipy(sp.random(300, 520, density=0.02, random_state=8, format="csr",
                                      dtype=np.float32))
    at = tbsr.bsr_transpose(a)
    dropped = a.tiles * (torch.rand(a.tiles.shape, generator=torch.Generator().manual_seed(0))
                         < 0.7)
    c = tbsr.bsr_like(a, dropped)
    assert c.block_rows is a.block_rows and c.block_cols is a.block_cols
    assert c.rowptr is a.rowptr and c._schedules is a._schedules
    ct = tbsr.bsr_transpose(c)
    assert ct.rowptr is at.rowptr and ct.block_rows is at.block_rows
    assert ct.block_cols is at.block_cols and ct._schedules is at._schedules
    fresh = tbsr.bsr_transpose(tbsr.BSRMatrix(dropped, a.block_rows, a.block_cols, a.rowptr,
                                              a.shape))
    assert torch.equal(ct.tiles, fresh.tiles) and torch.equal(ct.rowptr, fresh.rowptr)
    # a copy of a copy keeps the first pattern, and the transpose stays kept
    c2 = tbsr.bsr_like(c, dropped * 2)
    assert c2._pattern is a and tbsr.bsr_transpose(c2).rowptr is at.rowptr
    assert tbsr.bsr_transpose(c) is ct
    with pytest.raises(ValueError, match="do not match"):
        tbsr.bsr_like(a, dropped[:-1])
