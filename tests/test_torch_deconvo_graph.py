"""Port parity for the host front of the deconvolution methods: pseudo-spot
mixing and cell-type profiles (dance_tpu_torch.transforms.pseudobulk),
marker genes (transforms.filter), DSTG's CCA link graph
(transforms.graph.dstg_graph), stdGCN's graph builders
(modules.spatial.cell_type_deconvo.stdgcn) and ``dstg_preprocess``.

Inputs are made with numpy from a seed (torch_cases.deconvo_case) and handed
to both packages. Tolerances: mixtures and portions bit for bit (both draw
from ``np.random.default_rng``), profiles and marker genes exactly; CCA
subspaces to |cos| ≥ 1 - 1e-4 per component; the graphs' edges exactly and
their weights at 1e-6 when both builders get the same embedding and the same
neighbours (the two randomized SVDs draw different test matrices, and a kNN
tie may fall either way); PCA features at 1e-4 relative to their scale.
"""

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from dance_tpu.data import AnnData, Data
from dance_tpu.modules.spatial.cell_type_deconvo import stdgcn as jstdgcn
from dance_tpu.modules.spatial.cell_type_deconvo.dstg import DSTG as JDSTG
from dance_tpu.ops import linalg as jlinalg
from dance_tpu.ops import neighbors as jneighbors
from dance_tpu.transforms import filter as jfilter
from dance_tpu.transforms import pseudobulk as jpseudobulk
from dance_tpu.transforms.graph import dstg_graph as jdstg_graph
from dance_tpu.transforms.misc import RemoveSplit
from dance_tpu_torch.modules.spatial.cell_type_deconvo import dstg_preprocess
from dance_tpu_torch.modules.spatial.cell_type_deconvo import stdgcn as tstdgcn
from dance_tpu_torch.ops.linalg import PCAResult
from dance_tpu_torch.transforms import CellTopicProfile, FilterGenesMarker, PseudoMixture
from dance_tpu_torch.transforms import pseudobulk as tpseudobulk
from dance_tpu_torch.transforms.graph import dstg_graph as tdstg_graph
from torch_cases import deconvo_case

CPU = torch.device("cpu")


def _container(x_ref, labels, x_spots=None) -> Data:
    """A JAX container: the reference cells as split "ref", the spots as "test"."""
    ref = AnnData(x_ref, obs=pd.DataFrame({"cellType": labels},
                                          index=[f"c{i}" for i in range(len(x_ref))]),
                  var=pd.DataFrame(index=[f"g{i}" for i in range(x_ref.shape[1])]))
    data = Data(ref, full_split_name="ref")
    if x_spots is not None:
        spots = AnnData(x_spots, obs=pd.DataFrame(index=[f"s{i}" for i in range(len(x_spots))]),
                        var=pd.DataFrame(index=[f"g{i}" for i in range(x_spots.shape[1])]))
        data.append(Data(spots), mode="new_split", new_split_name="test", join="outer")
    return data


def _jax_portions(x, annot, n_pseudo, nc_min, nc_max, random_state):
    """The portions JAX's ``PseudoMixture.__call__`` builds (pseudobulk.py:103-117),
    from its own ``gen_mix``: its ``Data.append`` drops them (the reference
    split holds no ``cell_type_portion``), so they are rebuilt here."""
    rng = np.random.default_rng(random_state)
    annot = np.asarray(annot).astype(str)
    cts = [jpseudobulk.PseudoMixture.gen_mix(x, annot, nc_min, nc_max, rng)[1]
           for _ in range(n_pseudo)]
    df = pd.DataFrame(cts, columns=jpseudobulk.get_cell_types("auto", annot)).fillna(0)
    return df.div(df.sum(axis=1), axis=0)


# --------------------------------------------------------------------------
# pseudo-spots, profiles, marker genes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("random_state,nc", [(0, (2, 10)), (7, (1, 3)), (11, (5, 20))])
def test_pseudo_mixture_bit_identical(random_state, nc):
    x_ref, labels, _, _, _ = deconvo_case(seed=1)
    data = _container(x_ref, labels)
    jpseudobulk.PseudoMixture(n_pseudo=40, nc_min=nc[0], nc_max=nc[1],
                              random_state=random_state, in_split_name="ref",
                              out_split_name="pseudo")(data)
    idx = data.get_split_idx("pseudo")
    want_x = np.asarray(data.data.X)[idx]
    want_p = _jax_portions(x_ref, labels, 40, nc[0], nc[1], random_state)
    pm = PseudoMixture(n_pseudo=40, nc_min=nc[0], nc_max=nc[1], random_state=random_state)
    mix_x, portions, cell_types = pm(x_ref, labels)
    assert cell_types == list(want_p.columns)
    assert mix_x.dtype == np.float32
    np.testing.assert_array_equal(mix_x, want_x)
    np.testing.assert_array_equal(portions, want_p.to_numpy())
    obs = data.data.obs.iloc[idx]
    np.testing.assert_array_equal(pm.info["cell_count"], obs["cell_count"].to_numpy())
    np.testing.assert_array_equal(pm.info["total_umi_count"], obs["total_umi_count"].to_numpy())


@pytest.mark.parametrize("method", ["median", "mean"])
@pytest.mark.parametrize("batched", [False, True])
def test_ct_profile_matches_jax(method, batched):
    x_ref, labels, _, _, _ = deconvo_case(seed=2)
    batch = np.random.default_rng(3).integers(0, 3, len(x_ref)) if batched else None
    want = jpseudobulk.get_ct_profile(x_ref, labels, batch_index=batch, method=method)
    got = tpseudobulk.get_ct_profile(x_ref, labels, batch_index=batch, method=method)
    np.testing.assert_array_equal(got, want)
    profile, cell_types = CellTopicProfile(method=method)(x_ref, labels, batch)
    np.testing.assert_array_equal(profile, want)
    assert cell_types == jpseudobulk.get_cell_types("auto", labels)


def test_cell_types_and_agg_func():
    labels = np.array(["b", "a", "c", "a"])
    assert tpseudobulk.get_cell_types("auto", labels) == ["a", "b", "c"]
    assert tpseudobulk.get_cell_types(["c", "a"], labels) == ["c", "a"]
    with pytest.raises(ValueError, match="Unknown cell types"):
        tpseudobulk.get_cell_types(["d"], labels)
    x = np.arange(12.0).reshape(4, 3)
    np.testing.assert_array_equal(tpseudobulk.get_agg_func("default", default="median")(x),
                                  np.median(x, 0))
    with pytest.raises(ValueError):
        tpseudobulk.get_agg_func("default")


@pytest.mark.parametrize("threshold", [0.5, 1.25])
def test_marker_genes_match_jax(threshold):
    x_ref, labels, _, _, _ = deconvo_case(seed=4)
    profile, cell_types = CellTopicProfile()(x_ref, labels)
    genes = [f"g{i}" for i in range(profile.shape[0])]
    want, want_ind = jfilter.FilterGenesMarker.get_marker_genes(profile, cell_types, genes,
                                                                threshold=threshold)
    got, ind = FilterGenesMarker.get_marker_genes(profile, cell_types, genes,
                                                  threshold=threshold)
    assert got == want and 0 < len(got) < len(genes)
    np.testing.assert_array_equal(ind, want_ind.to_numpy())
    mask = FilterGenesMarker(threshold=threshold)(profile, cell_types)
    assert [genes[i] for i in np.nonzero(mask)[0]] == want
    with pytest.raises(ValueError, match="two cell types"):
        FilterGenesMarker()(profile[:, :1])


# --------------------------------------------------------------------------
# DSTG's link graph
# --------------------------------------------------------------------------

def _spots(seed=5, n_pseudo=70):
    x_ref, labels, x_spots, _, _ = deconvo_case(seed=seed)
    mix_x, _, _ = PseudoMixture(n_pseudo=n_pseudo, random_state=seed)(x_ref, labels)
    return mix_x.astype(np.float64), x_spots.astype(np.float64)


def test_cca_embed_subspaces_match_jax():
    x_ps, x_real = _spots()
    want = jdstg_graph.cca_embed(x_ps, x_real, num_cc=10)
    got = tdstg_graph.cca_embed(x_ps, x_real, num_cc=10, device=CPU)
    for w, g in zip(want, got):
        assert g.shape == w.shape == (len(w), 10) and g.dtype == np.float32
        cos = np.abs((w * g).sum(0)) / (np.linalg.norm(w, axis=0) * np.linalg.norm(g, axis=0))
        assert cos.min() >= 1 - 1e-4, cos


def test_knn_matches_jax():
    rng = np.random.default_rng(6)
    q, base = rng.standard_normal((50, 8)), rng.standard_normal((90, 8))
    want = np.asarray(jdstg_graph._knn(q, base, 7))
    np.testing.assert_array_equal(tdstg_graph.query_knn(base, 7, q, device=CPU)[1], want)


@pytest.mark.parametrize("k_filter", [200, 3])
def test_compute_dstg_adj_matches_jax(monkeypatch, k_filter):
    x_ps, x_real = _spots()
    emb = jdstg_graph.cca_embed(x_ps, x_real, num_cc=10)
    monkeypatch.setattr(jdstg_graph, "cca_embed", lambda *a, **k: emb)
    monkeypatch.setattr(tdstg_graph, "cca_embed", lambda *a, **k: emb)
    want = jdstg_graph.compute_dstg_adj(x_ps, x_real, k_filter=k_filter, num_cc=10)
    got = tdstg_graph.compute_dstg_adj(x_ps, x_real, k_filter=k_filter, num_cc=10, device=CPU)
    assert got.shape == want.shape and got.dtype == np.float32
    assert (got != got.T).nnz == 0
    np.testing.assert_array_equal((got != 0).toarray(), (want != 0).toarray())
    np.testing.assert_allclose(got.toarray(), want.toarray(), rtol=1e-6, atol=0)
    # every real spot keeps at most k_filter links (and its self-loop)
    links = np.diff(got.indptr)[len(x_ps):] - 1
    assert links.max() <= k_filter and links.sum() > 0


def test_dstg_graph_reads_float64(monkeypatch):
    x_ps, x_real = _spots()
    seen = {}

    def spy(x_ref, x_inf, **kw):
        seen["dtypes"] = (x_ref.dtype, x_inf.dtype)
        return sp.eye(len(x_ref) + len(x_inf), format="csr", dtype=np.float32)

    monkeypatch.setattr(tdstg_graph, "compute_dstg_adj", spy)
    tdstg_graph.dstg_link_graph(x_ps.astype(np.float32), x_real.astype(np.float32), device=CPU)
    assert seen["dtypes"] == (np.float64, np.float64)


# --------------------------------------------------------------------------
# stdGCN's graphs
# --------------------------------------------------------------------------

def _jax_knn(q, x, k):
    d, i = jneighbors._knn_block(np.asarray(q, np.float32), np.asarray(x, np.float32), k)
    return np.asarray(d), np.asarray(i)


@pytest.fixture
def shared_neighbours(monkeypatch):
    """The port's stdGCN builders take JAX's kNN and PCA (their answers at
    float32 rounding differ: the distance matrix cancels, and the PCA is a
    different SVD), so that the assembly is compared on the same inputs."""
    monkeypatch.setattr(tstdgcn, "_knn", lambda q, x, k, device: _jax_knn(q, x, min(k, len(x))))

    def pca(x, n, seed=0):
        res = jlinalg.pca(x.cpu().numpy(), n, seed=seed)
        return PCAResult(*(torch.from_numpy(np.array(a)) for a in res))

    monkeypatch.setattr(tstdgcn, "pca", pca)


def _assert_same_graph(got, want):
    want = sp.csr_matrix(np.asarray(want)) if not sp.issparse(want) else want
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal((got != 0).toarray(), (want != 0).toarray())
    np.testing.assert_allclose(got.toarray(), want.toarray(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("link_method,threshold", [("soft", None), ("hard", None),
                                                    ("soft", 1.2)])
def test_intra_dist_adj_matches_jax(shared_neighbours, link_method, threshold):
    coords = deconvo_case(seed=7)[4]
    coords[5] = coords[9]  # two spots at one place: a zero distance off the self column
    want = jstdgcn.intra_dist_adj(coords, 6, link_method, threshold)
    got = tstdgcn.intra_dist_adj(coords, 6, link_method, threshold, device=CPU)
    _assert_same_graph(got, want)


def test_find_mutual_nn_and_inter_adj_match_jax(shared_neighbours):
    rng = np.random.default_rng(8)
    real, pseudo = rng.standard_normal((40, 6)), rng.standard_normal((55, 6))
    want = jstdgcn.find_mutual_nn(real, pseudo, 5, 7)
    got = tstdgcn.find_mutual_nn(real, pseudo, 5, 7, device=CPU)
    assert [tuple(p) for p in got.tolist()] == want and len(want) > 0
    _assert_same_graph(tstdgcn.inter_adj(real, pseudo, 5, device=CPU),
                       jstdgcn.inter_adj(real, pseudo, 5))


@pytest.mark.parametrize("pca_dim", [50, 5])
def test_intra_exp_adj_matches_jax(shared_neighbours, pca_dim):
    x = deconvo_case(seed=9)[0][:70]
    _assert_same_graph(tstdgcn.intra_exp_adj(x, 4, pca_dim, device=CPU),
                       jstdgcn.intra_exp_adj(x, 4, pca_dim))


@pytest.mark.parametrize("method", ["pca", None])
def test_build_stdgcn_adjacencies_matches_jax(shared_neighbours, method):
    x_ps, x_real = _spots(seed=10, n_pseudo=50)
    feat = np.log1p(np.concatenate([x_ps, x_real])).astype(np.float32)
    coords = deconvo_case(seed=10)[4]
    kw = dict(inter_k=8, intra_exp_k=4, space_k=6, integration_method=method,
              integration_dim=10)
    want = jstdgcn.build_stdgcn_adjacencies(feat, coords, 50, **kw)
    got = tstdgcn.build_stdgcn_adjacencies(feat, coords, 50, device=CPU, **kw)
    for g, w in zip(got, want):
        _assert_same_graph(g, w)
        assert (g != g.T).nnz == 0 or np.abs(g - g.T).max() < 1e-6


def test_graph_helpers_match_jax():
    rng = np.random.default_rng(11)
    blk = sp.random(6, 6, density=0.4, random_state=1, dtype=np.float32)
    for which in ("pseudo", "real"):
        want = jstdgcn._expand_block(blk.toarray(), which, 6, 6)
        got = tstdgcn.A_intra_transfer(blk, which, 6, 4 + 2)
        np.testing.assert_array_equal(got.toarray(), want)
    adj = rng.random((9, 9)).astype(np.float32) * (rng.random((9, 9)) < 0.4)
    _assert_same_graph(tstdgcn.adj_normalize(adj), jstdgcn.adj_normalize(adj))
    _assert_same_graph(tstdgcn.adj_normalize(sp.csr_matrix(adj)), jstdgcn.adj_normalize(adj))
    assert tstdgcn.get_idx(10, 4) == jstdgcn.get_idx(10, 4)


def test_data_integration_matches_jax(shared_neighbours):
    feat = np.log1p(deconvo_case(seed=12)[0][:90])
    for method in ("pca", None):
        want = jstdgcn.data_integration(feat, 40, method=method, min_dim=10)
        got = tstdgcn.data_integration(feat, 40, method=method, min_dim=10, device=CPU)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    # ComBat over the pseudo and real blocks first (float64 inside, float32 out)
    for method in ("pca", None):
        want = jstdgcn.data_integration(feat, 40, method=method, min_dim=10,
                                        batch_removal="combat")
        got = tstdgcn.data_integration(feat, 40, method=method, min_dim=10,
                                       batch_removal="combat", device=CPU)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="batch removal"):
        tstdgcn.data_integration(feat, 40, batch_removal="harmony", device=CPU)


# --------------------------------------------------------------------------
# dstg_preprocess against the JAX pipeline
# --------------------------------------------------------------------------

def test_dstg_preprocess_matches_jax_pipeline():
    """JAX's ``DSTG.preprocessing_pipeline()`` with the two repairs the port
    makes (see dstg.py): the profile of the labelled reference split, and the
    reference cells removed before the PCA and the graph. JAX's container is
    then ordered [real; pseudo] and its graph [pseudo; real]."""
    x_ref, labels, x_spots, _, _ = deconvo_case(seed=13, n_ref=200, n_spots=70)
    data = _container(x_ref, labels, x_spots)
    pipe = JDSTG.preprocessing_pipeline(n_pseudo=60, k_filter=30, num_cc=10)
    steps = list(pipe.transforms)
    steps[1].split_name = "ref"
    steps.insert(3, RemoveSplit(split_name="ref"))
    for step in steps:
        step(data)
    got = dstg_preprocess(x_ref, labels, x_spots, n_pseudo=60, k_filter=30, num_cc=10,
                          device=CPU)
    names = list(data.data.var_names)
    assert [f"g{i}" for i in np.nonzero(got.genes)[0]] == names
    order = np.concatenate([data.get_split_idx("pseudo"), data.get_split_idx("test")])
    want_x = np.asarray(data.data.obsm["CellPCA"])[order]
    assert got.x.shape == want_x.shape
    np.testing.assert_allclose(got.x, want_x, atol=1e-4 * np.abs(want_x).max())
    want_y = _jax_portions(x_ref, labels, 60, 2, 10, 0).to_numpy()
    np.testing.assert_array_equal(got.y[:60], want_y.astype(np.float32))
    assert not got.y[60:].any() and got.cell_types == sorted(set(labels))
    want_adj = data.data.obsp["DSTGraph"]
    _assert_same_graph(got.adj, want_adj)


def test_graph_entry_points_raise_without_a_card_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x_ref, labels, x_spots, _, coords = deconvo_case(seed=14)
    feat = np.log1p(np.concatenate([x_spots[:30], x_spots])).astype(np.float32)
    calls = {
        "dstg_preprocess": lambda **kw: dstg_preprocess(x_ref, labels, x_spots, n_pseudo=20,
                                                        k_filter=10, num_cc=5, **kw),
        "dstg_link_graph": lambda **kw: tdstg_graph.dstg_link_graph(x_spots[:30], x_spots, num_cc=5, **kw),
        "build_stdgcn_adjacencies": lambda **kw: tstdgcn.build_stdgcn_adjacencies(
            feat, coords, 30, integration_dim=5, **kw),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="device='auto'"):
            call()
        call(device="cpu")  # runs
