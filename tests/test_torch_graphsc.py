"""Port parity for the graph-sc slice: normalize, binary_ce_logits, the cell
filters and cell_ranger HVG, the standardized weighted PCA, WeightedGraphConv,
GCNAE, GraphSC.fit and graphsc_preprocess (dance_tpu_torch.utils.matrix,
utils.loss, sc.pp, transforms.cell_feature, nn.gnn, modules.single_modality.
clustering.graphsc), and the device defaults of the port's entry points.

Inputs are made with numpy from a seed and handed to both packages; flax
weights are copied into the torch modules (graphsc_flax_to_torch). The JAX
BSR paths run their Pallas kernels in interpret mode on the CPU. Tolerances:
masks, bins, graphs and max aggregation exactly; float32 elementwise math at
rtol 1e-6; layer outputs at rtol 1e-5 (sums in another order); PCA features
at 1e-4 (as tests/test_torch_preprocess.py); three-epoch fits at rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dance_tpu.data import AnnData, Data
from dance_tpu.graph import Graph as JGraph
from dance_tpu.modules.single_modality.clustering.graphsc import GCNAE as JGCNAE
from dance_tpu.modules.single_modality.clustering.graphsc import GraphSC as JGraphSC
from dance_tpu.modules.single_modality.clustering.graphsc import run_leiden as jrun_leiden
from dance_tpu.nn.gnn import WeightedGraphConv as JWeightedGraphConv
from dance_tpu.ops import pallas_kernels as jpk
from dance_tpu.ops.sparse import csr_from_scipy as jcsr_from_scipy
from dance_tpu.sc import pp as jpp
from dance_tpu.utils.loss import binary_ce_logits as jbce
from dance_tpu.utils.matrix import normalize as jnormalize
from dance_tpu_torch.graph import Graph
from dance_tpu_torch.modules.single_modality.cell_type_annotation import ScDeepSort
from dance_tpu_torch.modules.single_modality.clustering import (GCNAE, GraphSC,
                                                                graphsc_preprocess, run_leiden)
from dance_tpu_torch.modules.spatial.spatial_domain import Stagate
from dance_tpu_torch.nn.gnn import WeightedGraphConv
from dance_tpu_torch.ops import bsr as tbsr
from dance_tpu_torch.ops.cluster import kmeans
from dance_tpu_torch.ops.sparse import csr_from_scipy
from dance_tpu_torch.sc import pp as tpp
from dance_tpu_torch.transforms import weighted_feature_pca
from dance_tpu_torch.utils.loss import binary_ce_logits
from dance_tpu_torch.utils.matrix import normalize
from dance_tpu_torch.utils.params import graphsc_flax_to_torch

CPU = torch.device("cpu")


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _counts(n=240, g=320, seed=0, density=0.3, fold=4.0, frac=0.1):
    """Raw counts of cells in three types: gene-specific Poisson rates, a
    fraction ``frac`` of the genes up ``fold`` times in each type, some genes
    silent."""
    rng = np.random.default_rng(seed)
    types = rng.integers(0, 3, n)
    rates = rng.gamma(0.6, 2.0, g) * (rng.random(g) > 0.05)
    fold = np.where(rng.random((3, g)) < frac, fold, 1.0)
    lam = fold[types] * rates[None] * rng.gamma(3.0, 1 / 3, (n, 1))
    counts = rng.poisson(lam) * (rng.random((n, g)) < density)
    return counts.astype(np.float32), types


def _graphs(seed=0, n_cells=60, n_genes=25, dim=8, density=0.3):
    rng = np.random.default_rng(seed)
    expr = sp.random(n_cells, n_genes, density=density, random_state=seed, dtype=np.float32,
                     format="csr")
    cf, gf = rng.random((n_cells, dim), dtype=np.float32), rng.random((n_genes, dim),
                                                                      dtype=np.float32)
    return (JGraph.from_cell_feature_matrix(expr, cf, gf, normalize_edges=False),
            Graph.from_cell_feature_matrix(expr, cf, gf, normalize_edges=False), rng)


# --------------------------------------------------------------------------
# normalize, BCE
# --------------------------------------------------------------------------


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("mode", ["normalize", "standardize", "minmax", "l2"])
def test_normalize_matches_jax(mode, axis):
    # positive, as expression is: sums of signed values near 0 would amplify
    # the summation order
    x = np.random.default_rng(1).gamma(1.0, 1.0, (30, 12)).astype(np.float32)
    x[:, 3] = 0.0  # a zero column: its divisor becomes 1
    x[4] = 2.5     # a constant row
    for eps in (-1.0, 0.5):
        want = jnormalize(x, mode=mode, axis=axis, eps=eps)
        got = normalize(x, mode=mode, axis=axis, eps=eps)
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    on_tensor = normalize(torch.from_numpy(x), mode=mode, axis=axis)
    np.testing.assert_allclose(on_tensor.numpy(), jnormalize(x, mode=mode, axis=axis),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(normalize(sp.csr_matrix(x), mode=mode, axis=axis),
                                  normalize(x, mode=mode, axis=axis))


def test_normalize_rejects_unknown_mode():
    with pytest.raises(ValueError, match="Unknown normalization mode"):
        normalize(np.ones((2, 2)), mode="zscore")


@pytest.mark.parametrize("pos_weight", [None, 2.5, 40.0])
def test_binary_ce_logits_matches_jax(pos_weight):
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((50, 50)) * 15).astype(np.float32)
    logits[0, :5] = [25.0, 60.0, -30.0, -90.0, 21.0]  # where F.softplus would switch to x
    target = (rng.random((50, 50)) < 0.2).astype(np.float32)
    want = float(jbce(jnp.asarray(logits), jnp.asarray(target), pos_weight=pos_weight))
    got = float(binary_ce_logits(torch.from_numpy(logits), torch.from_numpy(target),
                                 pos_weight=pos_weight))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    sp_port = torch.logaddexp(torch.tensor([25.0, 60.0]), torch.tensor(0.0)).numpy()
    np.testing.assert_allclose(sp_port, np.asarray(jax.nn.softplus(jnp.array([25.0, 60.0]))),
                               rtol=1e-7)


# --------------------------------------------------------------------------
# sc.pp: filters and cell_ranger HVG
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("kind", ["min_counts", "min_genes", "max_counts", "max_genes"])
def test_filter_cells_matches_jax(kind, sparse):
    counts, _ = _counts(seed=3)
    counts[7] = 0
    x = sp.csr_matrix(counts) if sparse else counts
    metric = counts.sum(1) if kind.endswith("counts") else (counts > 0).sum(1)
    value = 1 if kind == "min_counts" else int(np.median(metric))
    want = jpp.filter_cells(AnnData(X=x), inplace=False, **{kind: value})
    got = tpp.filter_cells(x, **{kind: value})
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert not got[0].all() and got[0].any()


@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("kind", ["min_counts", "min_cells", "max_counts", "max_cells"])
def test_filter_genes_matches_jax(kind, sparse):
    counts, _ = _counts(seed=4)
    x = sp.csr_matrix(counts) if sparse else counts
    metric = counts.sum(0) if kind.endswith("counts") else (counts > 0).sum(0)
    value = 3 if kind == "min_counts" else int(np.median(metric))
    want = jpp.filter_genes(AnnData(X=x), inplace=False, **{kind: value})
    got = tpp.filter_genes(x, **{kind: value})
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert not got[0].all() and got[0].any()


def test_filters_need_exactly_one_threshold():
    with pytest.raises(ValueError, match="exactly one"):
        tpp.filter_cells(np.ones((3, 3)))
    with pytest.raises(ValueError, match="exactly one"):
        tpp.filter_genes(np.ones((3, 3)), min_counts=1, min_cells=1)


@pytest.mark.parametrize("n_top_genes", [50, None])
@pytest.mark.parametrize("sparse", [True, False])
def test_cell_ranger_hvg_matches_jax(sparse, n_top_genes):
    counts, _ = _counts(seed=5)
    x = tpp.log1p(tpp.normalize_total(sp.csr_matrix(counts) if sparse else counts))
    want = jpp.highly_variable_genes(AnnData(X=x), flavor="cell_ranger", n_top_genes=n_top_genes,
                                     max_mean=4, inplace=False)
    got = tpp.highly_variable_genes(x, flavor="cell_ranger", n_top_genes=n_top_genes,
                                    max_mean=4)
    for key in ("highly_variable", "means", "dispersions", "dispersions_norm"):
        assert got[key].dtype == want[key].to_numpy().dtype, key
        np.testing.assert_array_equal(got[key], want[key].to_numpy(), err_msg=key)
    assert 0 < got["highly_variable"].sum() < x.shape[1]


def test_hvg_seurat_flavor_not_ported():
    """The seurat flavour is ported now (the port's default, as JAX's; its
    parity: tests/test_torch_sc_pp.py): on a constant matrix every
    dispersion is NaN and no gene is kept, as in JAX; an unknown flavour
    raises."""
    ones = np.ones((4, 4), np.float32)
    got = tpp.highly_variable_genes(ones, flavor="seurat")
    want = jpp.highly_variable_genes(AnnData(X=ones), flavor="seurat", inplace=False)
    for key in ("highly_variable", "dispersions_norm"):
        np.testing.assert_array_equal(got[key], want[key].to_numpy())
    assert not got["highly_variable"].any()
    with pytest.raises(ValueError, match="flavor"):
        tpp.highly_variable_genes(ones, flavor="pearson")


def test_weighted_feature_pca_standardize_matches_jax():
    from dance_tpu.transforms import WeightedFeaturePCA

    counts, types = _counts(n=80, g=60, seed=6)
    x = tpp.normalize_total(tpp.log1p(counts), target_sum=1)
    data = Data(AnnData(X=x.copy(), obs={"cell_type": types.astype(str)}), train_size=60)
    WeightedFeaturePCA(n_components=10, split_name="train", feat_norm_mode="standardize")(data)
    cell_feat, gene_feat = weighted_feature_pca(data.get_x("train"), x, 10,
                                                feat_norm_mode="standardize", device="cpu")
    np.testing.assert_allclose(gene_feat, data.data.varm["WeightedFeaturePCA"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(cell_feat, data.data.obsm["WeightedFeaturePCA"], rtol=1e-4,
                               atol=1e-4)


# --------------------------------------------------------------------------
# WeightedGraphConv and GCNAE with transferred weights
# --------------------------------------------------------------------------


def _conv_pair(jgraph, norm, in_dim=8, out_dim=16, seed=0):
    jconv = JWeightedGraphConv(out_dim, norm=norm)
    jadj = jcsr_from_scipy(jgraph.adj)
    x = jnp.asarray(jgraph.ndata["features"])
    params = jconv.init(jax.random.key(seed), jadj, x)["params"]
    tconv = WeightedGraphConv(in_dim, out_dim, norm=norm)
    rng = np.random.default_rng(seed)
    params = {"Dense_0": {"kernel": np.asarray(params["Dense_0"]["kernel"])},
              "bias": rng.standard_normal(out_dim).astype(np.float32)}  # a nonzero bias
    tconv.load_state_dict({"linear.weight": torch.from_numpy(params["Dense_0"]["kernel"].T.copy()),
                           "bias": torch.from_numpy(params["bias"])})
    return jconv, params, tconv


@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
@pytest.mark.parametrize("norm", ["none", "both", "right"])
def test_weighted_graph_conv_csr_matches_jax(norm, agg):
    jg, tg, _ = _graphs(1)
    jconv, params, tconv = _conv_pair(jg, norm)
    x = jg.ndata["features"]
    want = np.asarray(jconv.apply({"params": params}, jcsr_from_scipy(jg.adj), jnp.asarray(x),
                                  agg=agg))
    got = tconv(csr_from_scipy(tg.adj), torch.from_numpy(x), agg=agg).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
def test_weighted_graph_conv_bsr_matches_jax(agg):
    jg, tg, _ = _graphs(2, n_cells=200, n_genes=90)
    jconv, params, tconv = _conv_pair(jg, "none")
    x = jg.ndata["features"]
    deg = np.diff(jg.adj.indptr).astype(np.float32)
    want = np.asarray(jconv.apply({"params": params}, jpk.bsr_from_scipy(jg.adj),
                                  jnp.asarray(x), agg=agg, degrees=jnp.asarray(deg)))
    got = tconv(tg.to_bsr(device="cpu"), torch.from_numpy(x), agg=agg,
                degrees=torch.from_numpy(deg)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    csr = tconv(csr_from_scipy(tg.adj), torch.from_numpy(x), agg=agg).detach().numpy()
    np.testing.assert_allclose(got, csr, rtol=1e-5, atol=1e-6)


def test_weighted_graph_conv_norm_needs_csr():
    _, tg, _ = _graphs(3)
    with pytest.raises(TypeError, match="CSR"):
        WeightedGraphConv(8, 4, norm="both")(tg.to_bsr(device="cpu"),
                                             torch.from_numpy(tg.ndata["features"]))
    with pytest.raises(ValueError, match="norm must be"):
        WeightedGraphConv(8, 4, norm="left")


def _gcnae_pair(jgraph, seed=0, **kw):
    jm = JGCNAE(**kw)
    jadj = jcsr_from_scipy(jgraph.adj)
    x = jnp.asarray(jgraph.ndata["features"])
    key = jax.random.key(seed)
    params = jm.init({"params": key, "dropout": key}, jadj, x)["params"]
    tm = GCNAE(x.shape[1], **kw)
    tm.load_state_dict(graphsc_flax_to_torch(_np_tree(params)))
    return jm, params, tm


@pytest.mark.parametrize("kw", [{}, {"n_layers": 2, "hidden_2": 6, "agg": "mean"},
                                {"hidden_1": 0, "hidden_2": 5, "agg": "max"}])
def test_gcnae_forward_matches_jax(kw):
    kw = {"hidden_dim": 16, "hidden_1": 12, **kw}
    jg, tg, _ = _graphs(4)
    jm, params, tm = _gcnae_pair(jg, **kw)
    tm.eval()
    x = jg.ndata["features"]
    jadj, jemb = jm.apply({"params": params}, jcsr_from_scipy(jg.adj), jnp.asarray(x))
    with torch.no_grad():
        tadj, temb = tm(csr_from_scipy(tg.adj), torch.from_numpy(x))
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tadj.numpy(), np.asarray(jadj), rtol=1e-5, atol=1e-6)
    assert set(tm.state_dict()) == set(graphsc_flax_to_torch(_np_tree(params)))


def test_gcnae_dropout_keeps_and_scales_like_flax():
    _, tg, _ = _graphs(5)
    tm = GCNAE(8, hidden_dim=16, hidden_1=12, dropout=0.25)
    x = torch.ones((20000, 8))
    from dance_tpu_torch.nn.gnn import flax_dropout  # graph-sc's dropout, shared with scMoGNN
    out = flax_dropout(x, 0.25, torch.Generator().manual_seed(0))
    torch.testing.assert_close(torch.unique(out), torch.tensor([0.0, 1.0]) / 0.75, rtol=0,
                               atol=0)
    assert abs(float((out == 0).float().mean()) - 0.25) < 0.01
    feats = torch.from_numpy(tg.ndata["features"])
    tm.train()
    a = tm.encode(csr_from_scipy(tg.adj), feats, generator=torch.Generator().manual_seed(1))
    b = tm.encode(csr_from_scipy(tg.adj), feats, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    tm.eval()
    c = tm.encode(csr_from_scipy(tg.adj), feats)
    assert not torch.equal(a, c)


# --------------------------------------------------------------------------
# GraphSC.fit against JAX
# --------------------------------------------------------------------------


@pytest.mark.parametrize("use_bsr,agg", [(False, "sum"), (True, "sum"), (True, "mean"),
                                         (False, "max")])
def test_graphsc_fit_matches_jax(use_bsr, agg):
    """Three Adam epochs from the same weights, dropout off: parameters and
    the cell embedding ``z``."""
    jg, tg, _ = _graphs(6, n_cells=150, n_genes=40)
    kw = {"agg": agg, "hidden_dim": 16, "hidden_1": 12, "dropout": 0.0, "n_clusters": 3}
    jm = JGraphSC(seed=0, **kw)
    dg = jg.to_device()
    jadj = jpk.bsr_from_scipy(jg.adj) if use_bsr else dg.adj
    deg = jnp.asarray(np.diff(jg.adj.indptr).astype(np.float32)) if agg == "mean" else None
    key = jax.random.key(0)
    jm.params = jm.model.init({"params": key, "dropout": key}, jadj, dg.ndata["features"],
                              degrees=deg)["params"]
    init = graphsc_flax_to_torch(_np_tree(jm.params))
    jm.fit(jg, epochs=3, lr=1e-2, use_bsr=use_bsr)

    tm = GraphSC(seed=0, device="cpu", **kw)
    tm.fit(tg, epochs=0, use_bsr=use_bsr)
    tm.model.load_state_dict(init)
    tm.fit(tg, epochs=3, lr=1e-2, use_bsr=use_bsr)
    want = graphsc_flax_to_torch(_np_tree(jm.params))
    got = tm.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert tm.z.shape == (150, 12)
    np.testing.assert_allclose(tm.z, np.asarray(jm.z), rtol=1e-4, atol=1e-4)
    assert len(tm.history) == 3 and all(np.isfinite(h["loss"]) for h in tm.history)


def test_graphsc_fit_without_features_matches_jax():
    """Without node features both packages take the adjacency rows against
    the gene nodes as features (graphsc.py:198-201)."""
    jg, tg, _ = _graphs(11, n_cells=70, n_genes=20)
    del jg.ndata["features"], tg.ndata["features"]
    kw = {"hidden_dim": 8, "hidden_1": 6, "dropout": 0.0, "n_clusters": 2}
    jm = JGraphSC(seed=0, **kw)
    feats = jnp.asarray(np.asarray(jg.adj[:, :20].todense(), np.float32))
    key = jax.random.key(0)
    jm.params = jm.model.init({"params": key, "dropout": key}, jg.to_device().adj,
                              feats)["params"]
    init = graphsc_flax_to_torch(_np_tree(jm.params))
    jm.fit(jg, epochs=2, lr=1e-2, use_bsr=False)
    tm = GraphSC(seed=0, device="cpu", **kw)
    tm.fit(tg, epochs=0, use_bsr=False)
    tm.model.load_state_dict(init)
    tm.fit(tg, epochs=2, lr=1e-2, use_bsr=False)
    np.testing.assert_allclose(tm.z, np.asarray(jm.z), rtol=1e-4, atol=1e-4)


def test_graphsc_fit_counts_spmm_and_bsr_rules(monkeypatch):
    calls = {"spmm": 0, "max": 0}
    spmm, mx = tbsr.bsr_spmm, tbsr.bsr_spmm_max

    def count(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(tbsr, "bsr_spmm", count("spmm", spmm))
    _, tg, _ = _graphs(7)
    m = GraphSC(hidden_dim=8, hidden_1=6, n_clusters=2, device="cpu")
    m.fit(tg, epochs=3, use_bsr=True)
    # per epoch one forward SpMM and one Aᵀḡ backward; one more for z
    assert calls["spmm"] == 3 * 2 + 1
    m.fit(tg, epochs=1, use_bsr="auto")  # CSR on the CPU, as JAX's "auto" off the TPU
    assert calls["spmm"] == 3 * 2 + 1
    with pytest.raises(ValueError, match="use_bsr must be"):
        m.fit(tg, epochs=1, use_bsr="sometimes")
    mmax = GraphSC(agg="max", hidden_dim=8, hidden_1=6, n_clusters=2, device="cpu")
    with pytest.raises(ValueError, match="use_bsr supports"):
        mmax.fit(tg, epochs=1, use_bsr=True)
    monkeypatch.setattr(tbsr, "bsr_spmm_max", count("max", mx))
    mmax.fit(tg, epochs=2, use_bsr="auto")  # the CSR segment max, as in JAX
    assert calls["max"] == 0 and len(mmax.history) == 2
    with pytest.raises(ValueError, match="agg must be"):
        GraphSC(agg="min", device="cpu")


def test_graphsc_eval_epoch_keeps_best_ari_and_predicts():
    counts, types = _counts(n=150, g=120, seed=8)
    g, cells = graphsc_preprocess(counts, n_top_genes=60, n_components=10, device="cpu")
    y = types[cells]
    m = GraphSC(hidden_dim=16, hidden_1=12, n_clusters=3, device="cpu", seed=1)
    m.fit(g, y, epochs=4, lr=1e-3, eval_epoch=True)
    aris = [h["ari"] for h in m.history]
    best = int(np.argmax(aris))
    labels = kmeans(torch.from_numpy(m.z), 3, n_init=10, seed=5).labels.numpy()
    from dance_tpu_torch.utils import ari
    assert ari(y, labels) == pytest.approx(aris[best])
    pred = m.predict()
    assert pred.shape == (len(cells),) and ((pred >= 0) & (pred < 3)).all()
    assert m.score(None, y) == pytest.approx(ari(y, pred))
    assert m.get_latent() is m.z
    # Leiden on the same z: JAX's labels (15-NN connectivity graph, seed 0)
    leiden, jleiden = GraphSC(cluster_method="leiden", device="cpu"), \
        JGraphSC(cluster_method="leiden")
    leiden.z = jleiden.z = m.z
    np.testing.assert_array_equal(leiden.predict(), jleiden.predict())
    np.testing.assert_array_equal(run_leiden(m.z, n_neighbors=10, seed=3),
                                  jrun_leiden(m.z, n_neighbors=10, seed=3))
    # and as the per-epoch score: the ARI of the labels on each epoch's z
    lm = GraphSC(hidden_dim=16, hidden_1=12, cluster_method="leiden", device="cpu", seed=1)
    lm.fit(g, y, epochs=2, lr=1e-3, eval_epoch=True)
    assert len(lm.history) == 2
    assert max(h["ari"] for h in lm.history) == pytest.approx(ari(y, lm.predict()))


# --------------------------------------------------------------------------
# graphsc_preprocess against the JAX pipeline
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sparse", [True, False])
def test_graphsc_preprocess_matches_jax_pipeline(sparse):
    # strong types: the leading principal components are well separated, so
    # float32 rounding does not rotate them
    counts, types = _counts(n=200, g=260, seed=9, fold=10.0, frac=0.3)
    counts[11] = 0                 # a cell without counts is dropped
    counts[:, 5] = 0               # genes under 3 counts are dropped
    counts[0, 6], counts[:, 6] = 2, 0
    x = sp.csr_matrix(counts) if sparse else counts
    adata = AnnData(X=x.copy(), obs={"idx": np.arange(200), "Group": types},
                    var={"gidx": np.arange(260)})
    data = Data(adata)
    JGraphSC.preprocessing_pipeline(n_top_genes=80, n_components=4, log_level="WARNING")(data)
    jg = data.data.uns["CellFeatureGraph"]
    tg, cells = graphsc_preprocess(x, n_top_genes=80, n_components=4, device="cpu")
    np.testing.assert_array_equal(cells, data.data.obs["idx"].to_numpy())
    assert 11 not in cells and tg.info == jg.info
    assert tg.info["num_genes"] == data.data.n_vars
    for field in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(tg.adj, field), getattr(jg.adj, field))
    np.testing.assert_allclose(tg.ndata["features"], jg.ndata["features"], rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(ValueError, match="normalization option"):
        graphsc_preprocess(x, normalize_weights="l1", device="cpu")


def test_graphsc_flax_to_torch_rejects_unknown_names():
    with pytest.raises(KeyError, match="unexpected"):
        graphsc_flax_to_torch({"LayerNorm_0": {}})


# --------------------------------------------------------------------------
# Entry points run on the card unless the CPU is named
# --------------------------------------------------------------------------


def test_entry_points_raise_without_a_card_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tg, _ = _graphs(10)
    x = np.random.default_rng(10).random((20, 6)).astype(np.float32)
    calls = {
        "ScDeepSort": lambda **kw: ScDeepSort(dim_in=8, dim_hid=8, num_layers=1, **kw),
        "Stagate": lambda **kw: Stagate(hidden_dims=(6, 4, 2), **kw),
        "GraphSC": lambda **kw: GraphSC(**kw),
        "weighted_feature_pca": lambda **kw: weighted_feature_pca(x, x, 3, **kw),
        "Graph.to_device": lambda **kw: tg.to_device(**kw),
        "Graph.to_bsr": lambda **kw: tg.to_bsr(**kw),
        "Graph.to_dense_adj": lambda **kw: tg.to_dense_adj(**kw),
        "Graph.to_adaptive_bsr": lambda **kw: tg.to_adaptive_bsr(**kw),
        "kmeans(array)": lambda **kw: kmeans(x, 2, n_init=1, **kw),
        "graphsc_preprocess": lambda **kw: graphsc_preprocess(x * 10, n_top_genes=3,
                                                              n_components=2, **kw),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        call(device="cpu")  # runs
    # a tensor still runs where it lies
    assert kmeans(torch.from_numpy(x), 2, n_init=1).labels.device == CPU
