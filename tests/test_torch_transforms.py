"""Port parity for the transform and layer surface of ROADMAP Queue 1
item 9: the cell features (dance_tpu_torch.transforms.cell_feature), SC3
(sc3_feature), RESEPT's graph (graph.resept_graph), the graph helpers
(graph_construct), the preprocessing utilities (preprocess), the filters
(filter), ``MaskData`` (mask), ``mape`` and ``device_ari`` (utils),
the CSR helpers (ops.sparse) and STAGATE's ``pretrain_path``.

Inputs are made with numpy from a seed (at most 300 cells x 120 genes) and
handed to both packages; the JAX side runs on ``dance_tpu.data.AnnData``.
Tolerances, as the arithmetic allows:

- numpy on both sides (the masks, samplers, ``MaskedArray``, SC3's column
  choice, the batch statistics, the scanpy filters, Giotto's scores, the
  QC filter, the graph helpers on scipy): bit-equal;
- top-k selections (``FilterGenesRegression``'s ``argpartition``): equal as
  sets;
- SVD-based embeddings (``CellSVD``, ``WeightedFeatureSVD``,
  ``CellSparsePCA``, ``lsiTransformer``) on spectra with clear gaps: rtol
  1e-4 of the largest value, up to each column's sign;
- float32 device products (projections, propagation, RESEPT's weights):
  rtol 1e-5, atol 1e-6;
- ``device_ari`` against the exact host ``ari``: 1e-6.
"""

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from dance_tpu.data import AnnData, Data
from dance_tpu.ops import cluster as jcluster
from dance_tpu.ops.neighbors import knn_graph as jknn_graph
from dance_tpu.transforms import cell_feature as JC
from dance_tpu.transforms import filter as JF
from dance_tpu.transforms import graph_construct as JG
from dance_tpu.transforms import mask as JM
from dance_tpu.transforms import preprocess as JP
from dance_tpu.transforms import sc3_feature as JS
from dance_tpu.transforms.graph.resept_graph import RESEPTGraph as JRESEPTGraph
from dance_tpu.utils import metrics as jmetrics
from dance_tpu_torch.modules.spatial.spatial_domain.stagate import Stagate
from dance_tpu_torch.ops import sparse as tsparse
from dance_tpu_torch.transforms import cell_feature as TC
from dance_tpu_torch.transforms import filter as TF
from dance_tpu_torch.transforms import graph_construct as TG
from dance_tpu_torch.transforms import mask as TM
from dance_tpu_torch.transforms import preprocess as TP
from dance_tpu_torch.transforms import sc3_feature as TS
from dance_tpu_torch.transforms.graph import RESEPTGraph
from dance_tpu_torch.utils import ari, mape
from dance_tpu_torch.utils.metrics import device_ari
from torch_cases import typed_counts

CPU = torch.device("cpu")


def low_rank(n=120, g=40, rank=6, seed=0, noise=1e-3):
    """Cells x features of a clear spectrum (gaps of at least 1.5x)."""
    rng = np.random.default_rng(seed)
    u = np.linalg.qr(rng.normal(size=(n, rank)))[0]
    v = np.linalg.qr(rng.normal(size=(g, rank)))[0]
    s = 40.0 * 0.6 ** np.arange(rank)
    x = (u * s) @ v.T + 5.0 + noise * rng.normal(size=(n, g))
    return np.abs(x).astype(np.float32)


def assert_up_to_sign(got, want, rtol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    signs = np.sign((got * want).sum(0))
    signs[signs == 0] = 1
    scale = np.abs(want).max()
    np.testing.assert_allclose(got * signs, want, atol=rtol * scale)


def _data(x, **obs):
    return Data(AnnData(np.asarray(x).copy(), obs=pd.DataFrame(obs) if obs else None))


# --------------------------------------------------------------------------
# cell features
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_components", [4, 0.9])
def test_weighted_feature_svd_matches_jax(n_components):
    x = low_rank(seed=1)
    data = _data(x)
    JC.WeightedFeatureSVD(n_components=n_components, feat_norm_mode="standardize")(data)
    t = TC.WeightedFeatureSVD(n_components=n_components, feat_norm_mode="standardize",
                              save_info=True, device=CPU)
    cell, gene = t(x)
    assert_up_to_sign(gene, data.data.varm["WeightedFeatureSVD"])
    assert_up_to_sign(cell, data.data.obsm["WeightedFeatureSVD"])
    assert t.info["svd_components"].shape == (gene.shape[1], x.shape[0])


def test_evr_components_matches_jax():
    x = low_rank(seed=2)
    for ratio in (0.5, 0.8, 0.95, 0.999):
        assert TC._evr_components(torch.from_numpy(x), ratio) == JC._evr_components(x, ratio)


@pytest.mark.parametrize("n_components", [5, 0.95])
def test_cell_svd_matches_jax(n_components):
    x = low_rank(seed=3)
    data = _data(x)
    JC.CellSVD(n_components=n_components)(data)
    t = TC.CellSVD(n_components=n_components, device=CPU)
    assert_up_to_sign(t(x), data.data.obsm["CellSVD"])
    assert_up_to_sign(t.info["svd_components"].T, data.data.uns["svd_components"].T)


def test_cell_sparse_pca_matches_jax():
    x = low_rank(seed=4)
    data = _data(x)
    JC.CellSparsePCA(n_components=3, alpha=0.5)(data)
    emb, loadings = TC.CellSparsePCA(n_components=3, alpha=0.5, device=CPU)(x)
    assert_up_to_sign(loadings, data.data.varm["sparse_components"])
    assert_up_to_sign(emb, data.data.obsm["CellSparsePCA"])
    assert (loadings == 0).any()  # the soft threshold zeroes loadings


def test_pca_save_info_matches_jax():
    x = low_rank(seed=5)
    data = _data(x)
    JC.WeightedFeaturePCA(4, save_info=True)(data)
    wf = TC.WeightedFeaturePCA(4, save_info=True, device=CPU)
    wf(x)
    data2 = _data(x)
    JC.CellPCA(4, save_info=True)(data2)
    pca = TC.CellPCA(4, save_info=True, device=CPU)
    pca(x)
    for got, uns in ((wf.info, data.data.uns), (pca.info, data2.data.uns)):
        assert_up_to_sign(got["pca_components"].T, uns["pca_components"].T)
        np.testing.assert_allclose(got["pca_mean"], uns["pca_mean"], rtol=1e-5)
        np.testing.assert_allclose(got["pca_explained_variance"],
                                   uns["pca_explained_variance"], rtol=1e-4)


def test_placeholder_batch_feature_and_projection_match_jax():
    counts, _, _ = typed_counts(n=90, g=30, seed=6)
    counts[:, 0] += 1  # BatchFeature raises on a cell without counts, in both packages
    batches = np.array(["p", "q", "r"])[np.arange(90) % 3]
    data = _data(counts, batch=batches)
    JC.FeatureCellPlaceHolder()(data)
    obsm, varm = TC.FeatureCellPlaceHolder()(counts)
    np.testing.assert_array_equal(obsm, data.data.obsm["FeatureCellPlaceHolder"])
    np.testing.assert_array_equal(varm, data.data.varm["FeatureCellPlaceHolder"])
    JC.BatchFeature(mod=None)(data)
    np.testing.assert_array_equal(TC.BatchFeature()(counts, batches),
                                  data.data.obsm["batch_features"])
    with pytest.raises(ValueError, match="all-zero"):
        TC.BatchFeature()(np.zeros((3, 4)), np.zeros(3))
    JC.GaussRandProjFeature(n_components=8, seed=3)(data)
    import jax

    proj = np.asarray(jax.random.normal(jax.random.key(3), (30, 8))) / np.sqrt(8)
    got = TC.GaussRandProjFeature(n_components=8, device=CPU)(counts, proj=proj)
    np.testing.assert_allclose(got, data.data.obsm["GaussRandProjFeature"], rtol=1e-5,
                               atol=1e-5)
    drawn = TC.GaussRandProjFeature(n_components=8, seed=3, device=CPU)
    np.testing.assert_array_equal(drawn(counts), drawn(counts))


# --------------------------------------------------------------------------
# SC3 and RESEPT
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,d,seed", [(60, None, 9), (400, None, 9), (600, None, 4),
                                      (50, 20, 9), (50, 0, 1)])
def test_sc3_columns_are_numpys_draw(n, d, seed):
    import math

    dd = d if d is not None else math.ceil(n * 0.07) - math.floor(n * 0.04)
    want = (sorted(np.random.default_rng(seed).choice(range(dd), 15, replace=False))
            if dd > 15 else list(range(max(dd, 1))))
    assert TS.sc3_columns(n, d, seed) == want


def test_normalized_laplacian_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.random((20, 20))
    np.testing.assert_allclose(TS.normalized_laplacian(a), JS.normalized_laplacian(a),
                               rtol=1e-14)


def test_sc3_feature_matches_jax(monkeypatch):
    """JAX's k-means (its ``jax.random`` starts) runs inside both transforms,
    so the rest of the pipeline is held to JAX's consensus exactly."""
    counts, _, _ = typed_counts(n=60, g=24, n_types=3, seed=7)
    x = np.log1p(counts)  # d = 3 columns: the draw above 15 is held alone above

    def jax_kmeans(mat, n_clusters, **kw):
        arr = mat.cpu().numpy() if isinstance(mat, torch.Tensor) else np.asarray(mat)
        res = jcluster.kmeans(arr, n_clusters, **kw)
        return res._replace(labels=torch.from_numpy(np.asarray(res.labels)))

    data = _data(x)
    JS.SC3Feature(n_cluster=3)(data)
    monkeypatch.setattr(TS, "kmeans", jax_kmeans)
    got = TS.SC3Feature(n_cluster=3, device=CPU)(x)
    np.testing.assert_array_equal(got, data.data.uns["SC3Feature"])


def test_resept_graph_matches_jax():
    rng = np.random.default_rng(8)
    xy = rng.uniform(0, 100, (150, 2)).astype(np.float32)
    emb = rng.normal(size=(150, 10))
    adata = AnnData(np.zeros((150, 2), np.float32), obsm={"spatial": xy, "CellPCA": emb})
    data = Data(adata)
    JRESEPTGraph(n_neighbors=6)(data)
    got = RESEPTGraph(n_neighbors=6, device=CPU)(xy, emb)
    want = adata.obsp["RESEPTGraph"]
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=1e-12, atol=1e-15)
    plain = RESEPTGraph(n_neighbors=6, device=CPU)(xy)
    assert (plain != jknn_graph(xy, 6, mode="connectivity", include_self=False)).nnz == 0


# --------------------------------------------------------------------------
# graph_construct
# --------------------------------------------------------------------------


def test_graph_construct_matches_jax():
    counts, _, _ = typed_counts(n=80, g=25, seed=9)
    batches = np.arange(80) % 4
    names = [f"g{i}" for i in range(25)]
    pathways = {"p0": ["g1", "g3", "zz"], "p1": ["g3", "g24"], "p2": []}
    assert (TG.construct_pathway_graph(names, pathways)
            != JG.construct_pathway_graph(names, pathways)).nnz == 0
    for norm in (True, False):
        jg, tg = JG.basic_feature_graph(counts, normalize_row=norm), TG.basic_feature_graph(
            counts, normalize_row=norm)
        assert (tg.adj != jg.adj).nnz == 0 and tg.info == jg.info
    np.testing.assert_array_equal(TG.batch_features(counts, batches),
                                  JG.batch_features(counts, batches))
    rng = np.random.default_rng(9)
    adj = sp.random(80, 80, density=0.1, random_state=9, format="csr")
    feat = rng.normal(size=(80, 6)).astype(np.float32)
    for norm in (True, False):
        np.testing.assert_allclose(TG.feature_propagation(adj, feat, n_steps=4, alpha=0.3,
                                                          normalize=norm, device=CPU),
                                   JG.feature_propagation(adj, feat, n_steps=4, alpha=0.3,
                                                          normalize=norm),
                                   rtol=1e-5, atol=1e-6)
    xt = counts[:20]
    ads = [AnnData(counts[:40], obs=pd.DataFrame({"batch": batches[:40]})),
           AnnData(counts[40:], obs=pd.DataFrame({"batch": batches[40:]}))]
    pairs = [(counts[:40], batches[:40]), (counts[40:], batches[40:])]
    np.testing.assert_array_equal(TG.gen_batch_features(pairs), JG.gen_batch_features(ads))
    jg = JG.construct_basic_feature_graph(counts, xt, bf_input=ads)
    tg = TG.construct_basic_feature_graph(counts, xt, bf_input=pairs)
    assert (tg.adj != jg.adj).nnz == 0
    np.testing.assert_array_equal(tg.ndata["bf"], jg.ndata["bf"])
    np.testing.assert_array_equal(TG.construct_basic_feature_graph(counts).ndata["bf"],
                                  JG.construct_basic_feature_graph(counts).ndata["bf"])
    csr = sp.csr_matrix(counts)
    np.testing.assert_array_equal(TG.csr_cosine_similarity(csr), JG.csr_cosine_similarity(csr))
    np.testing.assert_allclose(TG.cosine_similarity_gene(counts.astype(np.float64),
                                                         device=CPU),
                               JG.cosine_similarity_gene(counts.astype(np.float64)),
                               rtol=1e-12, atol=1e-14)
    image = rng.integers(0, 255, (60, 70, 3)).astype(np.float64)
    px, py = rng.integers(0, 60, 30), rng.integers(0, 70, 30)
    np.testing.assert_array_equal(TG.extract_color(px, py, image, beta=9),
                                  JG.extract_color(px, py, image, beta=9))
    for graph_type, para in (("KNNgraph", "euclidean:5"), ("KNNgraph", "cosine:3"),
                             ("KNNgraphPairwise", ":4")):
        ja, je = JG.scGNNgenerateAdj(feat, graph_type, para)
        ta, te = TG.scGNNgenerateAdj(feat, graph_type, para)
        assert te == je and (ta != ja).nnz == 0
    adatas = [AnnData(counts[:40], obs=pd.DataFrame({"batch": batches[:40]})),
              AnnData(counts[40:])]
    for group in (False, True):
        np.testing.assert_array_equal(
            TG.generate_cell_features([counts[:40], counts[40:]], [batches[:40], None],
                                      group_batch=group),
            JG.generate_cell_features(adatas, group_batch=group))


def test_basic_feature_graph_propagation_matches_scmogcn():
    from dance_tpu_torch.modules.multi_modality.joint_embedding.scmogcn import (
        cell_feature_propagation)

    counts, _, _ = typed_counts(n=50, g=20, seed=10)
    g = TG.construct_basic_feature_graph(np.log1p(counts))
    got = TG.basic_feature_graph_propagation(g, layers=3, device=CPU)
    want = cell_feature_propagation(g, layers=3, device=CPU)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="Less than two"):
        TG.basic_feature_graph_propagation(g, layers=2, device=CPU)


# --------------------------------------------------------------------------
# preprocess
# --------------------------------------------------------------------------


def test_tfidf_transformer_matches_jax():
    counts, _, _ = typed_counts(n=60, g=30, seed=11)
    counts[:, 0] += 1
    for x in (counts, sp.csr_matrix(counts)):
        j, t = JP.tfidfTransformer(), TP.tfidfTransformer()
        want, got = j.fit_transform(x), t.fit_transform(x)
        if sp.issparse(want):
            want, got = want.toarray(), got.toarray()
        np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError, match="not fitted"):
        TP.tfidfTransformer().transform(counts)


def test_lsi_transformer_matches_jax():
    rng = np.random.default_rng(12)
    peaks = (rng.random((150, 300)) < 0.03 * (1 + np.arange(300) % 3)).astype(np.float32)
    peaks[:, :6] += (np.arange(150)[:, None] % 3 == np.arange(6)[None, :] % 3)
    peaks = sp.csr_matrix(peaks)
    j = JP.lsiTransformer(n_components=4)
    j.fit(AnnData(peaks, layers={"counts": peaks}))
    want = j.transform(AnnData(peaks, layers={"counts": peaks})).to_numpy()
    t = TP.lsiTransformer(n_components=4, device=CPU)
    got = t.fit_transform(peaks)
    assert got.shape == (150, 4)
    assert_up_to_sign(got[:, :2], want[:, :2])
    np.testing.assert_allclose(t.transform(peaks[:30]), got[:30], rtol=1e-12)
    with pytest.raises(RuntimeError, match="not fitted"):
        TP.lsiTransformer(device=CPU).transform(peaks)


@pytest.mark.parametrize("distr", ["exp", "uniform"])
def test_masked_array_is_jax_bit_for_bit(distr):
    counts, _, _ = typed_counts(n=70, g=20, seed=13)
    j = JP.MaskedArray(counts, distr=distr, dropout=0.2, seed=3)
    t = TP.MaskedArray(counts, distr=distr, dropout=0.2, seed=3)
    j.generate()
    t.generate()
    np.testing.assert_array_equal(t.binMask, j.binMask)
    np.testing.assert_array_equal(t.getMaskedMatrix(), j.getMaskedMatrix())
    np.testing.assert_array_equal(t.getMasked_flat(), j.getMasked_flat())
    assert t.get_Nmasked(4) == j.get_Nmasked(4)
    np.testing.assert_array_equal(t.copy().binMask, j.copy().binMask)


def test_samplers_are_jax_bit_for_bit():
    adj = sp.random(120, 120, density=0.04, random_state=14, format="csr")
    for jcls, tcls, args in ((JP.SubgraphSampler, TP.SubgraphSampler, (30,)),
                             (JP.SAINTSampler, TP.SAINTSampler, (40,)),
                             (JP.SAINTRandomWalkSampler, TP.SAINTRandomWalkSampler, (8, 3))):
        j, t = jcls(adj, *args, seed=5), tcls(adj, *args, seed=5)
        for _ in range(3):
            (jn, js), (tn, ts) = j.sample(), t.sample()
            np.testing.assert_array_equal(tn, jn)
            assert (ts != js).nnz == 0


def test_legacy_filters_match_jax():
    counts, _, _ = typed_counts(n=200, g=60, seed=15)
    counts[:5] = 0
    counts[:, :3] = 0
    names = [("MT-" if i % 11 == 0 else "ERCC" if i % 13 == 0 else "g") + str(i)
             for i in range(60)]
    adata = AnnData(counts.copy())
    JP.prefilter_cells(adata, min_genes=20, max_counts=4000)
    keep, raw = TP.prefilter_cells(counts, min_genes=20, max_counts=4000)
    np.testing.assert_array_equal(counts[keep], np.asarray(adata.X))
    np.testing.assert_allclose(raw, np.asarray(adata.raw.X), rtol=1e-6)
    adata = AnnData(counts.copy())
    JP.prefilter_genes(adata, min_cells=30, max_counts=3000)
    np.testing.assert_array_equal(counts[:, TP.prefilter_genes(counts, min_cells=30,
                                                               max_counts=3000)],
                                  np.asarray(adata.X))
    adata = AnnData(counts.copy(), var=pd.DataFrame(index=names))
    JP.prefilter_specialgenes(adata)
    np.testing.assert_array_equal(np.asarray(names)[TP.prefilter_specialgenes(names)],
                                  np.asarray(adata.var_names))
    with pytest.raises(ValueError, match="Provide one of"):
        TP.prefilter_cells(counts, min_genes=None)
    data = _data(counts)
    JP.filter_data(data, highly_genes=20)
    cells, genes = TP.filter_data(counts, highly_genes=20)
    np.testing.assert_array_equal(counts[cells][:, genes], np.asarray(data.data.X))
    for n in (None, 15):
        for x in (counts, sp.csr_matrix(counts)):
            np.testing.assert_array_equal(TP.geneSelection(x, n=n, verbose=0, atleast=5),
                                          JP.geneSelection(x, n=n, verbose=0, atleast=5))


@pytest.mark.parametrize("size_factors,logtrans,norm", [(True, True, True),
                                                         (False, True, False)])
def test_normalize_adata_matches_jax(size_factors, logtrans, norm):
    counts, _, _ = typed_counts(n=100, g=40, seed=16)
    counts[:3] = 0
    counts[:, :2] = 0
    data = _data(counts)
    JP.normalize_adata(data, size_factors=size_factors, normalize_input=norm,
                       logtrans_input=logtrans)
    out = TP.normalize_adata(counts, size_factors=size_factors, normalize_input=norm,
                             logtrans_input=logtrans)
    np.testing.assert_array_equal(out["X"], np.asarray(data.data.X))
    np.testing.assert_array_equal(out["raw"], np.asarray(data.data.raw.X))
    np.testing.assert_array_equal(out["size_factors"],
                                  np.asarray(data.data.obs["size_factors"], np.float64))
    np.testing.assert_array_equal(counts[out["cells"]][:, out["genes"]], np.asarray(
        data.data.raw.X))


def test_graph_utilities_match_jax(tmp_path):
    rng = np.random.default_rng(17)
    mx = sp.random(30, 30, density=0.2, random_state=17, format="csr")
    mx[3] = 0
    assert (TP.row_normalize(mx) != JP.row_normalize(mx)).nnz == 0
    st = TP.sparse_mx_to_torch_sparse_tensor(mx)
    np.testing.assert_array_equal(st.to_dense().numpy(), mx.toarray().astype(np.float32))
    edges = rng.integers(0, 30, (60, 2))
    from dance_tpu.ops.sparse import csr_to_scipy as jcsr_to_scipy

    path = tmp_path / "edges.txt"
    np.savetxt(path, edges, fmt="%d")
    want = jcsr_to_scipy(JP.load_graph(str(path), np.zeros((30, 2))))
    got = tsparse.csr_to_scipy(TP.load_graph(edges, np.zeros((30, 2))))
    assert (got != want).nnz == 0 and got.dtype == want.dtype
    counts = rng.poisson(3, (20, 8))
    for a, b in zip(TP.calculate_log_library_size(counts),
                    JP.calculate_log_library_size(counts)):
        np.testing.assert_array_equal(a, b)
    counts[4] = 0
    with pytest.raises(ValueError, match="zero reads"):
        TP.calculate_log_library_size(counts)
    mat = rng.normal(size=(12, 9))
    u, v, d = TP.SVD(mat, 4, device=CPU)
    ju, jv, jd = JP.SVD(mat, 4)
    np.testing.assert_allclose(d, jd, rtol=1e-12)
    assert_up_to_sign(u, ju, rtol=1e-10)
    assert_up_to_sign(v, jv, rtol=1e-10)


# --------------------------------------------------------------------------
# filters
# --------------------------------------------------------------------------


@pytest.mark.parametrize("target,kwargs", [
    ("cells", dict(min_counts=0.1, max_genes=0.9)),
    ("cells", dict(min_genes=10, max_counts=2000)),
    ("genes", dict(min_cells=0.2, max_counts=0.95)),
    ("genes", dict(min_counts=5))])
def test_scanpy_filters_match_jax(target, kwargs):
    counts, _, _ = typed_counts(n=120, g=50, seed=18)
    jcls, tcls = ((JF.FilterCellsScanpy, TF.FilterCellsScanpy) if target == "cells"
                  else (JF.FilterGenesScanpy, TF.FilterGenesScanpy))
    data = _data(counts)
    key = "key_n_genes" if target == "cells" else "key_n_cells"
    jcls(**kwargs, key_n_counts="nc", **{key: "ng"})(data)
    keep, n_counts, n_nonzero = tcls(**kwargs)(counts)
    frame = data.data.obs if target == "cells" else data.data.var
    kept = counts[keep] if target == "cells" else counts[:, keep]
    np.testing.assert_array_equal(kept, np.asarray(data.data.X))
    np.testing.assert_array_equal(n_counts[keep], frame["nc"].to_numpy())
    np.testing.assert_array_equal(n_nonzero[keep], frame["ng"].to_numpy())
    with pytest.raises(NotImplementedError):
        TF.FilterScanpy()


def test_scanpy_order_filters_match_jax():
    counts, _, _ = typed_counts(n=150, g=50, seed=19)
    data = _data(counts)
    JF.FilterGenesScanpyOrder(order=["min_cells", "max_counts"], min_cells=0.3,
                              max_counts=0.9)(data)
    idx = TF.FilterGenesScanpyOrder(order=["min_cells", "max_counts"], min_cells=0.3,
                                    max_counts=0.9)(counts)
    np.testing.assert_array_equal(counts[:, idx], np.asarray(data.data.X))
    data = _data(counts)
    JF.FilterCellsScanpyOrder(min_counts=0.05, min_genes=12, max_counts=0.95)(data)
    idx, obs = TF.FilterCellsScanpyOrder(min_counts=0.05, min_genes=12, max_counts=0.95)(counts)
    np.testing.assert_array_equal(counts[idx], np.asarray(data.data.X))
    np.testing.assert_array_equal(obs["n_counts"], data.data.obs["n_counts"].to_numpy())
    np.testing.assert_array_equal(obs["n_genes"], data.data.obs["n_genes"].to_numpy())
    with pytest.raises(KeyError):
        TF.FilterGenesScanpyOrder(order=["min_genes"])


def test_common_mod_and_cells_type_match_jax():
    from dance_tpu.data import MuData

    n1 = [f"c{i}" for i in (5, 1, 3, 9, 7)]
    n2 = [f"c{i}" for i in (3, 2, 9, 5)]
    m1 = AnnData(np.arange(5.0)[:, None], obs=pd.DataFrame(index=n1))
    m2 = AnnData(np.arange(4.0)[:, None], obs=pd.DataFrame(index=n2))
    data = Data(MuData({"a": m1, "b": m2}))
    JF.FilterCellsCommonMod("a", "b")(data)
    i1, i2 = TF.FilterCellsCommonMod()(n1, n2)
    np.testing.assert_array_equal(np.arange(5.0)[i1], np.asarray(data.data.mod["a"].X).ravel())
    np.testing.assert_array_equal(np.arange(4.0)[i2], np.asarray(data.data.mod["b"].X).ravel())
    rng = np.random.default_rng(20)
    types = rng.choice(4, 60, p=[0.5, 0.3, 0.15, 0.05])
    onehot = np.eye(4)[types]
    adata = AnnData(np.arange(60.0)[:, None], obsm={"cell_type": pd.DataFrame(
        onehot, columns=list("abcd"))})
    data = Data(adata)
    JF.FilterCellsType(cell_type_threshold=5)(data)
    keep = TF.FilterCellsType(cell_type_threshold=5)(onehot)
    np.testing.assert_array_equal(np.arange(60.0)[keep], np.asarray(data.data.X).ravel())


@pytest.mark.parametrize("method", ["enclasc", "seurat3", "scmap"])
def test_regression_filter_matches_jax_as_sets(method):
    counts, _, _ = typed_counts(n=150, g=80, seed=21)
    data = _data(counts)
    names = np.asarray(data.data.var_names)
    JF.FilterGenesRegression(method=method, num_genes=25)(data)
    idx = TF.FilterGenesRegression(method=method, num_genes=25, device=CPU)(counts)
    assert set(names[idx]) == set(np.asarray(data.data.var_names))
    with pytest.raises(ValueError, match="Unknown method"):
        TF.FilterGenesRegression(method="x")


def test_gini_markers_match_jax():
    from dance_tpu_torch.transforms import CellGiottoTopicProfile, CellTypeNums

    counts, types, _ = typed_counts(n=160, g=48, n_types=3, seed=22)
    x = np.log1p(counts)
    labels = np.array(["t0", "t1", "t2"])[types]
    prof, det, cts = CellGiottoTopicProfile()(x, labels)
    nums, _ = CellTypeNums()(labels)
    genes = [f"g{i}" for i in range(48)]
    signed = (np.array([0.0, -1.0, 2.0]), np.array([0.0, 1.0, -3.0]))
    for a, b in ((prof[:, 0], prof[:, 1]), signed):
        for i in range(len(a)):
            assert TF.gini_func([a[i], b[i]]) == JF.gini_func([a[i], b[i]])
        np.testing.assert_array_equal(TF._pair_gini(np.asarray(a, np.float64),
                                                    np.asarray(b, np.float64)),
                                      [JF.gini_func([a[i], b[i]]) for i in range(len(a))])
    assert TF.gini_func([1.0, 2.0, 5.0], [1, 2, 1]) == JF.gini_func([1.0, 2.0, 5.0], [1, 2, 1])
    adata = AnnData(x, var=pd.DataFrame(index=genes))
    adata.varm["CellGiottoTopicProfile"] = pd.DataFrame(prof, index=genes, columns=cts)
    adata.varm["CellGiottoDetectionTopicProfile"] = pd.DataFrame(det, index=genes, columns=cts)
    adata.uns["CellTypeNums"] = pd.DataFrame({"nums": nums}, index=cts)
    data = Data(adata)
    JF.FilterGenesMarkerGini(label="marker")(data)
    keep, ind, frames = TF.FilterGenesMarkerGini()(prof, det, nums=nums, genes=genes,
                                                   cell_types=cts)
    np.testing.assert_array_equal(np.asarray(genes)[keep], np.asarray(data.data.var_names))
    want = data.data.uns["FilterGenesMarkerGini"]
    got = pd.concat([pd.DataFrame({k: v for k, v in f.items() if k != "index"},
                                  index=f["index"]) for f in frames])
    for col in ("ans_score", "ans_rank", "expression", "detection", "expression_gini",
                "detection_gini", "gene_name", "cellType"):
        np.testing.assert_array_equal(got[col].to_numpy(), want[col].to_numpy(), err_msg=col)
    np.testing.assert_array_equal(got.index.to_numpy(), want.index.to_numpy())
    single = TF.get_marker_genes_giotto(prof[:, 0], prof[:, 1], det[:, 0], det[:, 1])
    jsingle = JF.get_marker_genes_giotto(prof[:, 0], prof[:, 1], det[:, 0], det[:, 1])
    np.testing.assert_array_equal(single["index"], jsingle.index.to_numpy())
    np.testing.assert_array_equal(single["ans_score"], jsingle["ans_score"].to_numpy())


def test_hvg_fronts_and_placeholders_match_jax():
    counts, _, _ = typed_counts(n=150, g=60, seed=23)
    x = np.log1p(counts)
    for jt, tt, arr in ((JF.HighlyVariableGenesRawCount(n_top_genes=20),
                         TF.HighlyVariableGenesRawCount(n_top_genes=20), counts),
                        (JF.HighlyVariableGenesLogarithmizedByTopGenes(n_top_genes=15),
                         TF.HighlyVariableGenesLogarithmizedByTopGenes(n_top_genes=15), x),
                        (JF.HighlyVariableGenesLogarithmizedByTopGenes(
                            n_top_genes=15, flavor="cell_ranger"),
                         TF.HighlyVariableGenesLogarithmizedByTopGenes(
                             n_top_genes=15, flavor="cell_ranger"), x),
                        (JF.HighlyVariableGenesLogarithmizedByMeanAndDisp(min_disp=0.2),
                         TF.HighlyVariableGenesLogarithmizedByMeanAndDisp(min_disp=0.2), x)):
        data = _data(arr)
        jt(data)
        hv = tt(arr)["highly_variable"]
        np.testing.assert_array_equal(arr[:, hv], np.asarray(data.data.X))
    data = _data(counts)
    JF.FilterGenesPlaceHolder()(data)
    n_counts, n_cells = TF.FilterGenesPlaceHolder()(counts)
    np.testing.assert_array_equal(n_counts, data.data.var["n_counts"].to_numpy())
    np.testing.assert_array_equal(n_cells, data.data.var["n_cells"].to_numpy())
    JF.FilterCellsPlaceHolder()(data)
    n_counts, n_genes = TF.FilterCellsPlaceHolder()(counts)
    np.testing.assert_array_equal(n_counts, data.data.obs["n_counts"].to_numpy())
    np.testing.assert_array_equal(n_genes, data.data.obs["n_genes"].to_numpy())
    assert TF.FilterGenesNumberPlaceHolder()(counts) is counts


@pytest.mark.parametrize("species", ["human", "mouse"])
def test_qc_filter_matches_jax(species):
    counts, _, _ = typed_counts(n=200, g=60, seed=24)
    counts[:6] *= 30
    prefix = "MT-" if species == "human" else "Mt-"
    names = [prefix + str(i) if i < 4 else f"g{i}" for i in range(60)]
    counts[6:9, :4] += 200
    data = Data(AnnData(counts.copy(), var=pd.DataFrame(index=names)))
    JF.FilterCellTransform(species=species)(data)
    keep, obs = TF.FilterCellTransform(species=species)(counts, names)
    assert (~keep).sum() > 0
    np.testing.assert_array_equal(counts[keep], np.asarray(data.data.X))
    for k, v in obs.items():
        np.testing.assert_array_equal(v[keep], data.data.obs[k].to_numpy(), err_msg=k)


def test_scrublet_transform_keeps_the_singlets():
    from dance_tpu_torch.sc import pp

    counts, _, _ = typed_counts(n=200, g=40, seed=25)
    keep = TF.ScrubletTransform(device=CPU)(counts)
    np.testing.assert_array_equal(keep, ~pp.scrublet(counts, device=CPU)[1])


# --------------------------------------------------------------------------
# MaskData, metrics, CSR helpers, STAGATE's pretrain path
# --------------------------------------------------------------------------


@pytest.mark.parametrize("rate,seed", [(0.1, 0), (0.35, 7)])
def test_mask_data_is_jax_bit_for_bit(rate, seed):
    counts, _, _ = typed_counts(n=80, g=30, seed=26)
    data = _data(counts)
    JM.MaskData(mask_rate=rate, seed=seed)(data)
    train, valid = TM.MaskData(mask_rate=rate, seed=seed)(counts)
    np.testing.assert_array_equal(train, data.data.layers["train_mask"])
    np.testing.assert_array_equal(valid, data.data.layers["valid_mask"])


def test_mape_and_device_ari_match_jax():
    rng = np.random.default_rng(27)
    true = rng.normal(size=(40, 3))
    true[0, 0] = 0.0
    pred = true + rng.normal(size=(40, 3))
    assert mape(true, pred) == jmetrics.mape(true, pred)
    assert mape(true[:, 0], pred[:, 0]) == jmetrics.mape(true[:, 0], pred[:, 0])
    from dance_tpu_torch.modules.base import resolve_score_func

    assert resolve_score_func("mape") is mape
    for k in (2, 5):
        a, b = rng.integers(0, 4, 500), rng.integers(0, k, 500)
        got = device_ari(torch.from_numpy(a), torch.from_numpy(b), 4, k)
        assert got.dtype == torch.float32 and got.dim() == 0
        want = float(jmetrics.device_ari(a, b, 4, k))
        assert float(got) == pytest.approx(want, abs=1e-6)
        assert float(got) == pytest.approx(ari(a, b), abs=1e-6)
    assert float(device_ari(np.zeros(5, int), torch.zeros(5, dtype=torch.long), 1, 1)) == 1.0


def test_csr_helpers_match_jax():
    import jax.numpy as jnp

    from dance_tpu.ops import sparse as js

    rng = np.random.default_rng(28)
    dense = (rng.random((12, 9)) < 0.3) * rng.normal(size=(12, 9))
    dense = dense.astype(np.float32)
    jm, tm = js.csr_from_dense(dense), tsparse.csr_from_dense(dense)
    assert (tsparse.csr_to_scipy(tm) != js.csr_to_scipy(jm)).nnz == 0
    np.testing.assert_array_equal(tsparse.csr_to_dense(tm).numpy(),
                                  np.asarray(js.csr_to_dense(jm)))
    v = rng.normal(size=9).astype(np.float32)
    np.testing.assert_allclose(tsparse.csr_matvec(tm, torch.from_numpy(v)).numpy(),
                               np.asarray(js.csr_matvec(jm, jnp.asarray(v))), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tsparse.csr_row_sums(tm).numpy(),
                               np.asarray(js.csr_row_sums(jm)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tsparse.csr_col_sums(tm).numpy(),
                               np.asarray(js.csr_col_sums(jm)), rtol=1e-6, atol=1e-6)
    r, c = rng.normal(size=12).astype(np.float32), rng.normal(size=9).astype(np.float32)
    np.testing.assert_array_equal(
        tsparse.csr_scale_rows(tm, torch.from_numpy(r)).data.numpy(),
        np.asarray(js.csr_scale_rows(jm, jnp.asarray(r)).data))
    np.testing.assert_array_equal(
        tsparse.csr_scale_cols(tm, torch.from_numpy(c)).data.numpy(),
        np.asarray(js.csr_scale_cols(jm, jnp.asarray(c)).data))


def test_stagate_takes_pretrain_path(tmp_path):
    path = str(tmp_path / "stagate.pt")
    model = Stagate(hidden_dims=(6, 4, 2), device=CPU, pretrain_path=path)
    assert model.pretrain_path == path and not model.is_pretrained
    model._pretrain()  # the mixin's protocol: nothing to pretrain, as in JAX
    assert model.is_pretrained


def test_scheteronet_name_helpers_match_jax(caplog):
    from types import SimpleNamespace

    import logging

    from dance_tpu.modules.single_modality.cell_type_annotation import scheteronet as jhn
    from dance_tpu_torch.modules.single_modality.cell_type_annotation import scheteronet as thn

    names = [f"g{i}" for i in range(5)]
    ids = [f"ENSG{i}" for i in range(5)]
    for var, kw in ((pd.DataFrame({"gene_id": ids, "symbol": names}, index=names),
                     dict(gene_id=ids, symbol=names)),
                    (pd.DataFrame({"symbol": names}, index=ids), dict(symbol=names)),
                    (pd.DataFrame(index=names), {})):
        want = np.asarray(jhn.get_genename(SimpleNamespace(var=var)))
        np.testing.assert_array_equal(thn.get_genename(var.index, **kw), want)
    logger = logging.getLogger("dance_tpu_torch")
    logger.propagate = True
    try:
        with caplog.at_level(logging.INFO, logger="dance_tpu_torch"):
            thn.print_statistics(7, 5, labels=[1, 0, 1, 1, 2, 0, 1], name="toy")
    finally:
        logger.propagate = False
    assert "toy: 7 cells x 5 genes" in caplog.text
    assert "{0: 2, 1: 4, 2: 1}" in caplog.text
