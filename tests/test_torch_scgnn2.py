"""Port parity for scGNN2 (dance_tpu_torch.modules.single_modality.
imputation.scgnn2): the feature and graph stages (the VGAE's std =
exp(logvar)), the cluster-AE stage batched over the clusters (the per-cluster
``sqrt(max(·, 1e-12))`` and the unscaled L1), the clustering with its
trimming, the EM fit under both protocols, the front and the
reference-named helpers.

Inputs are made with numpy from a seed (``torch_cases.typed_counts``: 160
cells x 48 genes in 3 types); random flax weights from ``random_flax_params``
are copied in (``scgnn2_feature_ae_flax_to_torch``,
``scgnn2_graph_ae_flax_to_torch``), the VGAE's normals are JAX's (from its
keys, scgnn2.py:117-145) and the k-means fallback gets JAX's starts. The
stage test runs the EM fit's first stages on its inputs and weights, so
that JAX compiles them once.
Tolerances: forwards at rtol 1e-5; a stage's last loss at rtol 1e-5 and its
outputs at 1e-4 of the largest value (a few Adam steps); the EM fits'
imputations at 1e-4 of the largest value; labels, graphs and the helpers
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dance_tpu.data import AnnData, Data
from dance_tpu.modules.single_modality.imputation import scgnn2 as J
from dance_tpu.ops.sparse import csr_from_scipy as jcsr
from dance_tpu_torch.modules.single_modality.imputation import scgnn2 as T
from dance_tpu_torch.ops.neighbors import knn_graph
from dance_tpu_torch.ops.sparse import csr_from_scipy
from dance_tpu_torch.utils.params import (scgnn2_feature_ae_flax_to_torch,
                                          scgnn2_graph_ae_flax_to_torch)
from test_torch_dcca import random_flax_params
from test_torch_stlearn import _jax_starts
from test_torch_vae_babel import _np
from torch_cases import typed_counts

CPU = torch.device("cpu")
HIDDEN = (24, 8)


def _inputs(seed=0):
    counts, types = typed_counts(seed=seed)[:2]
    return np.log1p(np.asarray(counts, np.float32)), types


def _feature(ref, x, seed=1):
    ae = J._FeatureAE(hidden=HIDDEN, reference_protocol=ref)
    params = random_flax_params(ae, jnp.asarray(x[:1]), seed=seed)
    tae = T._FeatureAE(x.shape[1], HIDDEN, ref)
    tae.load_state_dict(scgnn2_feature_ae_flax_to_torch(_np(params)))
    return ae, params, tae


def _model(ref, **kw):
    return T.ScGNN2(hidden=HIDDEN, reference_protocol=ref, device=CPU, seed=0, **kw)


def _rel(got, want, rel=1e-4):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("ref", [False, True])
def test_feature_and_graph_stages_match_jax(ref):
    x, _ = _inputs(seed=5)  # the EM fit's inputs and weights: JAX's compiled stages are shared
    mask = (np.random.default_rng(6).random(x.shape) > 0.1).astype(np.float32)
    ae, params, tae = _feature(ref, x, seed=7)
    z, x_hat = tae(torch.from_numpy(x))
    jz, jx = ae.apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(x_hat.detach().numpy(), np.asarray(jx), rtol=1e-5, atol=1e-6)
    jp, jz, jx, jl = J._feature_stage_scan(ae, 1e-3, params, jnp.asarray(x), jnp.asarray(mask),
                                           n_epochs=3)
    m = _model(ref, feature_epoch=3, graph_epoch=3, k=5)
    m.feature_ae = tae
    z, x_hat, loss = m._feature_stage(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _rel(z.numpy(), np.asarray(jz))
    _rel(x_hat.numpy(), np.asarray(jx))
    # the graph stage on the feature AE's embedding, JAX's normals handed in
    zt = np.asarray(jz)
    adj = knn_graph(zt, 5, mode="connectivity", include_self=False)
    gae = J._GraphAE(z_dim=HIDDEN[-1], variational=ref)
    adj_n = T._norm_adjacency(adj)
    gp = random_flax_params(gae, jcsr(adj_n), jnp.asarray(zt), seed=8)
    gkey = jax.random.key(5)
    jgp, jzg, jgl = J._graph_stage_scan(gae, 1e-3, gp, jcsr(adj_n), jnp.asarray(zt), gkey,
                                        n_epochs=3, sample=ref)
    tg = T._GraphAE(HIDDEN[-1], HIDDEN[-1], ref)
    tg.load_state_dict(scgnn2_graph_ae_flax_to_torch(_np(gp)))
    if ref:  # std = exp(logvar), without the half
        noise = torch.randn(zt.shape[0], HIDDEN[-1])
        adj_t, zt_t = csr_from_scipy(adj_n), torch.from_numpy(zt)
        h = torch.relu(T.spmm(adj_t, tg.denses[0](zt_t)))
        lv = T.spmm(adj_t, tg.denses[2](h))
        np.testing.assert_allclose(tg(adj_t, zt_t, noise).detach().numpy(),
                                   (tg(adj_t, zt_t) + noise * torch.exp(lv)).detach().numpy(),
                                   rtol=1e-6)
    m.graph_ae = tg
    keys = list(jax.random.split(gkey, 3)) + [jax.random.fold_in(gkey, 4)]
    m._noise = lambda em, n, shape: [torch.from_numpy(np.asarray(jax.random.normal(k, shape)))
                                     for k in keys]
    zg, adj_t, gl = m._graph_stage(torch.from_numpy(zt), 0)
    assert (adj_t != adj).nnz == 0
    np.testing.assert_allclose(float(gl), float(jgl), rtol=1e-5)
    _rel(zg.numpy(), np.asarray(jzg))


@pytest.mark.parametrize("ref", [False, True])
def test_cluster_stage_and_labels_match_jax(ref, monkeypatch):
    x, types = _inputs(seed=2)
    xd = x * (np.random.default_rng(3).random(x.shape) > 0.2)
    ae, params, tae = _feature(ref, x, seed=4)
    x_recon = np.asarray(ae.apply({"params": params}, jnp.asarray(x))[1])
    adj = knn_graph(x, 10, mode="connectivity", include_self=False)
    labels = np.array(types)
    labels[:3] = 3  # a small cluster pads the others' batch
    jm = J.ScGNN2(hidden=HIDDEN, reference_protocol=ref, cluster_epoch=3)
    jm.feature_ae = ae
    want = np.asarray(jm._cluster_ae_stage(params, x_recon, jnp.asarray(xd), labels, adj))
    m = _model(ref, cluster_epoch=3)
    m.feature_ae = tae
    got = m._cluster_ae_stage(torch.from_numpy(x_recon), torch.from_numpy(xd), labels, adj)
    _rel(got.numpy(), want)
    # the per-cluster objective at a zero residual keeps its sqrt(max(., 1e-12)) floor
    zero = T.cluster_loss(torch.ones(2, 3, 4), torch.ones(2, 3, 4), torch.ones(2, 3, 4),
                          torch.ones(2, 3), torch.ones(2, 3))
    assert float(zero) == pytest.approx(2e-6)
    # Louvain labels with the trimming, and the k-means fallback from JAX's starts
    z = np.asarray(ae.apply({"params": params}, jnp.asarray(x))[0])
    zadj = knn_graph(z, 3, mode="connectivity", include_self=False)
    for max_clusters in (30, 1):
        jm.max_clusters = m.max_clusters = max_clusters
        _jax_starts(monkeypatch, 0)
        want = jm._cluster_labels(jnp.asarray(z), zadj, len(z))
        np.testing.assert_array_equal(m._cluster_labels(torch.from_numpy(z), zadj, len(z)), want)
    sizes = np.bincount(want)
    assert sizes.min() >= 5


@pytest.mark.parametrize("ref", [False, True])
def test_em_fit_matches_jax(ref, monkeypatch):
    """One EM round of 3-epoch stages from the same initial weights and JAX's
    normals: the imputation (observed entries kept), the labels, the stages
    in order and the score."""
    x, _ = _inputs(seed=5)
    mask = (np.random.default_rng(6).random(x.shape) > 0.1).astype(np.float32)
    kw = dict(total_epoch=1, feature_epoch=3, graph_epoch=3, cluster_epoch=3, k=5,
              hidden=HIDDEN, reference_protocol=ref, seed=0)
    # random weights of the shapes flax's inits give (a flax init runs op by op here)
    fp = random_flax_params(J._FeatureAE(hidden=HIDDEN, reference_protocol=ref),
                            jnp.asarray(x[:1]), seed=7)
    adj = jcsr(sp.eye(len(x), format="csr", dtype=np.float32))
    gp = random_flax_params(J._GraphAE(z_dim=HIDDEN[-1], variational=ref), adj,
                            jnp.zeros((len(x), HIDDEN[-1])), seed=8)
    monkeypatch.setattr(J._FeatureAE, "init", lambda self, *a, **k: {"params": fp})
    monkeypatch.setattr(J._GraphAE, "init", lambda self, *a, **k: {"params": gp})
    jm = J.ScGNN2(**kw).fit(x, mask=mask)
    tm = T.ScGNN2(device=CPU, **kw)

    def make(in_dim):
        f = T._FeatureAE(in_dim, HIDDEN, ref)
        f.load_state_dict(scgnn2_feature_ae_flax_to_torch(_np(fp)))
        g = T._GraphAE(HIDDEN[-1], HIDDEN[-1], ref)
        g.load_state_dict(scgnn2_graph_ae_flax_to_torch(_np(gp)))
        return f, g

    def noise(em, n, shape):
        gkey = jax.random.fold_in(jax.random.key(0), 1000 + em)
        keys = list(jax.random.split(gkey, n)) + [jax.random.fold_in(gkey, n + 1)]
        return [torch.from_numpy(np.asarray(jax.random.normal(k, shape))) for k in keys]

    monkeypatch.setattr(tm, "_make_nets", make)
    monkeypatch.setattr(tm, "_noise", noise)
    tm.fit(x, mask=mask)
    np.testing.assert_array_equal(tm.labels, jm.labels)
    _rel(tm.predict(), jm.predict())
    np.testing.assert_array_equal(tm.predict()[mask > 0], x[mask > 0])
    assert [h["stage"] for h in tm.history] == ["feature", "graph", "cluster", "feature",
                                                "graph"]
    assert tm.score(x, tm.predict(), mask=mask == 0) == pytest.approx(
        jm.score(x, jm.predict(), mask=mask == 0), rel=1e-4)


def test_front_and_helpers_match_jax():
    counts, _ = typed_counts(seed=7)[:2]
    counts = np.asarray(counts, np.float32)
    counts[:, 2] = 0
    counts[5] = 0
    data = Data(AnnData(counts.copy(), obs={"idx": np.arange(len(counts))},
                        var={"gidx": np.arange(counts.shape[1])}))
    J.ScGNN2.preprocessing_pipeline(seed=3, log_level="WARNING")(data)
    inp = T.scgnn2_preprocess(counts, seed=3)
    ad = data.data
    np.testing.assert_array_equal(inp.cells, ad.obs["idx"].to_numpy())
    np.testing.assert_array_equal(inp.genes, ad.var["gidx"].to_numpy())
    np.testing.assert_array_equal(inp.x, ad.X)
    np.testing.assert_array_equal(inp.x_raw, ad.raw.X)
    for name in ("train_mask", "valid_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(inp, name), ad.layers[name], err_msg=name)
    emb = np.random.default_rng(8).standard_normal((30, 4))
    edges = T.calculateKNNgraphDistanceMatrixStatsSingleThread(emb, k=4)
    assert edges == J.calculateKNNgraphDistanceMatrixStatsSingleThread(emb, k=4)
    assert T.edgeList2edgeDict(edges, 30) == J.edgeList2edgeDict(edges, 30)
    assert T.edgeList2edgeIndex(edges) == J.edgeList2edgeIndex(edges)
    assert T.generateLouvainCluster(edges) == J.generateLouvainCluster(edges)
    labels = [0] * 8 + [1] * 3 + [2] * 12 + [31] * 7
    assert T.trimClustering(labels) == J.trimClustering(labels)
    for factor, keep in ((4, True), (0.2, False)):
        for a, b in zip(T.feature2adj(emb, factor, keep)[:2], J.feature2adj(emb, factor, keep)[:2]):
            assert abs(a - b).max() == 0
    dense = np.abs(emb[:, :3])
    dense[2] = 0
    np.testing.assert_array_equal(T.normalize_features_dense(dense),
                                  J.normalize_features_dense(dense))
    np.testing.assert_array_equal(T.normalize_cell_cell_matrix(dense @ dense.T),
                                  J.normalize_cell_cell_matrix(dense @ dense.T))
    sq = (dense @ dense.T > 1).astype(float)
    np.testing.assert_array_equal(T.convert_adj_to_edge_index(sq),
                                  J.convert_adj_to_edge_index(sq))
    np.testing.assert_array_equal(T.generateCelltypeRegu(labels), J.generateCelltypeRegu(labels))
    got, want = T.preprocess_graph(sq, device=CPU), J.preprocess_graph(sq)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=1e-6)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))


def test_device_defaults(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.ScGNN2()
    assert isinstance(T.ScGNN2(device="cpu").device, torch.device)
    assert sp.issparse(T.feature2adj(np.eye(4), 2, False)[0])
    # the container pipeline builds on the CPU: no step of it takes a device
    assert T.ScGNN2.preprocessing_pipeline(seed=3).hexdigest() == \
        J.ScGNN2.preprocessing_pipeline(seed=3).hexdigest()
