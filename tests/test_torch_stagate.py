"""Port parity for the STAGATE slice: neighbour graphs, scanpy-style
preprocessing, k-means, ARI, the clustering base class and STAGATE itself
(dance_tpu_torch.ops.neighbors, sc.pp, transforms.graph, ops.cluster, utils,
modules.base, modules.spatial.spatial_domain.stagate).

Inputs are made with numpy from a seed and handed to both packages; STAGATE's
flax weights are copied into the torch module (stagate_flax_to_torch). The
JAX BSR path runs its Pallas kernels in interpret mode on the CPU. Tolerances
are stated per test: graphs, permutations, HVG masks and normalised matrices
exactly; float32 forward and gradients at rtol 1e-4 (sums in another
order); five-epoch training trajectories at rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dance_tpu.data import AnnData
from dance_tpu.modules.spatial.spatial_domain.stagate import Stagate as JStagate
from dance_tpu.modules.spatial.spatial_domain.stagate import _StagateNet as JStagateNet
from dance_tpu.ops import cluster as jcluster
from dance_tpu.ops import neighbors as jnb
from dance_tpu.ops import pallas_kernels as jpk
from dance_tpu.ops.sparse import csr_from_scipy as jcsr_from_scipy
from dance_tpu.sc import pp as jpp
from dance_tpu.utils.matrix import pairwise_distance as jpairwise_distance
from dance_tpu_torch.modules.base import BaseClusteringMethod
from dance_tpu_torch.modules.spatial.spatial_domain import (Stagate, StagateNet,
                                                            stagate_preprocess)
from dance_tpu_torch.ops import bsr as tbsr
from dance_tpu_torch.ops import cluster as tcluster
from dance_tpu_torch.ops import neighbors as tnb
from dance_tpu_torch.ops.sparse import csr_from_scipy
from dance_tpu_torch.sc import pp as tpp
from dance_tpu_torch.transforms.graph import stagate_graph
from dance_tpu_torch.utils import ari
from dance_tpu_torch.utils.matrix import pairwise_distance
from dance_tpu_torch.utils.params import stagate_flax_to_torch
from torch_cases import spatial_case


def _csr_equal(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    a.sort_indices(), b.sort_indices()
    assert a.shape == b.shape and a.dtype == b.dtype
    for field in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def _counts(n=200, g=300, seed=0):
    """Raw Poisson counts with gene-specific rates, some genes all zero."""
    rng = np.random.default_rng(seed)
    rates = rng.gamma(0.5, 2.0, g) * (rng.random(g) > 0.05)
    return rng.poisson(rates[None, :] * rng.gamma(2.0, 0.5, (n, 1))).astype(np.float32)


# --------------------------------------------------------------------------
# Neighbour graphs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("include_self", [True, False])
@pytest.mark.parametrize("mode", ["connectivity", "distance", "gauss"])
def test_knn_graph_matches_jax(include_self, mode):
    xy = np.random.default_rng(1).random((300, 2)).astype(np.float32) * 100
    for symmetrize in (True, False):
        _csr_equal(tnb.knn_graph(xy, 6, mode=mode, include_self=include_self,
                                 symmetrize=symmetrize),
                   jnb.knn_graph(xy, 6, mode=mode, include_self=include_self,
                                 symmetrize=symmetrize))


def test_knn_device_branch_matches_kdtree():
    x = np.random.default_rng(2).standard_normal((700, 8)).astype(np.float32)
    for include_self in (True, False):
        d_kd, i_kd = tnb.knn(x, 5, include_self=include_self, method="kdtree")
        d_dev, i_dev = tnb.knn(x, 5, include_self=include_self, method="device",
                               block_size=256)
        np.testing.assert_array_equal(np.sort(i_dev, 1), np.sort(i_kd, 1))
        # |a|² + |b|² - 2a·b leaves ~1e-6 |x|² of float32 rounding, whose square
        # root is ~2e-3 at distance 0 (the JAX device branch does the same)
        np.testing.assert_allclose(d_dev, d_kd, rtol=1e-4, atol=5e-3)
        d_j, i_j = jnb.knn(x, 5, include_self=include_self, method="device")
        np.testing.assert_array_equal(np.sort(i_dev, 1), np.sort(i_j, 1))
    with pytest.raises(ValueError, match="needs at least"):
        tnb.knn(x[:3], 3, include_self=False)


def test_radius_graph_and_pairwise_distance_match_jax():
    xy = np.random.default_rng(3).random((250, 2)).astype(np.float32) * 20
    # squared: |a|² + |b|² - 2a·b carries ~1e-4 of float32 rounding at |x|² ~ 800,
    # which the square root blows up near distance 0
    np.testing.assert_allclose(pairwise_distance(xy) ** 2, jpairwise_distance(xy) ** 2,
                               rtol=1e-5, atol=1e-3)
    _csr_equal(tnb.radius_graph(xy, 1.5), jnb.radius_graph(xy, 1.5))
    with pytest.raises(NotImplementedError, match="euclidean"):
        pairwise_distance(xy, dist_func="pearson")


@pytest.mark.parametrize("model", ["radius", "knn"])
def test_stagate_graph_matches_jax(model):
    from dance_tpu.data import Data
    from dance_tpu.transforms.graph import StagateGraph

    xy = np.random.default_rng(4).random((200, 2)).astype(np.float32) * 10
    data = Data(AnnData(np.zeros((200, 3), np.float32), obsm={"spatial_pixel": xy}))
    StagateGraph(model, radius=1.2, n_neighbors=6)(data)
    _csr_equal(stagate_graph(xy, model, radius=1.2, n_neighbors=6),
               data.data.obsp["StagateGraph"])
    with pytest.raises(ValueError, match="Unknown model"):
        stagate_graph(xy, "delaunay")


# --------------------------------------------------------------------------
# Preprocessing
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sparse", [False, True])
def test_normalize_total_and_log1p_match_jax(sparse):
    counts = _counts(seed=5)
    x = sp.csr_matrix(counts) if sparse else counts
    for kw in ({"target_sum": 1e4}, {}, {"exclude_highly_expressed": True}):
        ad = AnnData(x)
        jpp.normalize_total(ad, **kw)
        got = tpp.normalize_total(x, **kw)
        assert sp.issparse(got) == sparse
        np.testing.assert_array_equal(tpp._dense(got), jpp._dense(ad.X))
        jpp.log1p(ad, base=2 if kw else None)
        np.testing.assert_array_equal(tpp._dense(tpp.log1p(got, base=2 if kw else None)),
                                      jpp._dense(ad.X))


@pytest.mark.parametrize("sparse", [False, True])
def test_seurat_v3_hvg_matches_jax(sparse):
    counts = _counts(n=300, g=500, seed=6)
    x = sp.csr_matrix(counts) if sparse else counts
    ad = AnnData(x)
    jpp.highly_variable_genes(ad, flavor="seurat_v3", n_top_genes=120)
    got = tpp.highly_variable_genes(x, flavor="seurat_v3", n_top_genes=120)
    for key in ("highly_variable", "means", "variances", "variances_norm"):
        np.testing.assert_array_equal(got[key], ad.var[key].to_numpy())
    assert got["highly_variable"].sum() == 120
    with pytest.raises(NotImplementedError, match="seurat_v3"):
        tpp.highly_variable_genes(x, flavor="seurat")


def test_stagate_preprocess_matches_jax_steps():
    counts = _counts(n=250, g=400, seed=7)
    xy = np.random.default_rng(7).random((250, 2)).astype(np.float32) * 10
    x, adj = stagate_preprocess(counts, xy, n_top_genes=100, model_name="knn", n_neighbors=6)
    ad = AnnData(counts)
    jpp.highly_variable_genes(ad, flavor="seurat_v3", n_top_genes=100, subset=True)
    jpp.normalize_total(ad, target_sum=1e4)
    jpp.log1p(ad)
    assert x.dtype == np.float32 and x.shape == (250, 100)
    np.testing.assert_array_equal(x, jpp._dense(ad.X))
    _csr_equal(adj, jnb.knn_graph(xy, 6, mode="connectivity", include_self=True,
                                  symmetrize=False))


# --------------------------------------------------------------------------
# k-means, ARI, the clustering base
# --------------------------------------------------------------------------


def _blobs(n=300, k=3, d=5, seed=8):
    rng = np.random.default_rng(seed)
    truth = rng.integers(0, k, n)
    return (rng.standard_normal((k, d)) * 6)[truth] + rng.standard_normal((n, d)), truth


@pytest.mark.parametrize("tol", [0.0, 1e-4])
def test_lloyd_matches_jax(tol):
    x, _ = _blobs()
    x = x.astype(np.float32)
    centers = x[[0, 1, 2, 3]]  # four centers from the same points on both sides
    jl, jc, ji = jcluster._lloyd(jnp.asarray(x), jnp.asarray(centers), 4, 20, tol)
    tl, tc, ti = tcluster._lloyd(torch.from_numpy(x), torch.from_numpy(centers), 20, tol)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)


def test_kmeans_finds_blobs_and_keeps_best_restart():
    x, truth = _blobs(seed=9)
    res = tcluster.kmeans(x, 3, n_init=4, seed=1)
    assert res.labels.shape == (300,) and res.centers.shape == (3, 5)
    assert ari(truth, res.labels.numpy()) == 1.0
    singles = [float(tcluster.kmeans(x, 3, n_init=1, seed=1 + i).inertia) for i in range(4)]
    assert float(res.inertia) == min(singles)
    again = tcluster.kmeans(x, 3, n_init=4, seed=1)
    assert torch.equal(again.labels, res.labels)
    # duplicate points leave no mass for later picks; the draw still lands
    assert tcluster.kmeans(np.ones((20, 2)), 3, n_init=1).labels.shape == (20,)


@pytest.mark.parametrize("case", ["random", "same", "split", "single", "renamed"])
def test_ari_matches_sklearn(case):
    from sklearn.metrics import adjusted_rand_score

    rng = np.random.default_rng(10)
    true = rng.integers(0, 4, 200)
    pred = {"random": rng.integers(0, 5, 200), "same": true,
            "split": np.where(rng.random(200) < 0.3, true + 4, true),
            "single": np.zeros(200, int), "renamed": (true * 7 + 3) % 11}[case]
    assert ari(true, pred) == pytest.approx(adjusted_rand_score(true, pred), abs=1e-12)
    assert ari([], []) == adjusted_rand_score([], [])


def test_clustering_base_scores_valid_and_test_idx():
    class Fixed(BaseClusteringMethod):
        def fit(self, x, y=None):
            return self

        def predict(self, x):
            return np.array([0, 0, 1, 1, 2, 2])

    y = np.array([5, 5, 7, 7, 9, 8])
    m = Fixed()
    assert m.score(None, y) == pytest.approx(ari(y, m.predict(None)))
    scores, pred = m.fit_score(None, y, valid_idx=[0, 1, 2, 3], test_idx=[4, 5],
                               return_pred=True)
    assert scores == {"valid_score": 1.0, "test_score": ari([9, 8], [2, 2])}
    assert pred.shape == (6,)


# --------------------------------------------------------------------------
# STAGATE
# --------------------------------------------------------------------------


def _jax_init(dims, x, adj):
    return JStagateNet(hidden_dims=dims).init(
        jax.random.key(0), jcsr_from_scipy(adj), jnp.asarray(x))["params"]


@pytest.mark.parametrize("branch", ["csr", "bsr"])
def test_stagate_net_forward_and_grads_match_jax(branch):
    x, adj, _ = spatial_case(n=180, d=20, seed=11)
    adj = sp.csr_matrix(adj) + sp.eye(180, format="csr", dtype=np.float32)
    dims = (20, 16, 4)
    params = _jax_init(dims, x, adj)
    jadj = jcsr_from_scipy(adj) if branch == "csr" else jpk.bsr_from_scipy(adj)
    net = JStagateNet(hidden_dims=dims)

    def jloss(p):
        _, x_hat = net.apply({"params": p}, jadj, jnp.asarray(x))
        return jnp.mean((jnp.asarray(x) - x_hat) ** 2)

    jz, jx_hat = net.apply({"params": params}, jadj, jnp.asarray(x))
    jgrads = jax.grad(jloss)(params)

    tnet = StagateNet(dims)
    tnet.load_state_dict(stagate_flax_to_torch(params))
    tadj = csr_from_scipy(adj) if branch == "csr" else tbsr.bsr_from_scipy(adj)
    xt = torch.from_numpy(x)
    z, x_hat = tnet(tadj, xt)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(x_hat.detach().numpy(), np.asarray(jx_hat), rtol=1e-4,
                               atol=1e-5)
    torch.mean((xt - x_hat) ** 2).backward()
    want = stagate_flax_to_torch(jgrads)
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("use_bsr", [False, True])
def test_stagate_fit_matches_jax(use_bsr):
    x, adj, _ = spatial_case(n=160, d=20, seed=12)
    dims = (20, 16, 4)
    params = _jax_init(dims, x, sp.csr_matrix(adj) + sp.eye(160, format="csr"))
    jm = JStagate(hidden_dims=dims, seed=0)
    jm.params = params
    jlosses, step = [], jm._step

    def recording_step(*args):
        out = step(*args)
        jlosses.append(float(out[2]))
        return out

    jm._step = recording_step
    jm.fit((x, adj), epochs=5, n_clusters=3, use_bsr=use_bsr)

    m = Stagate(hidden_dims=dims, device="cpu", seed=0)
    m.net.load_state_dict(stagate_flax_to_torch(params))
    m.fit((x, adj), epochs=5, n_clusters=3, use_bsr=use_bsr)
    np.testing.assert_allclose([h["loss"] for h in m.history], jlosses, rtol=1e-4)
    np.testing.assert_allclose(m.get_latent(), jm.get_latent(), rtol=1e-3, atol=1e-4)
    for name, p in m.net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jm.params[name]),
                                   rtol=1e-3, atol=1e-5)
    if use_bsr:
        np.testing.assert_array_equal(m._perm, jm._perm)


def test_clip_by_global_norm_matches_optax():
    import optax

    from dance_tpu_torch.modules.spatial.spatial_domain.stagate import _clip_by_global_norm_

    rng = np.random.default_rng(13)
    for scale in (0.1, 10.0):
        grads = [rng.standard_normal(s).astype(np.float32) * scale for s in ((4, 3), (5,))]
        want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
        params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        _clip_by_global_norm_(params, 1.0)
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("use_bsr", [True, False])
def test_stagate_fit_predict_finds_domains(use_bsr):
    """As tests/modules/test_spatial.py:184 holds the JAX model: ARI > 0.6."""
    x, adj, dom = spatial_case(n=150, d=24, seed=0)
    m = Stagate(hidden_dims=(24, 16, 4), device="cpu", seed=0)
    m.fit((x, adj), epochs=150, n_clusters=3, use_bsr=use_bsr)
    z = m.get_latent()
    assert z.shape == (150, 4) and np.isfinite(z).all()
    assert len(m.history) == 150 and m.history[-1]["loss"] < m.history[0]["loss"]
    assert m.score(None, dom) > 0.6
    with pytest.raises(NotImplementedError, match="auto"):
        m.fit((x, adj), epochs=1, use_bsr="auto")
