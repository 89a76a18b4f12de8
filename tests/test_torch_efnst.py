"""Port parity for EfNST (dance_tpu_torch.modules.spatial.spatial_domain.
EfNST): the graph autoencoder's losses, gradients and Adam step, the DEC
step's target from the pre-step weights, a short fit, ``Refiner``, the
augmentation chain and the pipeline fronts.

Inputs are made with numpy from a seed (``torch_cases.spatial_slide``: 120
spots on a 12 x 10 grid, 40 genes); random flax weights from
``random_flax_params`` are copied in (``efnst_flax_to_torch``), and the
fit starts both sides from the same weights and centres. Tolerances: losses
at rtol 1e-5, gradients within 1e-4 of each tensor's largest value, one Adam
step at rtol 1e-5; the fit's losses at rtol 1e-4 and q at 1e-4 of the
largest value; the chain's weights at 1e-5 absolute (float64 distances of
a float32 PCA) and its profiles at rtol 1e-5; labels, neighbour picks and
graphs exactly.
"""

import importlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from dance_tpu.data import AnnData, Data
from dance_tpu.ops import cluster as jcluster
from dance_tpu.ops.sparse import csr_from_scipy as jcsr
from dance_tpu.transforms import spatial_feature as jsf
from dance_tpu.utils.loss import soft_assign as jsoft, target_distribution as jtarget
from dance_tpu_torch.ops.cluster import KMeansResult
from dance_tpu_torch.ops.neighbors import knn_graph
from dance_tpu_torch.ops.sparse import csr_from_scipy
from dance_tpu_torch.transforms import spatial_feature as S
from dance_tpu_torch.utils.params import efnst_flax_to_torch
from test_torch_dcca import random_flax_params
from test_torch_vae_babel import _grads_close, _np
from torch_cases import spatial_slide

CPU = torch.device("cpu")
# the JAX package exports the class ``EfNST`` under the module's name
J = importlib.import_module("dance_tpu.modules.spatial.spatial_domain.EfNST")
T = importlib.import_module("dance_tpu_torch.modules.spatial.spatial_domain.EfNST")


def _inputs(seed=0):
    counts, xy, xy_pixel, image, dom = spatial_slide(seed=seed)
    x = np.concatenate([np.log1p(counts),
                        np.random.default_rng(seed).random((120, 8), dtype=np.float32)], 1)
    return x.astype(np.float32), knn_graph(xy, 6, symmetrize=False), xy, xy_pixel, counts, dom


def _step_case(dec):
    x, graph, *_ = _inputs()
    adj_sp, target = T.efnst_adjacency(graph)
    jadj, tadj = jcsr(adj_sp), csr_from_scipy(adj_sp)
    net = J._EfNSTNet(z_dim=6)
    params = random_flax_params(net, jadj, jnp.asarray(x), seed=1)
    mu = np.random.default_rng(2).standard_normal((3, 6)).astype(np.float32)
    jm = J.EfNsSTRunner(n_clusters=3, z_dim=6)
    import optax
    jm._tx = optax.adam(1e-3)
    theta = (params, jnp.asarray(mu))
    state = jm._tx.init(theta)
    t = jnp.asarray(target.toarray())
    if dec:
        jtheta, _, jl = jm._dec_step(theta, state, jadj, jnp.asarray(x), t)
    else:
        jtheta, _, jl = jm._step(theta, state, jadj, jnp.asarray(x), t,
                                 jnp.zeros((120, 3)), False)
    return x, tadj, target, params, mu, jm, theta, t, jadj, jtheta, jl


@pytest.mark.parametrize("dec", [False, True])
def test_step_matches_jax(dec):
    """Forward, loss, gradients and one Adam step; the DEC step takes its
    target from the weights before the step (EfNST.py:123-130)."""
    x, tadj, target, params, mu, jm, theta, t, jadj, jtheta, jl = _step_case(dec)
    tn = T._EfNSTNet(x.shape[1], 6)
    tn.load_state_dict(efnst_flax_to_torch(_np(params)))
    z, x_hat = tn(tadj, torch.from_numpy(x))
    jz, jlogits, jx_hat = jax.jit(jm.net.apply)({"params": params}, jadj, jnp.asarray(x))
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tn.adj_probs(z).detach().numpy(), np.asarray(jlogits), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(x_hat.detach().numpy(), np.asarray(jx_hat), rtol=1e-5, atol=1e-6)
    tmu = torch.tensor(mu, requires_grad=True)
    xt, tt = torch.from_numpy(x), torch.from_numpy(target.toarray())
    p = None
    if dec:
        with torch.no_grad():
            p = T.target_distribution(T.soft_assign(tn(tadj, xt)[0], tmu, 1.0))
    loss, _ = T.efnst_loss(tn, tadj, xt, tt, tmu, p)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    jg = jax.jit(jax.grad(lambda th: _jax_loss(jm, th, jadj, x, t, dec, theta)))(theta)
    _grads_close(tn, jg[0], lambda g: efnst_flax_to_torch(g))
    if dec:
        np.testing.assert_allclose(tmu.grad.numpy(), np.asarray(jg[1]), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(jg[1]).max()))
    opt = torch.optim.Adam([*tn.parameters(), tmu], lr=1e-3)
    opt.step()
    want = efnst_flax_to_torch(_np(jtheta[0]))
    for name, prm in tn.named_parameters():
        np.testing.assert_allclose(prm.detach().numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def _jax_loss(jm, th, jadj, x, t, dec, theta0):
    from dance_tpu.utils.loss import binary_ce_logits, cluster_kl_loss
    params, mu = th
    z, _, x_hat = jm.net.apply({"params": params}, jadj, jnp.asarray(x))
    loss = binary_ce_logits(z @ z.T, t) + jnp.mean((x - x_hat) ** 2)
    if dec:
        z0 = jm.net.apply({"params": theta0[0]}, jadj, jnp.asarray(x))[0]
        p = jtarget(jsoft(z0, theta0[1], 1.0))
        loss = loss + cluster_kl_loss(p, jsoft(z, mu, 1.0))
    return loss


def test_fit_matches_jax(monkeypatch):
    """3 + 3 epochs from the same initial weights and k-means centres: the
    losses of both phases, q, z and the labels."""
    x, graph, *_, dom = _inputs(seed=3)
    jm = J.EfNsSTRunner(n_clusters=3, z_dim=6, seed=0)
    adj_sp, _ = T.efnst_adjacency(graph)
    params = random_flax_params(jm.net, jcsr(adj_sp), jnp.asarray(x), seed=4)
    # both sides start from these weights and from k-means centres of JAX's z (its
    # first rows: a compiled 10-restart k-means costs seconds here)
    monkeypatch.setattr(J._EfNSTNet, "init", lambda self, *a, **k: {"params": params})
    centres = {}

    def jax_kmeans(z, k, **kw):
        centres["c"] = np.asarray(z[:k])
        return jcluster.KMeansResult(None, z[:k], None)
    monkeypatch.setattr(jcluster, "kmeans", jax_kmeans)
    losses = []
    for name in ("_step", "_dec_step"):  # _dec_step traces _step: its losses are tracers
        fn = getattr(jm, name)
        monkeypatch.setattr(jm, name, lambda *a, fn=fn: (lambda out: losses.append(out[2])
                                                         or out)(fn(*a)), raising=False)
    jm.fit(concat_X=x, graph_dict=graph, epochs=3, dec_epochs=3)
    losses = [float(v) for v in losses if not isinstance(v, jax.core.Tracer)]
    tm = T.EfNsSTRunner(n_clusters=3, z_dim=6, seed=0, device=CPU)

    def make(in_dim):
        net = T._EfNSTNet(in_dim, 6)
        net.load_state_dict(efnst_flax_to_torch(_np(params)))
        return net
    monkeypatch.setattr(tm, "_make_net", make)
    monkeypatch.setattr(tm, "_kmeans", lambda z: torch.from_numpy(centres["c"]))
    tm.fit(concat_X=x, graph_dict=graph, epochs=3, dec_epochs=3)
    assert [h["phase"] for h in tm.history] == ["pretrain"] * 3 + ["dec"] * 3
    np.testing.assert_allclose([h["loss"] for h in tm.history], losses, rtol=1e-4)
    np.testing.assert_allclose(tm.q, jm.q, rtol=0, atol=1e-4 * np.abs(jm.q).max())
    np.testing.assert_allclose(tm.get_latent(), jm.get_latent(), rtol=0,
                               atol=1e-4 * np.abs(jm.z).max())
    np.testing.assert_array_equal(tm.predict(), jm.predict())
    # the port's own k-means (torch's draws) on the embedding
    assert isinstance(T.kmeans(torch.from_numpy(tm.z), 3, n_init=10), KMeansResult)


def _jax_adata(x, xy, xy_pixel, feat=None):
    obsm = {"spatial": pd.DataFrame({"x": xy[:, 0], "y": xy[:, 1]}),
            "spatial_pixel": pd.DataFrame({"x_pixel": xy_pixel[:, 0],
                                           "y_pixel": xy_pixel[:, 1]})}
    if feat is not None:
        obsm["image_feat_pca"] = feat
    return SimpleNamespace(X=x, obsm=obsm, shape=x.shape)


def test_refiner_and_augmentation_chain_match_jax():
    _, _, xy, xy_pixel, counts, dom = _inputs(seed=5)
    x = np.log1p(counts)
    dis = np.sqrt(((xy[:, None] - xy[None]) ** 2).sum(-1))
    noisy = np.where(np.random.default_rng(0).random(120) < 0.25, (dom + 1) % 3, dom)
    for shape in ("hexagon", "square"):
        np.testing.assert_array_equal(T.Refiner(shape).fit(None, noisy, dis),
                                      J.Refiner(shape).fit(None, noisy, dis))
    np.testing.assert_array_equal(T.cal_spatial_weight(xy, 8), J.cal_spatial_weight(xy, 8))
    for metric in ("cosine", "correlation"):
        np.testing.assert_allclose(T.cal_gene_weight(x, 10, metric, device=CPU),
                                   J.cal_gene_weight(x, 10, metric), rtol=0, atol=1e-5)
    feat = np.random.default_rng(6).standard_normal((120, 10))
    for kw in ({}, {"no_morphological": False}, {"platform": "ST"}):
        got = T.cal_weight_matrix(x, xy, xy_pixel, feat, verbose=True, n_components=10,
                                  device=CPU, **kw)
        ad = J.cal_weight_matrix(_jax_adata(x, xy, xy_pixel, feat), verbose=True,
                                 n_components=10, **kw)
        assert set(got) == set(ad.obsm) - {"spatial", "spatial_pixel", "image_feat_pca"}
        for key, val in got.items():
            want = ad.obsm[key]
            want = want.toarray() if sp.issparse(want) else want
            np.testing.assert_allclose(val, want, rtol=0, atol=1e-5, err_msg=key)
    # the neighbour picks, with JAX's slice: the largest weight (the spot itself) left out
    # (JAX keeps Visium's physical_distance sparse, which its find_adjacent_spot
    # cannot index: that pick is held on the dense kNN weights of another platform)
    for weights, platform in (("weights_matrix_all", "Visium"), ("physical_distance", "ST")):
        ad = J.cal_weight_matrix(_jax_adata(x, xy, xy_pixel, feat), verbose=True,
                                 n_components=10, platform=platform)
        w = ad.obsm[weights]
        w = w.toarray() if sp.issparse(w) else w
        J.find_adjacent_spot(ad, weights=weights, verbose=True)
        got, gw = T.find_adjacent_spot(x, w, weights=weights, verbose=True, device=CPU)
        np.testing.assert_allclose(got, ad.obsm["adjacent_data"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gw, ad.obsm["adjacent_weight"], rtol=1e-12)
    wm = J.cal_weight_matrix(_jax_adata(x, xy, xy_pixel, feat),
                             n_components=10).obsm["weights_matrix_all"]
    top = np.argsort(wm[0])[-4:]
    assert top[-1] == 0 and 0 not in top[:3]  # the slice drops the spot itself
    ad = J.augment_adata(_jax_adata(x, xy, xy_pixel, feat), n_components=10)
    out = T.augment_adata(x, xy, xy_pixel, feat, n_components=10, device=CPU)
    np.testing.assert_allclose(out["weights_matrix_all"], ad.obsm["weights_matrix_all"],
                               rtol=0, atol=1e-5)
    for key in ("adjacent_data", "augment_gene_data"):
        np.testing.assert_allclose(out[key], ad.obsm[key], rtol=1e-5, atol=1e-6, err_msg=key)


def test_fronts_match_jax(monkeypatch):
    _, _, xy, xy_pixel, counts, _ = _inputs(seed=7)
    feat = np.random.default_rng(8).standard_normal((120, 10))
    adata = AnnData(counts.copy(), var={"gid": np.arange(counts.shape[1])})
    for key, val in _jax_adata(counts, xy, xy_pixel, feat).obsm.items():
        adata.obsm[key] = val
    data = Data(adata, train_size="all")
    J.EfNSTAugmentTransform()(data)
    aug = T.efnst_augment(counts, xy, xy_pixel, feat, device=CPU)
    np.testing.assert_allclose(aug, data.data.obsm["augment_gene_data"], rtol=1e-5, atol=1e-5)
    J.EfNSTConcatgTransform(pca_n_comps=10)(data)
    np.testing.assert_allclose(T.efnst_concat(aug, pca_n_comps=10, device=CPU),
                               data.data.obsm["feature.cell"], rtol=0,
                               atol=1e-4 * np.abs(data.data.obsm["feature.cell"]).max())
    for dist, kw in (("Radius", {"rad_cutoff": 1.5}), ("KNN", {"k": 5})):
        d = Data(AnnData(counts.copy()))
        d.data.obsm["spatial"] = xy.astype(np.float32)
        J.EfNSTGraphTransform(distType=dist, **kw)(d)
        got = T.efnst_graph(xy, distType=dist, **kw)
        for key in ("adj_org", "adj_norm"):
            want = d.data.uns["EfNSTGraph"][key]
            assert abs(got[key] - want).max() < 1e-7, key
    # the image front maps its arguments onto the morphology CNN as JAX's does
    calls = {}
    monkeypatch.setattr(jsf.MorphologyFeatureCNN, "__call__",
                        lambda self, data: calls.setdefault("jax", (
                            self.n_components, self.crop_size, self.target_size)))
    monkeypatch.setattr(T, "morphology_feature_cnn", lambda *a, **k: calls.setdefault(
        "port", (k["n_components"], k["crop_size"], k["target_size"])))
    J.EfNSTImageTransform()(data)
    T.efnst_image_feature(xy_pixel, None, device=CPU)
    assert calls["port"] == calls["jax"] == (50, 20, 64)
    # the preprocessing front, the morphology features stubbed on both sides
    monkeypatch.setattr(jsf.MorphologyFeatureCNN, "__call__", lambda self, data: (
        data.data.obsm.__setitem__(self.out, feat[:, :5]), data)[1])
    monkeypatch.setattr(S, "morphology_feature_cnn", lambda *a, **k: feat[:, :5])
    d = Data(AnnData(counts.copy(), var={"gid": np.arange(counts.shape[1])}))
    d.data.obsm["spatial_pixel"] = xy_pixel
    d.data.obsm["spatial"] = xy.astype(np.float32)
    J.EfNsSTRunner.preprocessing_pipeline(pca_n_comps=10, k=6, log_level="WARNING")(d)
    pcs, graph = np.asarray(d.data.obsm["CellPCA"]), d.data.obsp["StagateGraph"]
    inp = T.efnst_preprocess(counts, xy, xy_pixel, None, pca_n_comps=10, k=6, device=CPU)
    assert list(inp.genes) == list(d.data.var["gid"])
    np.testing.assert_allclose(inp.cell_pca, pcs, rtol=0, atol=1e-4 * np.abs(pcs).max())
    assert abs(inp.graph - sp.csr_matrix(graph)).max() == 0


def test_device_defaults(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.EfNsSTRunner()
    x, xy = np.ones((4, 3)), np.arange(8.0).reshape(4, 2)
    for call in (lambda: T.cal_gene_weight(x, 2), lambda: T.cal_weight_matrix(x, xy, xy),
                 lambda: T.find_adjacent_spot(x, np.eye(4)),
                 lambda: T.augment_adata(x, xy, xy), lambda: T.efnst_augment(x, xy, xy)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert T.EfNST is T.EfNsSTRunner
