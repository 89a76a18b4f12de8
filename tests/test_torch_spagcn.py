"""Port parity for SpaGCN (dance_tpu_torch.modules.spatial.spatial_domain.
spagcn), its graphs (transforms.graph.spatial_graph) and FilterGenesMatch.

Inputs are made with numpy from a seed (``torch_cases.spatial_slide``: 120
spots on a 12 x 10 grid in 3 domains, 40 genes, a 184 x 160 H&E-like
image). Tolerances: SpaGCN's q, loss and gradients at rtol 1e-5; one Adam
and five SGD steps on the same gradients at rtol 1e-6; the distance
matrices on the squared distances at 1e-5 of the largest (the Gram form's
rounding makes a spot's distance to itself ~1e-2 rather than 0 in either
package); the preprocessing's PCA at 1e-4 of the largest value; the short
fit's q at 1e-4 and its epoch count, labels and the SVG tools exactly.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from dance_tpu.data import AnnData, Data
from dance_tpu.modules.spatial.spatial_domain import spagcn as J
from dance_tpu.transforms import FilterGenesMatch as JFilterGenesMatch
from dance_tpu.transforms.graph import SpaGCNGraph, SpaGCNGraph2D
from dance_tpu.utils.loss import cluster_kl_loss as jax_kl
from dance_tpu.utils.loss import target_distribution as jax_target
from dance_tpu_torch.modules.spatial.spatial_domain import spagcn as T
from dance_tpu_torch.transforms.filter import FilterGenesMatch
from dance_tpu_torch.transforms.graph import spagcn_graph, spagcn_graph_2d
from dance_tpu_torch.utils.loss import cluster_kl_loss, target_distribution
from torch_cases import spatial_slide

CPU = torch.device("cpu")


def _slide_data(seed=0):
    counts, xy, xy_pixel, image, dom = spatial_slide(seed=seed)
    genes = np.array([f"g{i}" for i in range(counts.shape[1])], dtype=object)
    genes[[3, 7]] = ["MT-CO1", "ERCC-0001"]
    adata = AnnData(counts.copy(), obs={"label": dom}, var={"gid": np.arange(len(genes))})
    adata.var_names = genes
    adata.obsm["spatial"] = xy
    adata.obsm["spatial_pixel"] = xy_pixel
    adata.uns["image"] = image
    return Data(adata, train_size="all"), counts, genes, xy, xy_pixel, image, dom


def _sq_close(got, want):
    scale = float((want ** 2).max())
    np.testing.assert_allclose(got ** 2, want ** 2, rtol=0, atol=1e-5 * scale)


def test_graphs_filter_and_preprocess_match_jax():
    data, counts, genes, xy, xy_pixel, image, _ = _slide_data()
    _sq_close(spagcn_graph(xy, xy_pixel, image, alpha=1, beta=9, device=CPU),
              SpaGCNGraph(alpha=1, beta=9)(data.copy()).data.obsp["SpaGCNGraph"])
    _sq_close(spagcn_graph_2d(xy_pixel, device=CPU),
              SpaGCNGraph2D()(data.copy()).data.obsp["SpaGCNGraph2D"])
    # FilterGenesMatch keeps JAX's gene order; case_sensitive upper-cases both sides
    names = np.array(["Mt-a", "b", "ERCC1", "c-mt", "MT-x", "d"], dtype=object)
    for kw in ({"prefixes": ["MT-", "ERCC"]}, {"prefixes": ["mt-"], "suffixes": ["-MT"],
                                                "case_sensitive": True}):
        d = Data(AnnData(np.ones((2, 6), np.float32)))
        d.data.var_names = names
        JFilterGenesMatch(**kw)(d)
        got = FilterGenesMatch(**kw)(np.ones((2, 6)), names)[1]
        assert list(got) == list(d.data.var_names)
    assert list(FilterGenesMatch(prefixes=["mt-"], suffixes=["-MT"], case_sensitive=True)
                .select(names)) == [False, True, True, False, False, True]
    # the whole front against the JAX Compose
    inp = T.spagcn_preprocess(counts, genes, xy, xy_pixel, image, beta=9, dim=10, device=CPU)
    J.SpaGCN.preprocessing_pipeline(beta=9, dim=10, log_level="WARNING")(data)
    (embed, adj, adj_2d), _ = data.get_train_data()
    assert list(inp.genes) == list(data.data.var["gid"])
    np.testing.assert_allclose(inp.embed, embed, rtol=0, atol=1e-4 * np.abs(embed).max())
    _sq_close(inp.adj, np.asarray(adj))
    _sq_close(inp.adj_2d, np.asarray(adj_2d))


def _theta(seed=0, n=50, d=6, k=4):
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)).astype(np.float32)
    a_norm = a / a.sum(1, keepdims=True)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = (np.eye(d) + 0.1 * rng.standard_normal((d, d))).astype(np.float32)
    mu = rng.standard_normal((k, d)).astype(np.float32)
    return a_norm, x, w, mu


def test_soft_assign_step_and_optimizers_match_jax():
    a_norm, x, w, mu = _theta()
    z = a_norm @ (x @ w)
    q = T._soft_assign(torch.from_numpy(z), torch.from_numpy(mu))

    @jax.jit
    def jax_side(theta):
        jq = J._soft_assign(z, mu)
        p = jax_target(jq)
        return jq, jax.value_and_grad(
            lambda th: jax_kl(p, J._soft_assign(a_norm @ (x @ th[0]), th[1])))(theta)

    jq, (jl, jg) = jax_side((jnp.asarray(w), jnp.asarray(mu)))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-5)
    # the exponent is (alpha + 1), not DEC's (alpha + 1) / 2
    d2 = ((z[:, None] - mu[None]) ** 2).sum(-1)
    ref = (1 / (1 + d2 / 0.2 + 1e-8)) ** 1.2
    np.testing.assert_allclose(q.numpy(), ref / ref.sum(1, keepdims=True), rtol=1e-5)
    tw, tmu = (torch.tensor(v, requires_grad=True) for v in (w, mu))
    tp = target_distribution(T._soft_assign(torch.from_numpy(z), torch.from_numpy(mu)))
    loss = cluster_kl_loss(tp, T._soft_assign(torch.from_numpy(a_norm) @ (torch.from_numpy(x)
                                                                         @ tw), tmu))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for got, want in ((tw.grad, jg[0]), (tmu.grad, jg[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    # the three optimisers of spagcn.py:403-410 on JAX's gradients
    m = T.SpaGCN(l=1.0, device=CPU)
    grads = [tuple(np.asarray(g) * s for g in jg) for s in (1.0, -0.5, 2.0, 0.3, -1.0)]
    for opt, wd, tx, steps in (("admin", 0, optax.adam(0.01), 1),
                               ("admin", 0.1, optax.adamw(0.01, weight_decay=0.1), 1),
                               ("sgd", 0.1, optax.chain(optax.add_decayed_weights(0.1),
                                                        optax.sgd(0.01, momentum=0.9)), 5)):
        params = [torch.tensor(w), torch.tensor(mu)]
        topt = m._optimizer(params, opt, 0.01, wd)
        for g in grads[:steps]:
            for prm, gi in zip(params, g):
                prm.grad = torch.from_numpy(gi.copy())
            topt.step()

        @jax.jit
        def optax_steps(theta, gs, tx=tx):
            state = tx.init(theta)
            for g in gs:
                upd, state = tx.update(g, state, theta)
                theta = optax.apply_updates(theta, upd)
            return theta

        theta = optax_steps((jnp.asarray(w), jnp.asarray(mu)), grads[:steps])
        for prm, want in zip(params, theta):
            np.testing.assert_allclose(prm.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_search_l_calculate_p_and_fit_match_jax(monkeypatch):
    data, counts, genes, xy, xy_pixel, image, dom = _slide_data(seed=1)
    J.SpaGCN.preprocessing_pipeline(beta=9, dim=10, log_level="WARNING")(data)
    (embed, _, adj_2d), _ = data.get_train_data()
    embed, adj_2d = np.asarray(embed, np.float32), np.asarray(adj_2d, np.float32)
    l = T.search_l(0.5, adj_2d, device=CPU)
    assert l == J.search_l(0.5, adj_2d)
    np.testing.assert_allclose(T.calculate_p(adj_2d, l, device=CPU), J.calculate_p(adj_2d, l),
                               rtol=1e-5)
    np.testing.assert_allclose(T.calculate_adj_matrix(xy[:, 0], xy[:, 1]),
                               J.calculate_adj_matrix(xy[:, 0], xy[:, 1]), rtol=1e-12)
    for init, kw in (("louvain", {"res": 0.6}), ("kmeans", {"n_clusters": 3})):
        jm = J.SpaGCN(l=l, seed=0)
        steps = []
        step = jm._step
        monkeypatch.setattr(jm, "_step", lambda *a: steps.append(1) or step(*a),
                            raising=False)
        if init == "kmeans":
            from dance_tpu.ops import cluster as jc
            labels = {}
            km = jc.kmeans

            def jax_kmeans(*a, **k):
                res = km(*a, **k)
                labels["y"] = res.labels
                return res
            monkeypatch.setattr(jc, "kmeans", jax_kmeans)
        jm.fit((embed, adj_2d), epochs=80, init=init, lr=0.05, tol=0.02, **kw)
        tm = T.SpaGCN(l=l, seed=0, device=CPU)
        if init == "kmeans":
            monkeypatch.setattr(T, "kmeans", lambda *a, **k: SimpleNamespace(
                labels=torch.from_numpy(np.asarray(labels["y"]))))
        tm.fit((embed, adj_2d), epochs=80, init=init, lr=0.05, tol=0.02, **kw)
        assert tm.epochs_run == len(steps) == len(tm.history) < 80
        np.testing.assert_allclose(tm.predict_proba((embed, adj_2d)),
                                   jm.predict_proba((embed, adj_2d)), rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(tm.predict((embed, adj_2d)), jm.predict((embed, adj_2d)))
    assert tm.score((embed, adj_2d), dom) > 0.3


def test_search_set_res_matches_jax():
    """The resolution search's stepping (its short Louvain-initialised fits)
    ends at JAX's resolution, up and down from the start."""
    data = _slide_data(seed=1)[0]
    J.SpaGCN.preprocessing_pipeline(beta=9, dim=10, log_level="WARNING")(data)
    (embed, _, adj_2d), _ = data.get_train_data()
    x = (np.asarray(embed, np.float32), np.asarray(adj_2d, np.float32))
    l = J.search_l(0.5, x[1])
    for target in (2, 6):
        kw = dict(epochs=3, max_run=4)
        want = J.SpaGCN(seed=0).search_set_res(x, l, target, **kw)
        assert T.SpaGCN(seed=0, device=CPU).search_set_res(x, l, target, **kw) == want


def test_svg_tools_match_jax():
    _, counts, genes, xy, _, _, dom = _slide_data(seed=2)
    x = np.log1p(counts)
    xs, ys = xy[:, 0], xy[:, 1]
    np.testing.assert_allclose(T.Moran_I(x, xs, ys), J.Moran_I(x, xs, ys).to_numpy(), rtol=1e-10)
    np.testing.assert_allclose(T.Geary_C(x, xs, ys, knn=False),
                               J.Geary_C(x, xs, ys, knn=False).to_numpy(), rtol=1e-10)
    for r in (1.0, 1.5, 2.5):
        assert T.count_nbr(0, None, xs, ys, dom, r) == J.count_nbr(0, None, xs, ys, dom, r)
        assert (T.find_neighbor_clusters(0, None, xs, ys, dom, r)
                == J.find_neighbor_clusters(0, None, xs, ys, dom, r))
    assert (T.search_radius(1, None, xs, ys, dom, 0.5, 3.0, num_min=5, num_max=6)
            == J.search_radius(1, None, xs, ys, dom, 0.5, 3.0, num_min=5, num_max=6))
    # refine on the grid, whose spacings tie; the spot keeps its own vote
    noisy = np.where(np.random.default_rng(0).random(len(dom)) < 0.2, (dom + 1) % 3, dom)
    dis = T.calculate_adj_matrix(xs, ys)
    for shape in ("hexagon", "square"):
        assert T.refine(None, noisy, dis, shape) == J.refine(None, noisy, dis, shape)
    # a spot with 3 of its 4 square neighbours elsewhere: with its own vote, 2 of 5 stay
    one = np.zeros(5, int)
    one[[1, 2]] = 1
    line = np.array([[0, 1, 1, 2, 2], [1, 0, 2, 1, 3], [1, 2, 0, 3, 1], [2, 1, 3, 0, 4],
                     [2, 3, 1, 4, 0]], float)
    assert T.refine(None, one, line, "square") == J.refine(None, one, line, "square")
    adata = SimpleNamespace(X=x, obs=pd.DataFrame({"pred": dom}), var=pd.DataFrame(index=genes),
                            obsm={"spatial": xy})
    want = J.rank_genes_groups(adata, 0, [1, 2], "pred", log=True)
    got = T.rank_genes_groups(x, dom, 0, [1, 2], genes, log=True)
    for key in want.columns:
        if key == "genes":
            assert list(got[key]) == list(want[key])
        else:
            np.testing.assert_allclose(got[key], want[key].to_numpy(), rtol=1e-10, err_msg=key)
    for target in range(3):
        assert (T.SpaGCN(device=CPU).get_svgs(xy, dom, x, genes, target)
                == J.SpaGCN().get_svgs(adata, target))


def test_device_defaults(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.SpaGCN()
    xy, d = np.arange(6.0).reshape(3, 2), np.ones((3, 3))
    for call in (lambda: T.search_l(0.5, d), lambda: T.calculate_p(d, 1.0),
                 lambda: spagcn_graph(xy, xy, np.ones((4, 4, 3)), 1, 3),
                 lambda: spagcn_graph_2d(xy)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.raises(ValueError, match="l must be set"):
        T.SpaGCN(device=CPU).fit((np.zeros((3, 2)), np.zeros((3, 3))))
