"""Port parity for scMoGNN's graph and trunk
(dance_tpu_torch.modules.multi_modality.predict_modality.scmogcn) and the
helpers under it: ``build_hetero_graph`` in its three formats, ``_SAGERelation``,
``_Norm``, ``attention_agg`` in its six modes, the residuals and readouts, the
trunk's forward and gradients, edge dropout on each format, ``set_lr``,
``svd_embedding`` and the ``rmse``/``mse``/``nmi`` metrics.

Inputs are made with numpy from a seed and handed to both packages; the flax
weights are copied into the torch modules (scmogcn_flax_to_torch) and
dropout is off. The JAX BSR path runs its Pallas kernel in interpret mode on
the CPU, on tilings of one or two tiles. JAX runs eagerly here (no ``jit``),
so no case waits for a compile.

Tolerances: graphs exactly; a relation's forward at rtol 1e-5; norms and
the trunk's forward at atol 2e-5 + rtol 1e-4, its gradients at 1e-4 of each
tensor's largest entry. flax's ``GroupNorm``/``LayerNorm`` take the variance
as E[x²] − E[x]², torch in two passes; where a group's mean is large against
its spread the first loses digits to cancellation. The group norm takes
gcd(4, hidden) groups: at hidden 8 a group holds two features and the trunk's
outputs differed by 2.7e-3 of 1.29 (a near-zero variance meets the 1e-5
eps); at hidden 16, the width here, four features and 7.3e-6 of 1.97. Sums
run in another order too. ``svd_embedding`` at 1e-4 (float32 singular
vectors of two solvers); metrics to 1e-6 (NMI to 1e-12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dance_tpu.modules.multi_modality.predict_modality import scmogcn as J
from dance_tpu.ops.linalg import svd_embedding as jsvd_embedding
from dance_tpu.ops.sparse import csr_to_scipy as jcsr_to_scipy
from dance_tpu.utils import metrics as jmetrics
from dance_tpu_torch.modules.multi_modality.predict_modality import scmogcn as T
from dance_tpu_torch.nn.gnn import flax_dropout
from dance_tpu_torch.ops import bsr as tbsr
from dance_tpu_torch.ops.linalg import svd_embedding
from dance_tpu_torch.ops.sparse import CSRMatrix, DenseAdj
from dance_tpu_torch.utils import labeled_clustering_evaluate, mse, nmi, rmse
from dance_tpu_torch.utils.params import scmogcn_flax_to_torch

N_CELLS, N_FEATS, HID = 200, 100, 16


def _expr(seed=0, n=N_CELLS, g=N_FEATS):
    """Raw counts at ~10 % nonzero, every cell and feature with an entry."""
    rng = np.random.default_rng(seed)
    x = rng.poisson(3.0, (n, g)) * (rng.random((n, g)) < 0.1)
    x[np.arange(n), rng.integers(0, g, n)] += 1
    x[rng.integers(0, n, g), np.arange(g)] += 1
    return x.astype(np.float32)


def _pathway(seed=1, g=N_FEATS, n_edges=300):
    rng = np.random.default_rng(seed)
    uu, vv = rng.integers(0, g, n_edges), rng.integers(0, g, n_edges)
    return uu, vv, rng.random(n_edges).astype(np.float32) + 0.5


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _dense(adj) -> np.ndarray:
    """Any adjacency of either package as a dense numpy matrix."""
    if isinstance(adj, CSRMatrix):
        return sp.csr_matrix((adj.data.numpy(), adj.indices.numpy(), adj.indptr.numpy()),
                             shape=adj.shape).toarray()
    if isinstance(adj, DenseAdj):
        return adj.mat.numpy()
    if isinstance(adj, tbsr.BSRMatrix):
        return tbsr.bsr_spmm_reference(adj, torch.eye(adj.shape[1])).numpy()
    if hasattr(adj, "blocks"):  # JAX BSRMatrix
        out = np.zeros(adj.shape, np.float32)
        for t, r, c in zip(np.asarray(adj.blocks), np.asarray(adj.block_rows),
                           np.asarray(adj.block_cols)):
            out[r * 128:(r + 1) * 128, c * 128:(c + 1) * 128] += t
        return out
    if hasattr(adj, "mat"):
        return np.asarray(adj.mat)
    return jcsr_to_scipy(adj).toarray()


def _graphs(fmt: str, monkeypatch=None, **kw):
    """The JAX and the port graph of the same inputs in format ``fmt``. The
    dense format is what "auto" picks on the card (the port) or the TPU (JAX)
    for these inputs; it is forced here."""
    x = _expr()
    if fmt == "dense":
        monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
        monkeypatch.setattr(tbsr, "choose_adj_format", lambda *a, **k: "dense")
        use_bsr = "auto"
    else:
        use_bsr = fmt == "bsr"
    jg = J.build_hetero_graph(x, use_bsr=use_bsr, **kw)
    tg = T.build_hetero_graph(x, use_bsr=use_bsr, device="cpu", **kw)
    return jg, tg


# --------------------------------------------------------------------------
# the graph
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["csr", "bsr", "dense"])
def test_build_hetero_graph_matches_jax(fmt, monkeypatch):
    svd = np.random.default_rng(2).random((N_CELLS, 5)).astype(np.float32)
    bf = np.random.default_rng(3).random((N_CELLS, 3)).astype(np.float32)
    jg, tg = _graphs(fmt, monkeypatch, pathway_edges=_pathway(), cell_init="svd",
                     cell_svd_feats=svd, batch_features=bf)
    assert tg.fmt == fmt and tg.n_cells == N_CELLS and tg.n_feats == N_FEATS
    if fmt == "dense":
        assert isinstance(jg.f2c, type(jg.f2c)) and hasattr(jg.f2c, "mat")
    for rel in ("f2c", "c2f", "pw"):
        np.testing.assert_array_equal(_dense(getattr(tg, rel)), _dense(getattr(jg, rel)))
    np.testing.assert_array_equal(_dense(tg.f2c)[:N_CELLS, :N_FEATS], _expr())
    for field in ("deg_c", "deg_f", "deg_pw", "feature_ids", "cell_feats", "batch_feats"):
        np.testing.assert_array_equal(getattr(tg, field).numpy(), np.asarray(getattr(jg, field)))
    assert tg.cell_ids is None and jg.cell_ids is None
    if fmt == "bsr":
        for rel in ("f2c", "c2f"):
            t, j = getattr(tg, rel), getattr(jg, rel)
            np.testing.assert_array_equal(t.tiles.numpy(), np.asarray(j.blocks))
            np.testing.assert_array_equal(t.block_cols.numpy(), np.asarray(j.block_cols))
            assert t.shape == j.shape


def test_build_hetero_graph_no_bsr_and_flags():
    x = _expr()
    g = T.build_hetero_graph(x, use_bsr="no_bsr", device="cpu")
    assert g.fmt == "csr" and torch.equal(g.cell_ids, torch.ones(N_CELLS, dtype=torch.int64))
    with pytest.raises(ValueError, match="use_bsr must be"):
        T.build_hetero_graph(x, use_bsr="maybe", device="cpu")


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("agg", ["mean", "gcn"])
@pytest.mark.parametrize("fmt", ["csr", "bsr"])
def test_sage_relation_matches_jax(agg, fmt, monkeypatch):
    jg, tg = _graphs(fmt, monkeypatch)
    rng = np.random.default_rng(4)
    h_src, h_dst = (rng.standard_normal((n, 6)).astype(np.float32) for n in (N_FEATS, N_CELLS))
    jrel = J._SAGERelation(5, agg)
    params = jrel.init(jax.random.key(0), jg.f2c, h_src, h_dst, jg.deg_c)["params"]
    want = np.asarray(jrel.apply({"params": params}, jg.f2c, h_src, h_dst, jg.deg_c))
    trel = T._SAGERelation(6, 5, agg)
    p = _np_tree(params)
    if agg == "mean":  # Dense_0 is the self weight (no bias), Dense_1 the neighbour's
        state = {"fc_self.weight": p["Dense_0"]["kernel"].T,
                 "fc_neigh.weight": p["Dense_1"]["kernel"].T,
                 "fc_neigh.bias": p["Dense_1"]["bias"]}
    else:
        state = {"fc_neigh.weight": p["Dense_0"]["kernel"].T,
                 "fc_neigh.bias": p["Dense_0"]["bias"]}
    trel.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()})
    got = trel(tg.f2c, torch.from_numpy(h_src), torch.from_numpy(h_dst), tg.deg_c)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["group", "layer", "batch", "none"])
@pytest.mark.parametrize("dim", [6, 16])
def test_norm_matches_jax(kind, dim):
    rng = np.random.default_rng(5)
    h = (rng.standard_normal((40, dim)) * 2 + 1).astype(np.float32)
    jnorm = J._Norm(kind)
    # random scales and biases, so that the transfer of each is checked
    jp = jax.tree_util.tree_map(lambda v: rng.standard_normal(np.shape(v)).astype(np.float32),
                                _np_tree(jnorm.init(jax.random.key(0), h).get("params", {})))
    want = np.asarray(jnorm.apply({"params": jp}, h))
    tnorm = T._Norm(kind, dim)
    state = {k.split(".", 2)[2]: v for k, v in
             scmogcn_flax_to_torch({"conv_norm_0": jp}).items()} if jp else {}
    tnorm.load_state_dict(state)
    got = tnorm(torch.from_numpy(h)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)
    if kind == "group":
        assert tnorm.norm.num_groups == np.gcd(4, dim)


# --------------------------------------------------------------------------
# the trunk
# --------------------------------------------------------------------------

BASE = dict(out_size=6, feature_size=N_FEATS, hidden_size=HID, conv_layers=2,
            edge_dropout=0.0, model_dropout=0.0)


def _pair(jg, cfg):
    """The JAX trunk, its initial parameters and the port trunk with them."""
    jn = J.ScMoGCN(**{**BASE, **cfg})
    params = jn.init({"params": jax.random.key(1), "dropout": jax.random.key(1)}, jg)["params"]
    tcfg = {**BASE, **cfg}
    if tcfg.get("cell_init", "none") != "none":
        tcfg["cell_feat_size"] = jg.cell_feats.shape[1]
    tn = T.ScMoGCN(**tcfg)
    missing, unexpected = tn.load_state_dict(scmogcn_flax_to_torch(_np_tree(params)),
                                             strict=False)
    assert not unexpected
    # only modules flax never called lack parameters there (e.g. the pathway
    # norms of a "sum" aggregation)
    assert all(k.startswith("conv_norm.") for k in missing), missing
    return jn, params, tn


def _check_forward(jg, tg, cfg):
    jn, params, tn = _pair(jg, cfg)
    want = np.asarray(jn.apply({"params": params}, jg))
    got = tn(tg).detach().numpy()
    assert got.shape == (N_CELLS, 6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("agg", ["sum", "attention", "one_gate", "two_gate", "alpha", "cat"])
def test_attention_agg_modes_match_jax(agg, monkeypatch):
    jg, tg = _graphs("csr", monkeypatch, pathway_edges=_pathway())
    cfg = dict(pathway=True, pathway_aggregation=agg, subpath_activation=agg == "one_gate")
    _check_forward(jg, tg, cfg)
    if agg == "alpha":
        _check_forward(jg, tg, dict(cfg, pathway_alpha=-1.0))  # the learned softmax weights


@pytest.mark.parametrize("residual,initial", [("none", False), ("res_add", False),
                                              ("res_add", True), ("res_cat", False),
                                              ("res_cat", True)])
def test_residuals_match_jax(residual, initial, monkeypatch):
    jg, tg = _graphs("csr", monkeypatch)
    _check_forward(jg, tg, dict(residual=residual, initial_residual=initial, conv_layers=3))


@pytest.mark.parametrize("readout", [dict(), dict(weighted_sum=True),
                                     dict(no_readout_concatenate=True),
                                     dict(readout_layers=2, output_relu="relu"),
                                     dict(output_relu="leaky_relu", activation="relu")])
def test_readouts_match_jax(readout, monkeypatch):
    jg, tg = _graphs("csr", monkeypatch)
    _check_forward(jg, tg, readout)


def test_initial_embedding_options_match_jax(monkeypatch):
    svd = np.random.default_rng(6).standard_normal((N_CELLS, 5)).astype(np.float32)
    bf = np.random.default_rng(7).random((N_CELLS, 3)).astype(np.float32)
    jg, tg = _graphs("csr", monkeypatch, cell_init="svd", cell_svd_feats=svd,
                     batch_features=bf)
    _check_forward(jg, tg, dict(cell_init="svd", batch_num=3, embedding_layers=2,
                                normalization="layer", activation="prelu"))


@pytest.mark.parametrize("fmt", ["csr", "bsr", "dense"])
def test_trunk_forward_and_grads_match_jax(fmt, monkeypatch):
    """The default trunk (4 layers cut to 2, res_cat, group norm, gelu): its
    output and every parameter's gradient of a weighted sum of it."""
    jg, tg = _graphs(fmt, monkeypatch)
    jn, params, tn = _pair(jg, {})
    w = np.random.default_rng(8).standard_normal((N_CELLS, 6)).astype(np.float32)

    def loss(p):
        return jnp.sum(jn.apply({"params": p}, jg) * w)

    want, jgrads = jax.value_and_grad(loss)(params)
    got = (tn(tg) * torch.from_numpy(w)).sum()
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    jgrads = scmogcn_flax_to_torch(_np_tree(jgrads))
    grads = dict(tn.named_parameters())
    assert set(jgrads) == set(grads)
    for name, g in jgrads.items():
        scale = float(g.abs().max()) or 1.0
        mine = grads[name].grad  # None where the output does not use it (wt); JAX gives 0
        gap = float(((torch.zeros_like(g) if mine is None else mine) - g).abs().max()) / scale
        assert gap < 1e-4, (name, gap)
    # the encoder output (the JE embedding before any head) agrees too
    np.testing.assert_allclose(tn.encode(tg).detach().numpy(),
                               np.asarray(jn.apply({"params": params}, jg, method=jn.encode)),
                               rtol=1e-4, atol=2e-5)


def test_transfer_rejects_unknown_names():
    with pytest.raises(KeyError, match="unexpected ScMoGCN"):
        scmogcn_flax_to_torch({"bogus_0": {}})
    with pytest.raises(KeyError, match="unexpected _SAGERelation"):
        scmogcn_flax_to_torch({"conv_f2c_0": {"Dense_0": {"kernel": np.zeros((2, 2))},
                                              "Dense_2": {}}})


# --------------------------------------------------------------------------
# edge dropout: the same edges in every format
# --------------------------------------------------------------------------


def test_edge_dropout_zeroes_the_same_edges_in_each_format(monkeypatch):
    """Given the same mask (here: drop the edges whose weight is odd), CSR,
    dense and BSR lose the same edges, zero slots stay zero and the degrees
    are kept; JAX's ``_drop_adj`` gives the same weights."""
    rate = 0.3

    def drop(w, deterministic=False):
        lib = torch if isinstance(w, torch.Tensor) else jnp
        keep = (w % 2 == 0) & (w != 0)
        return lib.where(keep, w / (1 - rate), 0.0)

    ref = None
    for fmt in ("csr", "dense", "bsr"):
        jg, tg = _graphs(fmt, monkeypatch)
        tdrop, jdrop = T._drop_adj(tg.f2c, drop), J._drop_adj(jg.f2c, drop, False)
        got = _dense(tdrop)[:N_CELLS, :N_FEATS]
        np.testing.assert_array_equal(got, _dense(jdrop)[:N_CELLS, :N_FEATS])
        assert not (got[_expr() == 0]).any()
        if ref is None:
            ref = got
        np.testing.assert_array_equal(got, ref)
        if fmt == "bsr":
            assert tdrop.rowptr is tg.f2c.rowptr and tdrop._pattern is tg.f2c
        if fmt == "dense":
            assert tdrop.degrees is tg.f2c.degrees
    assert 0 < (ref != 0).sum() < (_expr() != 0).sum()
    assert T._drop_adj(tg.f2c, None) is tg.f2c


def test_dropout_is_flax_dropout():
    x = torch.ones(20000)
    gen = torch.Generator().manual_seed(0)
    y = flax_dropout(x, 0.3, gen)
    values = torch.unique(y).tolist()
    assert len(values) == 2 and values[0] == 0.0 and values[1] == pytest.approx(1 / 0.7)
    assert abs(float((y == 0).float().mean()) - 0.3) < 0.02
    assert flax_dropout(x, 0.3, None) is x and flax_dropout(x, 0.0, gen) is x
    assert not flax_dropout(x, 1.0, gen).any()


# --------------------------------------------------------------------------
# the lr schedule, svd_embedding and the metrics
# --------------------------------------------------------------------------


def test_set_lr_matches_jax_schedule():
    """``set_lr`` against JAX's ``_set_lr`` over 2,000 epochs, as a function:
    no decay up to epoch 1200, then ``lr_decay`` every 15th epoch."""
    from types import SimpleNamespace

    jw = J.ScMoGCNWrapper(seed=0)
    jw._lr = jw.args.learning_rate
    state = SimpleNamespace(hyperparams={"learning_rate": jw._lr})
    opt = torch.optim.AdamW([torch.nn.Parameter(torch.zeros(1))], lr=jw._lr)
    lr, seen = jw.args.learning_rate, []
    for epoch in range(2000):
        state = jw._set_lr(state, epoch)
        lr = T.set_lr(opt, lr, epoch, jw.args.lr_decay)
        assert lr == jw._lr == opt.param_groups[0]["lr"] == state.hyperparams["learning_rate"]
        seen.append(lr)
    assert seen[1200] == 1e-2 and seen[1215] < seen[1214]
    assert len(set(seen)) == 1 + len(range(1215, 2000, 15))


def test_svd_embedding_matches_jax():
    x = np.random.default_rng(9).standard_normal((50, 30)).astype(np.float32)
    emb, comp = svd_embedding(torch.from_numpy(x), 6)
    jemb, jcomp = jsvd_embedding(jnp.asarray(x), 6)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), rtol=1e-4, atol=1e-4)
    # float32 singular vectors from two LAPACK-style solvers: ~1e-5 apart
    np.testing.assert_allclose(comp.numpy(), np.asarray(jcomp), rtol=1e-4, atol=1e-4)


def test_metrics_match_jax():
    rng = np.random.default_rng(10)
    y, p = rng.standard_normal((40, 5)), rng.standard_normal((40, 5))
    assert mse(y, p) == pytest.approx(jmetrics.mse(y, p), rel=1e-6)
    assert rmse(y, p) == pytest.approx(jmetrics.rmse(y, p), rel=1e-6)
    assert rmse(y[:, 0], p[:, 0]) == pytest.approx(jmetrics.rmse(y[:, 0], p[:, 0]), rel=1e-6)
    for _ in range(50):
        n = int(rng.integers(1, 60))
        a, b = rng.integers(0, rng.integers(1, 6), n), rng.integers(0, rng.integers(1, 6), n)
        assert nmi(a, b) == pytest.approx(jmetrics.nmi(a, b), abs=1e-12)


def test_labeled_clustering_evaluate_matches_jax():
    rng = np.random.default_rng(11)
    labels = np.repeat(np.arange(4), 30)
    emb = (np.eye(4)[labels] * 10 + rng.normal(0, 0.3, (120, 4))).astype(np.float32)
    got = labeled_clustering_evaluate(emb, labels, n_clusters=4, device="cpu")
    assert got == jmetrics.labeled_clustering_evaluate(emb, labels, n_clusters=4)
    assert got == {"dance_nmi": 1.0, "dance_ari": 1.0}
