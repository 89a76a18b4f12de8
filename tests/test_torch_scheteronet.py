"""Port parity for scHeteroNet (dance_tpu_torch.modules.single_modality.
cell_type_annotation.scheteronet) and what it stands on: the OOD measures,
the MLP, the cell kNN graph, the hop adjacencies, the preprocessing and the
splits; the network's forward, gradients and one Adam step in three
adjacency formats; 3-epoch fits from the same weights; the energy
propagation; a whole fit against JAX's own spread; the SpMM launches; the
formats ``"auto"`` picks; the build cache and the device defaults.

Inputs are made with numpy from a seed and handed to both packages; flax
weights are copied into the torch net (scheteronet_flax_to_torch, through a
patched ``scHeteroNet._make_net``), with dropout off where values are held
to each other. Tolerances: the measures against scikit-learn at 1e-12
(float64); graphs, preprocessing and splits exactly, the float32 features at
1e-6; forwards at rtol 1e-5, gradients at 1e-5 of their largest entry, the
Adam step and 3-epoch fits at rtol 1e-4 / atol 1e-5 (float32 sums in
another order, grown by Adam steps of about the learning rate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch
from sklearn.metrics import average_precision_score, roc_auc_score

from dance_tpu.data import AnnData, Data
from dance_tpu.datasets.singlemodality import cell_label_to_df
from dance_tpu.graph import Graph as JGraph
from dance_tpu.modules.single_modality.cell_type_annotation import scheteronet as J
from dance_tpu.nn.mlp import VanillaMLP as JMLP
from dance_tpu.nn.mlp import buildNetwork as jbuild
from dance_tpu.ops.sparse import csr_from_scipy as jcsr
from dance_tpu.transforms.graph import HeteronetGraph
from dance_tpu.utils.loss import zinb_nll as jzinb
from dance_tpu.utils.metrics import ood_measures as jood
from dance_tpu_torch.graph import Graph
from dance_tpu_torch.modules.single_modality.cell_type_annotation import scheteronet as T
from dance_tpu_torch.modules.single_modality.cell_type_annotation import (
    scHeteroNet, scheteronet_preprocess, set_split)
from dance_tpu_torch.nn.mlp import VanillaMLP, buildNetwork
from dance_tpu_torch.ops import bsr as tbsr
from dance_tpu_torch.ops.sparse import CSRMatrix, DenseAdj, csr_from_scipy, dense_adj_from_scipy
from dance_tpu_torch.transforms.graph import heteronet_graph
from dance_tpu_torch.utils import average_precision, ood_measures, roc_auc
from dance_tpu_torch.utils.loss import zinb_nll
from dance_tpu_torch.utils.params import _dense, scheteronet_flax_to_torch

CPU = torch.device("cpu")


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _counts(n=240, g=60, n_types=4, seed=0, rare=None):
    """Poisson counts of cells in types (a fifth of the genes 4 x up in each
    type); ``rare`` cells of the last type when given."""
    rng = np.random.default_rng(seed)
    types = rng.integers(0, n_types - (rare is not None), n)
    if rare is not None:
        types[rng.choice(n, rare, replace=False)] = n_types - 1
    rates = np.tile(rng.gamma(2.0, 0.5, g), (n_types, 1))
    for t in range(n_types):
        rates[t, rng.choice(g, g // 5, replace=False)] *= 4.0
    return rng.poisson(rates[types] * rng.gamma(4.0, 0.25, (n, 1))).astype(np.float32), types


def _model_inputs(n=160, g=30, seed=1):
    """Log features, counts, labels and a 5-NN graph of them."""
    counts, types = _counts(n, g, 3, seed)
    x = np.log1p(counts).astype(np.float32)
    return x, counts, types, heteronet_graph(x, knn_num=5)


def _load_into(model, state, monkeypatch):
    make = model._make_net

    def made(*args):
        net = make(*args)
        net.load_state_dict(state)
        return net

    monkeypatch.setattr(model, "_make_net", made)


def _jax_init(x, adj, n_classes, hidden=8, seed=0):
    a1, a2 = J.build_hop_adjacencies(adj)
    net = J._HeteroNet(n_classes=n_classes, hidden=hidden, num_layers=2, n_genes=x.shape[1])
    params = net.init(jax.random.key(seed), jcsr(a1), jcsr(a2), jnp.asarray(x),
                      method=lambda m, a, b, xx: (m(a, b, xx), m.zinb(m.embed(a, b, xx))))
    return net, params["params"]


# --------------------------------------------------------------------------
# measures, MLP
# --------------------------------------------------------------------------


@pytest.mark.parametrize("ties", [False, True])
def test_ood_measures_match_sklearn_and_jax(ties):
    rng = np.random.default_rng(3)
    for _ in range(20):
        ind = rng.normal(1.0, 1.0, rng.integers(1, 40))
        ood = rng.normal(0.0, 1.0, rng.integers(1, 40))
        if ties:
            ind, ood = np.round(ind), np.round(ood)
        labels = np.r_[np.ones(len(ind)), np.zeros(len(ood))]
        scores = np.r_[ind, ood]
        assert roc_auc(labels, scores) == pytest.approx(roc_auc_score(labels, scores), abs=1e-12)
        assert average_precision(labels, scores) == pytest.approx(
            average_precision_score(labels, scores), abs=1e-12)
        np.testing.assert_allclose(ood_measures(ind, ood), jood(ind, ood), atol=1e-12)
    with pytest.raises(ValueError):
        ood_measures([], [1.0])


def test_vanilla_mlp_and_build_network_match_flax():
    x = np.random.default_rng(4).random((9, 6)).astype(np.float32)
    jm = JMLP(output_dim=3, hidden_dims=(5, 4))
    p = _np_tree(jm.init(jax.random.key(0), jnp.asarray(x))["params"])
    tm = VanillaMLP(6, 3, hidden_dims=(5, 4))
    state = {}
    for i in range(3):
        _dense(state, f"layers.{i}", p[f"Dense_{i}"])
    tm.load_state_dict(state)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm.apply({"params": p}, jnp.asarray(x))), rtol=1e-5,
                               atol=1e-6)
    fresh = VanillaMLP(600, 3, hidden_dims=(400,))
    fresh.reset_parameters(torch.Generator().manual_seed(0))
    bound = np.sqrt(6 / 1000)  # flax's xavier_uniform
    w = fresh.layers[0].weight.detach().numpy()
    assert np.abs(w).max() <= bound and np.abs(w).max() > 0.95 * bound
    assert not fresh.layers[0].bias.detach().any()

    jseq = jbuild([6, 5, 2], activation="tanh")
    p = _np_tree(jseq.init(jax.random.key(1), jnp.asarray(x))["params"])
    tseq = buildNetwork([6, 5, 2], activation="tanh")
    state = {}
    for i, k in ((0, "layers_0"), (2, "layers_2")):
        _dense(state, str(i), p[k])
    tseq.load_state_dict(state)
    np.testing.assert_allclose(tseq(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jseq.apply({"params": p}, jnp.asarray(x))), rtol=1e-5,
                               atol=1e-6)


# --------------------------------------------------------------------------
# graphs, preprocessing, splits
# --------------------------------------------------------------------------


def test_heteronet_graph_and_hops_match_jax():
    x, counts, _, tg = _model_inputs()
    data = Data(AnnData(X=x.copy()))
    HeteronetGraph(knn_num=5)(data)
    jg = data.data.uns["HeteronetGraph"]
    assert (tg.adj != jg.adj).nnz == 0 and tg.info == jg.info
    np.testing.assert_array_equal(tg.ndata["feat"], jg.ndata["feat"])
    for got, want in zip(T.build_hop_adjacencies(tg.adj), J.build_hop_adjacencies(jg.adj)):
        for field in ("data", "indices", "indptr"):
            np.testing.assert_array_equal(getattr(sp.csr_matrix(got), field),
                                          getattr(sp.csr_matrix(want), field))
    with pytest.raises(ValueError, match="l2"):
        heteronet_graph(x, distance_metrics="cosine")


def _jax_pipeline_data(counts, types):
    names = [f"type{t}" for t in types]
    adata = AnnData(X=counts.copy(), obs={"idx": np.arange(len(types))},
                    var={"gidx": np.arange(counts.shape[1])})
    adata.obsm["cell_type"] = cell_label_to_df(names, sorted(set(names)), index=adata.obs.index)
    return Data(adata)


@pytest.mark.parametrize("sparse,n_top", [(False, 4000), (True, 4000), (False, 25)])
def test_scheteronet_preprocess_matches_jax_pipeline(sparse, n_top, monkeypatch):
    """Step by step against the JAX Compose: the rare type and its cells
    go, the genes under 3 counts and a cell without counts go, the HVGs
    (all genes when ``n_top_genes`` exceeds them, as JAX's cut keeps every
    gene at or above the last finite dispersion), the raw counts, the size
    factors, the log features and the graph."""
    counts, types = _counts(200, 50, 4, seed=5, rare=8)
    counts[:, 3] = 0
    counts[0, 4], counts[:, 4] = 2, 0
    counts[17] = 0
    x = sp.csr_matrix(counts) if sparse else counts
    data = _jax_pipeline_data(x, types)
    pipeline = J.scHeteroNet.preprocessing_pipeline(log_level="WARNING")
    for step in pipeline.transforms:
        if type(step).__name__ == "HighlyVariableGenesLogarithmizedByTopGenes":
            step.func_kwargs["n_top_genes"] = n_top
    pipeline(data)
    inp = scheteronet_preprocess(x, [f"type{t}" for t in types], n_top_genes=n_top)
    ad = data.data
    np.testing.assert_array_equal(inp.cells, ad.obs["idx"].to_numpy())
    np.testing.assert_array_equal(inp.genes, ad.var["gidx"].to_numpy())
    assert 17 not in inp.cells and not np.isin(inp.cells, np.nonzero(types == 3)[0]).any()
    assert (len(inp.genes) == 48) == (n_top == 4000)
    raw = ad.raw.X
    np.testing.assert_array_equal(inp.x_raw, raw.toarray() if sp.issparse(raw) else raw)
    np.testing.assert_array_equal(inp.size_factors, ad.obs["size_factors"].to_numpy())
    jg = ad.uns["HeteronetGraph"]
    np.testing.assert_allclose(inp.x, jg.ndata["feat"], rtol=1e-6, atol=0)
    assert (inp.graph.adj != jg.adj).nnz == 0
    np.testing.assert_array_equal(inp.labels, ad.obsm["cell_type"].to_numpy().argmax(1))
    np.testing.assert_array_equal(inp.cell_types, [f"type{t}" for t in range(4)])


def test_set_split_and_graph_split_match_jax():
    counts, types = _counts(120, 20, 4, seed=6, rare=7)
    data = _jax_pipeline_data(counts, types)
    tr, va, te = range(0, 80), range(80, 100), range(100, 120)
    J.set_split(data, tr, va, te)
    split = set_split(types, tr, va, te)
    for key in ("train_idx", "val_idx", "test_idx", "ood_idx", "id_idx"):
        assert split[key] == list(data.data.uns[key]), key
    assert split["ood_idx"] == np.nonzero(types == 3)[0].tolist()
    onehot = np.eye(4)[types]
    assert set_split(onehot, tr, va, te) == split
    adj = sp.random(120, 120, density=0.05, random_state=0, format="csr")
    tg = T.set_graph_split(split, None, Graph(adj))
    jg = J.set_graph_split(data.data, None, JGraph(adj))
    for name in ("train", "val", "test", "id", "ood"):
        np.testing.assert_array_equal(tg.ndata[f"{name}_mask"], jg.ndata[f"{name}_mask"])


def test_reference_helpers_match_jax():
    rng = np.random.default_rng(7)
    y = rng.integers(0, 2, 50)
    s = np.round(rng.normal(size=50) + y, 1)
    assert T.fpr_and_fdr_at_recall(y, s) == J.fpr_and_fdr_at_recall(y, s)
    assert T.fpr_and_fdr_at_recall(y * 3, s, pos_label=3) == J.fpr_and_fdr_at_recall(
        y * 3, s, pos_label=3)
    with pytest.raises(ValueError, match="binary"):
        T.fpr_and_fdr_at_recall(y + 2, s)
    np.testing.assert_array_equal(T.stable_cumsum(s), J.stable_cumsum(s))
    out = rng.random((50, 3))
    assert T.eval_acc(y, out) == J.eval_acc(y, out)
    assert T.eval_acc(np.eye(3)[y], out) == J.eval_acc(np.eye(3)[y], out)
    np.testing.assert_allclose(T.get_measures(s[y == 1], s[y == 0]),
                               J.get_measures(s[y == 1], s[y == 0]), atol=1e-12)
    ds = T.NCDataset("cells")
    ds.label = y
    assert len(ds) == 1 and ds[0][1] is y and repr(ds) == "NCDataset(1)"
    with pytest.raises(IndexError):
        ds[1]
    assert T.HeteroNet is T._HeteroNet and T.ZINBDecoder is T._ZINBDecoder
    assert T.MLP is VanillaMLP


# --------------------------------------------------------------------------
# the network: forward, gradients, one Adam step
# --------------------------------------------------------------------------


def _hop(fmt, a):
    return {"csr": csr_from_scipy, "dense": dense_adj_from_scipy,
            "bsr": lambda m: tbsr.bsr_from_scipy(m, block=128)}[fmt](a)


@pytest.mark.parametrize("fmt", ["csr", "dense", "bsr"])
def test_heteronet_step_matches_jax(fmt):
    """One forward (logits and the concatenation), the loss with the ZINB
    and contrastive terms, its gradients and one Adam step, from the same
    weights; JAX on CSR."""
    x, counts, types, g = _model_inputs(seed=8)
    jnet, params = _jax_init(x, g.adj, 3)
    a1, a2 = J.build_hop_adjacencies(g.adj)
    ja1, ja2, jx = jcsr(a1), jcsr(a2), jnp.asarray(x)
    y = jnp.asarray(types)
    sf = jnp.asarray(counts.sum(1) / np.median(counts.sum(1)), jnp.float32)
    mask = jnp.asarray((np.arange(len(x)) % 3 != 0).astype(np.float32))

    def jloss(p):
        logits, h = jnet.apply({"params": p}, ja1, ja2, jx)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, y)
        mean, disp, pi = jnet.apply({"params": p}, h, method=jnet.zinb)
        nll = jzinb(jnp.asarray(counts), mean, disp, pi, scale_factor=sf[:, None],
                    reduce=False).sum(1)
        loss = (ce * mask).sum() / mask.sum() + 0.1 * (nll * mask).sum() / mask.sum()
        return loss + 0.1 * J.contrastive_loss(logits, logits * 0.9), (logits, h)

    (want_loss, (want_logits, want_h)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    tx = optax.adam(1e-2)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    want_after = scheteronet_flax_to_torch(_np_tree(optax.apply_updates(params, updates)))

    tnet = T._HeteroNet(x.shape[1], 3, hidden=8, num_layers=2, n_genes=x.shape[1])
    tnet.load_state_dict(scheteronet_flax_to_torch(_np_tree(params)))
    t1, t2 = _hop(fmt, a1), _hop(fmt, a2)
    xt, yt = torch.from_numpy(x), torch.from_numpy(types)
    sft, mt = torch.tensor(np.asarray(sf)), torch.tensor(np.asarray(mask))
    logits, h = tnet(t1, t2, xt)
    ce = torch.nn.functional.cross_entropy(logits, yt, reduction="none")
    mean, disp, pi = tnet.zinb(h)
    nll = zinb_nll(torch.from_numpy(counts), mean, disp, pi, scale_factor=sft[:, None],
                   reduce=False).sum(1)
    loss = (ce * mt).sum() / mt.sum() + 0.1 * (nll * mt).sum() / mt.sum()
    loss = loss + 0.1 * T.contrastive_loss(logits, logits * 0.9)
    opt = torch.optim.Adam(tnet.parameters(), lr=1e-2)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want_h), rtol=1e-5, atol=1e-5)
    want_grads = scheteronet_flax_to_torch(_np_tree(jgrads))
    for name, p in tnet.named_parameters():
        scale = float(np.abs(want_grads[name].numpy()).max())
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=0,
                                   atol=1e-5 * scale + 1e-9, err_msg=name)
    opt.step()
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_after[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_scheteronet_flax_to_torch_rejects_unknown_names():
    with pytest.raises(KeyError, match="unexpected"):
        scheteronet_flax_to_torch({"bns_0": {"scale": np.ones(2)}})
    with pytest.raises(KeyError, match="unexpected"):
        scheteronet_flax_to_torch({"decoder": {"Dense_5": {}}})


# --------------------------------------------------------------------------
# fits
# --------------------------------------------------------------------------


@pytest.mark.parametrize("use_bsr", [False, True])
def test_fit_matches_jax(use_bsr, monkeypatch):
    """3 epochs from the same weights with dropout off, ZINB on, against
    JAX's CSR fit; BSR permutes the cells and puts every output back."""
    x, counts, types, g = _model_inputs(seed=9)
    train = np.arange(0, len(x), 2)
    _, init = _jax_init(x, g.adj, 3)
    jm = J.scHeteroNet(hidden_channels=8, dropout=0.0, seed=0)
    jm.fit(JGraph(g.adj, ndata={"feat": x}), types, x_raw=counts, epochs=3, train_idx=train,
           use_bsr=False)
    tm = scHeteroNet(hidden_channels=8, dropout=0.0, seed=0, device="cpu")
    _load_into(tm, scheteronet_flax_to_torch(_np_tree(init)), monkeypatch)
    tm.fit(g, types, x_raw=counts, epochs=3, train_idx=train, use_bsr=use_bsr)
    assert tm.fmts == (("bsr",) * 2 if use_bsr else ("csr",) * 2)
    assert (tm._perm is not None) == use_bsr
    want = scheteronet_flax_to_torch(_np_tree(jm.params))
    for name, p in tm.net.named_parameters():
        # a weight whose gradient is at rounding level (a ZINB head's unit
        # that hardly moves) takes Adam steps of about lr either way: held at
        # 2 % of lr, the rest at rtol 1e-4
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-4, atol=2e-4,
                                   err_msg=name)
    np.testing.assert_allclose(tm.predict_proba(), jm.predict_proba(), rtol=1e-4, atol=1e-5)
    for kw in ({}, {"use_2hop": True, "oodprop": 1}, {"use_prop": False, "T": 2.0}):
        np.testing.assert_allclose(tm.detect(**kw), jm.detect(**kw), rtol=1e-4, atol=1e-5)
    ind, ood = np.nonzero(types != 2)[0], np.nonzero(types == 2)[0]
    np.testing.assert_allclose(tm.evaluate_ood(ind, ood), jm.evaluate_ood(ind, ood), atol=1e-6)
    assert len(tm.history) == 3 and all(np.isfinite(h["loss"]) for h in tm.history)
    np.testing.assert_array_equal(tm.predict(idx=train), tm.predict_proba().argmax(1)[train])
    assert tm.score(None, types) == pytest.approx(float((tm.predict() == types).mean()))


def test_propagation_matches_jax():
    rng = np.random.default_rng(11)
    a = sp.random(40, 40, density=0.1, random_state=11, format="csr", dtype=np.float32)
    a.data[:] = 1.0
    e = rng.normal(size=40).astype(np.float32)
    jm, tm = J.scHeteroNet(), scHeteroNet(device="cpu")
    for layers, alpha in ((1, 0.5), (3, 0.3)):
        np.testing.assert_allclose(tm.propagation(e, csr_from_scipy(a), layers, alpha),
                                   jm.propagation(e, jcsr(a), layers, alpha), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(tm.two_hop_propagation(e, csr_from_scipy(a), layers, alpha),
                                   jm.two_hop_propagation(e, jcsr(a), layers, alpha),
                                   rtol=1e-6, atol=1e-6)


def test_whole_fit_within_jax_spread():
    """At the defaults (dropout 0.2, ZINB on), 40 epochs on the rare-type
    split of :func:`set_split`: the port's test accuracy and OOD AUROC are
    no lower than JAX's lowest over two seeds less 0.05 (JAX's own AUROC
    spreads by ~0.15 between seeds here)."""
    counts, types = _counts(300, 40, 4, seed=12, rare=20)
    inp = scheteronet_preprocess(counts, types, n_top_genes=40)
    n = len(inp.labels)
    split = set_split(inp.labels, range(0, n, 2), (), range(1, n, 2))
    test = np.asarray(split["test_idx"])
    runs = {"jax": [], "port": []}
    jm = J.scHeteroNet(hidden_channels=16)  # one instance: its compiled epochs are reused
    for seed in (0, 1):
        jm.seed = seed
        jm.fit(JGraph(inp.graph.adj, ndata={"feat": inp.x}), inp.labels, x_raw=inp.x_raw,
               size_factors=inp.size_factors, epochs=40, train_idx=split["train_idx"])
        tm = scHeteroNet(hidden_channels=16, seed=seed, device="cpu")
        tm.fit(inp.graph, inp.labels, x_raw=inp.x_raw, size_factors=inp.size_factors, epochs=40,
               train_idx=split["train_idx"])
        for key, m in (("jax", jm), ("port", tm)):
            acc = float((m.predict(idx=test) == inp.labels[test]).mean())
            runs[key].append((acc, m.evaluate_ood(split["id_idx"], split["ood_idx"])[0]))
    jax_runs, port_runs = np.array(runs["jax"]), np.array(runs["port"])
    assert (port_runs >= jax_runs.min(0) - 0.05).all(), (jax_runs, port_runs)
    assert port_runs[:, 0].min() > 0.8


# --------------------------------------------------------------------------
# launches, formats, cache, devices
# --------------------------------------------------------------------------


def test_fit_counts_spmm_launches_and_formats(monkeypatch):
    """Two hops x two layers forward and their ``Aᵀḡ`` an epoch, four in
    ``predict_proba`` and four in ``detect``; ``"auto"`` is CSR on the CPU,
    and where the rule says dense for one hop only, that hop is dense and
    the other stays BSR, both in one step (the JAX per-hop upgrade)."""
    calls = {"spmm": 0}
    spmm = tbsr.bsr_spmm

    def count(*args, **kw):
        calls["spmm"] += 1
        return spmm(*args, **kw)

    monkeypatch.setattr(tbsr, "bsr_spmm", count)
    x, counts, types, g = _model_inputs(seed=13)
    m = scHeteroNet(hidden_channels=8, seed=0, device="cpu")
    m.fit(g, types, x_raw=counts, epochs=3, use_bsr=True)
    m.predict_proba()
    m.detect()
    assert calls["spmm"] == 8 * 3 + 4 + 4
    m.fit(g, types, x_raw=counts, epochs=1)
    assert m.fmts == ("csr", "csr") and m._perm is None and calls["spmm"] == 32

    # the rule on the card, emulated: BSR for the graph, dense for the two-hop only
    m._build_cache_key = None  # the same inputs: the CSR build would be kept
    two_hop = T.build_hop_adjacencies(tbsr.rcm_reorder(g.adj)[1])[1]
    monkeypatch.setattr(T, "resolve_use_bsr", lambda *a, **k: True)
    monkeypatch.setattr(T, "choose_adj_format",
                        lambda a, **k: "dense" if a.nnz == two_hop.nnz else "bsr")
    m.fit(g, types, x_raw=counts, epochs=2, use_bsr="auto")
    assert m.fmts == ("bsr", "dense") and isinstance(m.adj1, tbsr.BSRMatrix)
    assert isinstance(m.adj2, DenseAdj) and calls["spmm"] == 32 + 4 * 2  # the one-hop: 2 + 2
    assert np.isfinite([h["loss"] for h in m.history]).all()


def test_build_cache_is_kept_for_the_same_inputs():
    x, counts, types, g = _model_inputs(seed=14)
    m = scHeteroNet(hidden_channels=8, seed=0, device="cpu")
    m.fit(g, types, x_raw=counts, epochs=1, use_bsr=True)
    built = m._build_cache
    m.fit(g, types, x_raw=counts, epochs=1, use_bsr=True)
    assert m._build_cache is built
    m.fit(g, types, x_raw=counts * 2, epochs=1, use_bsr=True)
    assert m._build_cache is not built
    m.fit(g, types, epochs=1, use_bsr=False)  # no counts: the ZINB term is off
    assert isinstance(m.adj1, CSRMatrix) and len(m.history) == 1


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scHeteroNet()
    assert scHeteroNet(device="cpu").device == CPU
