"""Port parity for scMoGNN v2 and the scMoGNN graph surface: ``read_gmt``,
``create_pathway_graph`` under its four weights, ``ScMoGNNGraph``'s block
build, ``construct_enhanced_feature_graph``, ``cell_feature_propagation`` and
``propagation_layer_combination``; scMoGNN prediction with ``pathway=True``
on those edges; the v2 net after the weight transfer, one step's loss and
gradients, AdamW (decay 1e-5) against JAX's ``_v2_epoch_steps`` on JAX's
cell and feature indices with the learning rate changed between epochs,
``_v2_val_loss``, the fit's protocol (lr decay after epoch 150, strict
best-validation selection, the early stop) on a scripted validation
sequence, the Gumbel feature draw, and the wrapper's fit, ``predict`` and
``score`` (dance_tpu_torch.transforms.graph.scmogcn_graph, modules.
multi_modality.joint_embedding.{scmogcn,scmogcnv2}).

Inputs are made with numpy from a seed (120-200 cells, 40-100 genes <-> 10-25
proteins); the gene sets are inline text. The v2 nets run without dropout
(model and edge dropout 0), at hidden 16 (group norm over 4 features a
group; see tests/test_torch_scmogcn.py) and, for the step-level parity, 2
layers with the latent's spaces cut to fit. Tolerances: graphs and edges
exactly (weights at 1e-12, the same float64 numpy); the propagation, the
forward, the losses and the validation loss at rtol 1e-5 (atol 1e-6 on
values, 1e-5 on the standardised embeddings); gradients within 1e-4 of each
tensor's largest value; weights after one AdamW step on JAX's gradients at
rtol 1e-5; two epochs' steps within 1e-4 on the summed losses, the weights
by the ``torch_cases.assert_weights`` rule; the pathway fit's predictions as
tests/test_torch_scmogcn_fit.py holds them (rtol 1e-3, atol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from dance_tpu.data import AnnData, Data, MuData
from dance_tpu.modules.multi_modality.joint_embedding import scmogcn as JJE
from dance_tpu.modules.multi_modality.joint_embedding import scmogcnv2 as J2
from dance_tpu.modules.multi_modality.predict_modality import scmogcn as JP
from dance_tpu.transforms.graph import ScMoGNNGraph
from dance_tpu.transforms.graph import scmogcn_graph as JG
from dance_tpu_torch.modules.multi_modality.joint_embedding import scmogcn as TJE
from dance_tpu_torch.modules.multi_modality.joint_embedding import scmogcnv2 as T2
from dance_tpu_torch.modules.multi_modality.predict_modality import scmogcn as TP
from dance_tpu_torch.transforms.graph import scmogcn_graph as TG
from dance_tpu_torch.utils.optim import adamw, set_learning_rate
from dance_tpu_torch.utils.params import scmogcn_flax_to_torch, scmogcn_v2_flax_to_torch
from test_torch_vae_babel import _close, _grads_close, _np, _numpy_state, step_with
from torch_cases import assert_weights, multimodal_pair

ENTREZ = ("SET_A http://a.org 11 12 13 14 15\nSET_B http://b.org 21 22 23 24\n"
          "SET_C http://c.org 31\nSET_D http://d.org 41 42 43 44 45 46\n")
SYMBOLS = ("SET_A http://a.org g1 g5 g7 g30 gX\nSET_B http://b.org g2 g8 g31 g7\n"
           "SET_C http://c.org g4\nSET_D http://d.org g0 g3 g9 g10 g11 g12\n")
HIDDEN = 16
# two layers and a 32-wide latent, with its three spaces cut to fit
SMALL = dict(conv_layers=2, ct_dim=10, shared_start=20)


def _counts(n=120, g=40, p=10, seed=0):
    x1, x2, types = multimodal_pair(n, g, p, seed)
    return x1, x2, types, np.array([f"g{k}" for k in range(g)])


@pytest.mark.parametrize("weight", ["one", "cos", "pearson", "spearman"])
def test_pathway_graph_matches_jax(weight, tmp_path):
    x1, _, _, names = _counts()
    (tmp_path / "sets.entrez.gmt").write_text(ENTREZ)
    (tmp_path / "sets.symbols.gmt").write_text(SYMBOLS)
    want = JG.create_pathway_graph(x1, names, weight, 0.05, "t", str(tmp_path / "sets"))
    sets = TG.read_gmt(ENTREZ, SYMBOLS)
    assert sets == JG.read_gmt(ENTREZ, SYMBOLS) and sets["SET_A"][-1] == "gX"
    for gene_sets in ((ENTREZ, SYMBOLS), dict(sets)):
        uu, vv, ee = TG.create_pathway_graph(x1, names, weight, 0.05, gene_sets)
        assert uu == want[0] and vv == want[1] and len(uu) > 20
        np.testing.assert_allclose(ee, want[2], rtol=1e-12, atol=0)
    with pytest.raises(ValueError, match="pathway_weight"):
        TG.create_pathway_graph(x1, names, "rbf", 0.0, sets)


def test_scmogcn_graph_matches_jax():
    x1, x2, _, names = _counts(n=50)
    sets = dict(TG.read_gmt(ENTREZ, SYMBOLS))
    m1 = AnnData(x1, var=pd.DataFrame(index=names))
    data = Data(MuData({"mod1": m1, "mod2": AnnData(x2)}), train_size=40)
    ScMoGNNGraph(pathways=sets)(data)
    want = data.data.uns["ScMoGNNGraph"]
    got = TG.scmognn_graph(x1, names, sets)
    assert got.info == want.info == {"num_cells": 50, "num_genes": 44, "num_pathways": 4}
    assert (got.adj != want.adj).nnz == 0
    plain = TG.scmognn_graph(x1)
    assert plain.info["num_pathways"] == 0 and plain.adj.shape == (90, 90)


def _enhanced(x1, names, cell_feats):
    pw = TG.create_pathway_graph(x1, names, "cos", 0.0, (ENTREZ, SYMBOLS))
    u, v = np.nonzero(x1)
    e = x1[u, v]
    args = (u, v, e, 100, x1.shape[1], cell_feats)
    return args, pw


def test_enhanced_graph_and_propagation_match_jax():
    x1, _, _, names = _counts()
    cell_feats = np.random.default_rng(2).normal(size=(120, 6)).astype(np.float32)
    args, pw = _enhanced(x1, names, cell_feats)
    for inductive in (False, True):
        got = TG.construct_enhanced_feature_graph(*args, inductive=inductive, enhance_graph=pw)
        want = JG.construct_enhanced_feature_graph(*args, inductive=inductive, enhance_graph=pw)
        assert (got.adj != want.adj).nnz == 0
        np.testing.assert_array_equal(got.ndata["cell_id"], want.ndata["cell_id"])
        np.testing.assert_array_equal(got.info["cell_node_features"],
                                      want.info["cell_node_features"])
        assert got.info["num_cells"] == want.info["num_cells"] == 120
    g = TG.construct_enhanced_feature_graph(*args)
    for cell_init, feature_init in ((None, "id"), ("x", None)):
        kw = dict(alpha=0.4, beta=0.7, cell_init=cell_init, feature_init=feature_init, layers=4)
        want = JJE.cell_feature_propagation(g, **kw)
        got = TJE.cell_feature_propagation(g, device="cpu", **kw)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            _close(a, b, atol=1e-5)
    with pytest.raises(NotImplementedError):
        TJE.cell_feature_propagation(g, feature_init="pca", device="cpu")
    rng = np.random.default_rng(3)
    X = rng.normal(size=(3, 30, 5)).astype(np.float32)
    idx, wt = rng.permutation(30)[:11], rng.normal(size=3).astype(np.float32)
    for from_logits in (True, False):
        want = JJE.propagation_layer_combination(X, idx, wt, from_logits)
        _close(TJE.propagation_layer_combination(torch.from_numpy(X), torch.from_numpy(idx),
                                                 torch.from_numpy(wt), from_logits), want)
        _close(T2.propagation_layer_combination(X, idx, wt, from_logits),
               J2.propagation_layer_combination(X, idx, wt, from_logits))


def test_pathway_scmogcn_fit_matches_jax(monkeypatch):
    """scMoGNN prediction with the pathway relation on create_pathway_graph's
    edges: 3 full-graph epochs from JAX's initial weights, dropout off,
    against the JAX wrapper's own step (``_make_step``, scmogcn.py:503)."""
    x1, x2, _, names = _counts(n=150, g=40, p=5, seed=4)
    pw = TG.create_pathway_graph(x1, names, "pearson", 0.1, (ENTREZ, SYMBOLS))
    cfg = dict(seed=0, hidden_size=HIDDEN, conv_layers=2, edge_dropout=0.0, model_dropout=0.0,
               pathway=True, pathway_aggregation="one_gate")
    # JAX's weights and steps, as its fit_graph makes and runs them (scmogcn.py:537-555)
    jw = JP.ScMoGCNWrapper(**cfg)
    jw.net = jw._build_net(x2.shape[1], x1.shape[1], 0)
    jg = JP.build_hetero_graph(x1, pathway_edges=pw, use_bsr=False)
    key = jax.random.key(0)
    params = jax.jit(jw.net.init)({"params": key, "dropout": key}, jg)["params"]
    init = scmogcn_flax_to_torch(_np(params))
    assert any(k.startswith("conv_pw") for k in init)
    jw._tx = optax.inject_hyperparams(optax.adamw)(learning_rate=1e-2, weight_decay=1e-5)
    opt, step = jw._tx.init(params), jw._make_step()
    y = np.concatenate([x2[:120], np.zeros((30, x2.shape[1]), np.float32)])
    train = np.random.default_rng(0).permutation(120)  # fit's split at val_fraction 0
    for epoch in range(3):
        params, opt, _ = step(params, opt, jg, jnp.asarray(y), jnp.asarray(train),
                              jax.random.fold_in(key, epoch))
    tw = TP.ScMoGCNWrapper(device="cpu", **cfg)
    make = tw._make_net

    def made(*args):
        net = make(*args)
        net.load_state_dict(init)
        return net
    monkeypatch.setattr(tw, "_make_net", made)
    tw.fit(x1[:120], x2[:120], x1[120:], epochs=3, use_bsr=False, pathway_edges=pw,
           val_fraction=0.0)
    assert tw._graph.pw is not None and len(tw.history) == 3
    np.testing.assert_array_equal(tw.split["train"], train)
    np.testing.assert_allclose(tw.predict(), np.asarray(jax.jit(jw.net.apply)(
        {"params": params}, jg)), rtol=1e-3, atol=1e-4)


def _v2_case(n=120, seed=0):
    """Counts of both modalities, the labels, the graph in both packages and
    JAX's dropout-free net with its initial weights, loaded into the port's."""
    x1, x2, types, _ = _counts(n=n, seed=seed)
    x = np.concatenate([x1, x2], 1)
    f1, f2 = x1.shape[1], x2.shape[1]
    phase = np.random.default_rng(seed + 1).normal(size=(n, 2)).astype(np.float32)
    batch = np.arange(n) % 2
    jg = JP.build_hetero_graph(x, use_bsr="no_bsr")
    tg = TP.build_hetero_graph(x, use_bsr="no_bsr", device="cpu")
    net = J2._ScMoGCNv2Net(feature_size=x.shape[1], out_size=f1 + f2, n_ct=3, phase_dim=2,
                           hidden_size=HIDDEN, **SMALL, model_dropout=0.0, edge_dropout=0.0)
    bf = jax.nn.one_hot(jnp.asarray(batch), 2)
    key = jax.random.key(seed)
    params = jax.jit(net.init)({"params": key, "dropout": key}, jg, bf)["params"]
    tnet = T2._ScMoGCNv2Net(x.shape[1], f1 + f2, 3, 2, 2, hidden_size=HIDDEN, **SMALL,
                            model_dropout=0.0, edge_dropout=0.0)
    tnet.load_state_dict(scmogcn_v2_flax_to_torch(_np(params)))
    return dict(x=x, f1=f1, f2=f2, types=types, phase=phase, batch=batch, jg=jg, tg=tg,
                net=net, bf=bf, params=params, tnet=tnet)


def _jax_steps(c, cells, feats, lr, opt_state=None, params=None):
    """JAX's ``_v2_epoch_steps`` at learning rate ``lr`` on the given steps."""
    params = c["params"] if params is None else params
    tx = optax.inject_hyperparams(optax.adamw)(learning_rate=lr, weight_decay=1e-5)
    opt = tx.init(params) if opt_state is None else opt_state
    opt = opt._replace(hyperparams={**opt.hyperparams, "learning_rate": jnp.float32(lr)})
    y = c["jg"].f2c.mat if hasattr(c["jg"].f2c, "mat") else jnp.asarray(c["x"])
    rngs = jax.vmap(lambda s: jax.random.fold_in(jax.random.key(0), s))(jnp.arange(len(cells)))
    return J2._v2_epoch_steps(params, opt, y, y, c["bf"], jnp.asarray(c["types"], jnp.int32),
                              jnp.asarray(c["phase"]), jnp.asarray(cells), jnp.asarray(feats),
                              rngs, net=c["net"], f1=c["f1"], f2=c["f2"], weight_decay=1e-5)


def _jax_indices(train_idx, logp, n_samp, bs, epochs, seed=0):
    """JAX's cells and features for each epoch, by ``_v2_train_run``'s own
    expressions (scmogcnv2.py:166-190) on its ``logp``."""
    key = jax.random.key(seed)
    n_steps = len(train_idx) // bs
    out = []
    for e in range(epochs):
        ekey = jax.random.fold_in(key, e)
        cells = np.array(jax.random.permutation(ekey, jnp.asarray(train_idx)))[:n_steps * bs]
        feats = []
        for s in range(n_steps):
            u = jax.random.uniform(jax.random.fold_in(ekey, s + e * 100003), logp.shape,
                                   minval=1e-20, maxval=1.0)
            feats.append(np.array(jax.lax.top_k(logp - jnp.log(-jnp.log(u)), n_samp)[1]))
        out.append((cells.reshape(n_steps, bs), np.stack(feats)))
    return out


@jax.jit
def _adamw_step(params, grads):
    """One step of optax's ``adamw(1e-2, weight_decay=1e-5)`` from a fresh state."""
    tx = optax.adamw(1e-2, weight_decay=1e-5)
    return optax.apply_updates(params, tx.update(grads, tx.init(params), params)[0])


def _port_step(c, tnet, opt, cells, feats):
    y = c["tg"].f2c.mat if hasattr(c["tg"].f2c, "mat") else torch.from_numpy(c["x"])
    cell_idx, feat_idx = torch.from_numpy(np.asarray(cells)), torch.from_numpy(np.asarray(feats))
    sub = TP._subgraph(c["tg"], y, None, cell_idx, feat_idx)
    bf = torch.nn.functional.one_hot(torch.from_numpy(c["batch"]), 2).float()
    opt.zero_grad(set_to_none=True)
    loss = T2.v2_loss(tnet, sub, bf[cell_idx], y[cell_idx],
                      torch.from_numpy(c["types"])[cell_idx],
                      torch.from_numpy(c["phase"])[cell_idx], c["f1"], c["f2"])
    loss.backward()
    return loss


def test_v2_net_step_and_val_loss_match_jax():
    c = _v2_case()
    net, params, tnet = c["net"], c["params"], c["tnet"]
    assert set(scmogcn_v2_flax_to_torch(_np(params))) == set(tnet.state_dict())
    assert not any("readout" in k for k in tnet.state_dict())
    bf_t = torch.nn.functional.one_hot(torch.from_numpy(c["batch"]), 2).float()
    with torch.no_grad():
        got = tnet(c["tg"], bf_t)
    for a, b in zip(got, jax.jit(net.apply)({"params": params}, c["jg"], c["bf"])):
        _close(a, b, atol=1e-5)
    deg = np.asarray(c["jg"].deg_f)
    logp = jnp.log(jnp.maximum(jnp.asarray(deg / max(deg.sum(), 1e-12), jnp.float32), 1e-20))
    train_idx = np.random.default_rng(0).permutation(120)[:108]
    (cells, feats), (cells2, feats2) = _jax_indices(train_idx, logp, 30, 48, 2)
    assert cells.shape == (2, 48) and feats.shape == (2, 30)

    # one step: the loss and gradients by the JAX code's own expressions
    y = c["jg"].f2c.mat if hasattr(c["jg"].f2c, "mat") else jnp.asarray(c["x"])
    ci, fi = jnp.asarray(cells[0]), jnp.asarray(feats[0])

    def loss_fn(p):
        w = y[ci][:, fi]
        sub = JP.HeteroExpnGraph(f2c=w, c2f=w.T, pw=None,
                                 deg_c=(w != 0).sum(1).astype(jnp.float32),
                                 deg_f=(w != 0).sum(0).astype(jnp.float32), deg_pw=None,
                                 feature_ids=fi.astype(jnp.int32),
                                 cell_ids=jnp.ones(w.shape[0], jnp.int32), cell_feats=None,
                                 batch_feats=None)
        _, out, ct_logits, cc = net.apply({"params": p}, sub, c["bf"][ci])
        yy = y[ci]
        return (0.5 * ((out[:, :c["f1"]] - yy[:, :c["f1"]]) ** 2).mean()
                + 0.5 * ((out[:, -c["f2"]:] - yy[:, -c["f2"]:]) ** 2).mean()
                + optax.softmax_cross_entropy_with_integer_labels(
                    ct_logits, jnp.asarray(c["types"])[ci]).mean()
                + ((cc - jnp.asarray(c["phase"])[ci]) ** 2).mean())

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    opt = adamw(tnet, 1e-2, 1e-5)
    loss = _port_step(c, tnet, opt, cells[0], feats[0])
    _close(loss.detach(), jloss)
    _grads_close(tnet, jgrads, scmogcn_v2_flax_to_torch)
    step_with(opt, tnet, jgrads, scmogcn_v2_flax_to_torch)
    want = scmogcn_v2_flax_to_torch(_np(_adamw_step(params, jgrads)))
    for name, p in tnet.named_parameters():
        _close(p.detach(), want[name], name=name)

    # two epochs of two steps each, the second at half the learning rate
    tnet.load_state_dict(scmogcn_v2_flax_to_torch(_np(params)))
    opt = adamw(tnet, 1e-2, 1e-5)
    jp, jopt, losses = params, None, []
    for (cs, fs), lr in (((cells, feats), 1e-2), ((cells2, feats2), 5e-3)):
        set_learning_rate(opt, lr)
        total = 0.0
        for s in range(2):
            total += float(_port_step(c, tnet, opt, cs[s], fs[s]).detach())
            opt.step()
        jp, jopt, jtotal = _jax_steps(c, cs, fs, lr, jopt, jp)
        losses.append((total, float(jtotal)))
    _close([a for a, _ in losses], [b for _, b in losses], rtol=1e-4)
    assert_weights({k: v.numpy() for k, v in tnet.state_dict().items()},
                   _numpy_state(scmogcn_v2_flax_to_torch(_np(jp))), 1e-2, 4)
    # the full graph's validation loss at the validation cells
    val_idx = np.random.default_rng(0).permutation(120)[108:]
    y_t = c["tg"].f2c.mat if hasattr(c["tg"].f2c, "mat") else torch.from_numpy(c["x"])
    got = T2.v2_val_loss(tnet, c["tg"], y_t, bf_t, torch.from_numpy(val_idx), c["f1"], c["f2"])
    want = J2._v2_val_loss(jp, c["jg"], y, c["bf"], jnp.asarray(val_idx), net=net, f1=c["f1"],
                           f2=c["f2"])
    _close(got, want, rtol=1e-4)


def test_gumbel_top_k_draws_without_replacement():
    logp = torch.log(torch.tensor([0.5, 0.3, 0.2, 0.0, 0.0]).clamp(min=1e-20))
    gen = torch.Generator().manual_seed(0)
    first = torch.stack([T2.gumbel_top_k(logp, 1, gen) for _ in range(4000)]).ravel()
    freq = torch.bincount(first, minlength=5).float() / 4000
    _close(freq, [0.5, 0.3, 0.2, 0.0, 0.0], atol=0.03)
    # more draws than features of nonzero degree: numpy's choice raises, the
    # Gumbel draw takes every weighted feature and then zero-degree ones
    with pytest.raises(ValueError):
        np.random.default_rng(0).choice(5, 4, replace=False, p=[0.5, 0.3, 0.2, 0.0, 0.0])
    got = T2.gumbel_top_k(logp, 4, gen)
    assert len(set(got.tolist())) == 4 and {0, 1, 2} <= set(got.tolist())


def _scripted_fit(monkeypatch, vals, es, epochs, lr_decay=0.5):
    """A v2 fit whose validation losses are ``vals``, the weights of each
    epoch recorded."""
    x1, x2, types, _ = _counts(n=40, g=12, p=4)
    tw = T2.ScMoGCNWrapperV2(hidden_size=HIDDEN, early_stopping=es, lr_decay=lr_decay,
                             device="cpu")
    seen = []

    def scripted(net, *args):
        seen.append({k: v.clone() for k, v in net.state_dict().items()})
        return torch.tensor(vals[len(seen) - 1])
    monkeypatch.setattr(T2, "v2_val_loss", scripted)
    tw.fit(x1, x2, cell_type=types, epochs=epochs, batch_size=16)
    return tw, seen


def test_v2_protocol_lr_decay_selection_and_stop(monkeypatch):
    # decreasing to epoch 160 with a tie at 100 (not a new best), then flat
    vals = [10.0 - 0.05 * e for e in range(161)] + [2.0] * 40
    vals[100] = vals[99]
    tw, seen = _scripted_fit(monkeypatch, vals, es=10, epochs=200)
    best = 160
    # JAX's rule: stop after epoch e once e > es and e - best >= es
    assert tw.best_epoch == best and len(tw.history) == best + 10 + 1
    lrs = [h["lr"] for h in tw.history]
    for e, lr in enumerate(lrs):  # the lr of epoch e: 1e-2 · decay^max(0, e - 151)
        assert lr == pytest.approx(1e-2 * 0.5 ** max(0, e - 151), rel=1e-12), e
    for k, v in tw.net.state_dict().items():
        assert torch.equal(v, seen[best][k])
    tw, _ = _scripted_fit(monkeypatch, [3.0, 2.0, 2.0, 2.0, 2.0, 1.0], es=2, epochs=6)
    assert tw.best_epoch == 1 and len(tw.history) == 4  # stops after epoch 3
    assert tw.best_val == 2.0


def test_v2_wrapper_fit_predict_score():
    x1, x2, types, _ = _counts(n=60, g=20, p=6)
    kw = dict(hidden_size=HIDDEN, device="cpu", seed=3)
    a = T2.ScMoGCNWrapper(**kw).fit(x1, x2, cell_type=types, epochs=3, batch_size=16)
    codes = np.unique(types, return_inverse=True)[1]
    phase = np.zeros((60, 2), np.float32)
    b = T2.ScMoGCNWrapperV2(**kw).fit(x1, x2, train_labels=[codes, None, None, phase],
                                       epochs=3, batch_size=16)
    emb = a.predict()
    assert emb.shape == (60, 20 + (HIDDEN * 4 - 45 - 2)) and np.isfinite(emb).all()
    np.testing.assert_array_equal(emb, b.predict())
    assert [h["val"] for h in a.history] == [h["val"] for h in b.history]
    scores, out = a.score(None, types, return_pred=True)
    assert 0.0 <= scores["dance_nmi"] <= 1.0 and np.array_equal(out, emb)
    with pytest.raises(ValueError, match="latent too small"):
        T2.ScMoGCNWrapperV2(hidden_size=8, device="cpu")
