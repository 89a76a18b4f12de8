"""Port parity for match-modality scMoGNN and the matching evaluator: the
propagation, the hop mix, the four-stack net after the weight transfer, one
AdamW step, a 3-epoch fit with the best-epoch rule, the bipartite matching,
nearest-neighbour matching and ``score`` (dance_tpu_torch.modules.
multi_modality.match_modality, utils.metrics, ops.sparse).

Inputs are made with numpy from a seed and handed to both packages; the flax
weights are copied into the port's net (``scmogcn_match_flax_to_torch``).
Dropout is off in the steps and fits (stacks given without rates), and the
fit's batch orders are JAX's, handed over through ``_epoch_order``.
Tolerances: the CSR products, the propagation and the net at rtol 1e-5 (sums
in another order); one AdamW step, its loss and every weight at 1e-5; the
3-epoch fit's weights at rtol 1e-4 and its best epoch exactly; the bipartite
matching and the matchings bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch

from dance_tpu.modules.multi_modality.match_modality import base as JB
from dance_tpu.modules.multi_modality.match_modality import scmogcn as J
from dance_tpu.ops import sparse as jsparse
from dance_tpu.utils import metrics as jmetrics
from dance_tpu_torch.modules.multi_modality.match_modality import base as TB
from dance_tpu_torch.modules.multi_modality.match_modality import scmogcn as T
from dance_tpu_torch.ops import sparse as tsparse
from dance_tpu_torch.utils import metrics as tmetrics
from dance_tpu_torch.utils.params import scmogcn_match_flax_to_torch

CPU = torch.device("cpu")
LATENT = 8


def _pair(n=200, g=48, p=12, seed=0):
    """Paired modalities: counts of ``g`` genes and ``p`` proteins that follow
    them, cells in 4 types."""
    rng = np.random.default_rng(seed)
    types = rng.integers(0, 4, n)
    rate = rng.gamma(0.5, 1.0, (4, g))[types] * rng.gamma(4.0, 0.25, (n, 1))
    x1 = rng.poisson(rate).astype(np.float32)
    w = rng.random((g, p)).astype(np.float32)
    x2 = (np.log1p(x1) @ w / g * 4 + rng.normal(0, 0.05, (n, p))).astype(np.float32)
    return x1, x2, types


def _spec(d1, d2, drop=False):
    """The default stacks at LATENT (hidden 32), without dropout rates unless
    ``drop``."""
    spec = J.ScMoGCNWrapper(latent_dim=LATENT)._default_layers(d1, d2)
    return spec if drop else tuple(tuple(s[:2] for s in st) for st in spec)


def _jax_net(spec, d1, d2, seed=0):
    net = J.ScMoGCN(layers=tuple(tuple(tuple(s) for s in st) for st in spec))
    key = jax.random.key(seed)
    model = net.init({"params": key, "dropout": key}, jnp.zeros((2, d1)), jnp.zeros((2, d2)),
                     method=net.init_all)["params"]
    return net, model


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_net(spec, params, n_hops=3):
    net = T.ScMoGCN(spec, n_hops=n_hops)
    net.load_state_dict(scmogcn_match_flax_to_torch(_np_tree(params)))
    return net


def _close(got, want, rtol=1e-5, atol=1e-5, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=name)


def test_csr_products_match_jax():
    a = sp.random(40, 25, density=0.2, format="csr", dtype=np.float32, random_state=1)
    rng = np.random.default_rng(1)
    b = rng.normal(size=(25, 7)).astype(np.float32)
    c = rng.normal(size=(40, 5)).astype(np.float32)
    ja, ta = jsparse.csr_from_scipy(a), tsparse.csr_from_scipy(a)
    _close(tsparse.csr_matmat(ta, torch.from_numpy(b)), jsparse.csr_matmat(ja, jnp.asarray(b)))
    _close(tsparse.csr_rmatmat(ta, torch.from_numpy(c)), jsparse.csr_rmatmat(ja, jnp.asarray(c)))


@pytest.mark.parametrize("layers", [3, 4])
def test_expression_propagation_matches_jax(layers):
    x1, _, _ = _pair(n=150, g=40, seed=2)
    want = J.expression_propagation(x1, layers=layers, alpha=0.4, beta=0.6)
    got = T.expression_propagation(x1, layers=layers, alpha=0.4, beta=0.6, device="cpu")
    assert len(got) == len(want) == layers - 1
    for g, w in zip(got, want):
        assert g.shape == (150, 40)
        _close(g, w)
    assert T.cell_feature_propagation is T.expression_propagation


@pytest.mark.parametrize("from_logits", [True, False])
def test_propagation_layer_combination_matches_jax(from_logits):
    rng = np.random.default_rng(3)
    X = rng.normal(size=(3, 30, 6)).astype(np.float32)
    Y = rng.normal(size=(3, 30, 4)).astype(np.float32)
    idx = rng.permutation(30)[:12]
    wt1, wt2 = rng.normal(size=3).astype(np.float32), rng.normal(size=3).astype(np.float32)
    want = J.propagation_layer_combination(X, Y, jnp.asarray(idx), wt1, wt2, from_logits)
    got = T.propagation_layer_combination(torch.from_numpy(X), torch.from_numpy(Y),
                                          torch.from_numpy(idx), torch.from_numpy(wt1),
                                          torch.from_numpy(wt2), from_logits)
    for g, w in zip(got, want):
        _close(g, w, atol=1e-6)


def test_net_encode_decode_after_transfer():
    d1, d2 = 20, 6
    spec = _spec(d1, d2, drop=True)
    jnet, model = _jax_net(spec, d1, d2)
    tnet = _torch_net(spec, {"model": model, "wt1": np.zeros(3), "wt2": np.zeros(3)})
    assert tnet.rates == [[0.25, 0.25, 0.0], [0.2, 0.2, 0.0], [0.2, 0.0], [0.2, 0.0]]
    rng = np.random.default_rng(4)
    m1 = rng.normal(size=(9, d1)).astype(np.float32)
    m2 = rng.normal(size=(9, d2)).astype(np.float32)
    je1, je2 = jnet.apply({"params": model}, m1, m2, method=jnet.encode)
    with torch.no_grad():
        te1, te2 = tnet.encode(torch.from_numpy(m1), torch.from_numpy(m2))
        _close(te1, je1)
        _close(te2, je2)
        _close(torch.linalg.norm(te1, dim=1), np.ones(9), atol=1e-6)
        for g, w in zip(tnet.decode(te1, te2), jnet.apply({"params": model}, je1, je2,
                                                          method=jnet.decode)):
            _close(g, w)
        _close(tnet(torch.from_numpy(m1), torch.from_numpy(m2)),
               jnet.apply({"params": model}, m1, m2))
    with pytest.raises(KeyError, match="unexpected ScMoGCN"):
        scmogcn_match_flax_to_torch({"model": {"Dense_0": {}}, "wt1": [0], "wt2": [0]})


def test_dropout_masks_follow_jax_protocol():
    # one mask per dropout layer, the decoders' shared by both of their passes
    spec = _spec(10, 5, drop=True)
    net = T.ScMoGCN(spec)
    net.reset_parameters(torch.Generator().manual_seed(0))
    masks = net.draw_masks(64, torch.Generator().manual_seed(1))
    assert [[m is None for m in ms] for ms in masks] == [[False, False, True],
                                                         [False, False, True],
                                                         [False, True], [False, True]]
    keep = float(masks[0][0].float().mean())
    assert 0.6 < keep < 0.9  # rate 0.25
    e = torch.randn(64, LATENT)
    a, b = net.decode(e, e, masks), net.decode(e, e, masks)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    h = torch.nn.functional.gelu(net.stacks[2][0](e), approximate="tanh")
    want = net.stacks[2][1](torch.where(masks[2][0], h / 0.8, 0.0))
    torch.testing.assert_close(a[0], want, rtol=0, atol=0)


@pytest.mark.parametrize("aux", [0, 1])
def test_train_step_matches_optax(aux):
    x1, x2, _ = _pair(n=120, g=30, p=8, seed=5)
    H1 = np.stack(J.expression_propagation(x1, layers=4))
    H2 = np.stack(J.expression_propagation(x2, layers=4))
    spec = _spec(30, 8)
    jnet, model = _jax_net(spec, 30, 8)
    rng = np.random.default_rng(6)
    params = {"model": model, "wt1": jnp.asarray(rng.normal(size=3), jnp.float32),
              "wt2": jnp.asarray(rng.normal(size=3), jnp.float32)}
    tnet = _torch_net(spec, params)
    idx = rng.permutation(120)[:48]
    lr = 6e-4
    opt_state = optax.adamw(lr).init(params)
    jparams, _, jloss = J._match_train_step(params, opt_state, jnp.asarray(H1), jnp.asarray(H2),
                                            jnp.asarray(idx), jax.random.key(0), net=jnet,
                                            lr=lr, aux=aux)
    opt = T.adamw(tnet, lr)
    assert opt.defaults["weight_decay"] == 1e-4
    tloss = T.match_train_step(tnet, opt, torch.from_numpy(H1), torch.from_numpy(H2),
                               torch.from_numpy(idx), aux)
    _close(tloss, jloss)
    want = scmogcn_match_flax_to_torch(_np_tree(jparams))
    for name, value in tnet.state_dict().items():
        _close(value, want[name], name=name)


def _jax_orders(seed, train_idx, n):
    key = jax.random.key(seed)

    def order(epoch):
        perm = jax.random.permutation(jax.random.fold_in(key, epoch), jnp.asarray(train_idx))
        return np.array(perm[:n])  # writable, as torch wants
    return order


def _fitted_pair(monkeypatch, epochs=3, early_stopping=20):
    x1, x2, types = _pair(n=200, g=48, p=12, seed=7)
    tr, te = slice(0, 160), slice(160, 200)
    spec = _spec(48, 12)
    kw = dict(layers=spec, latent_dim=LATENT, seed=0)
    jw = J.ScMoGCNWrapper(**kw).fit(x1[tr], x2[tr], x1[te], x2[te], epochs=epochs,
                                    batch_size=32, early_stopping=early_stopping)
    _, model = _jax_net(spec, 48, 12)
    init = scmogcn_match_flax_to_torch(_np_tree({"model": model, "wt1": np.zeros(3),
                                                 "wt2": np.zeros(3)}))
    tw = T.ScMoGCNWrapper(device="cpu", **kw)
    make = tw._make_net

    def made(*args):
        net = make(*args)
        net.load_state_dict(init)
        return net

    def orders(epoch, train_idx, n, generator):
        return _jax_orders(0, train_idx, n)(epoch)
    monkeypatch.setattr(tw, "_make_net", made)
    monkeypatch.setattr(tw, "_epoch_order", orders)
    tw.fit(x1[tr], x2[tr], x1[te], x2[te], epochs=epochs, batch_size=32,
           early_stopping=early_stopping)
    return jw, tw, types


def test_fit_matches_jax(monkeypatch):
    jw, tw, types = _fitted_pair(monkeypatch)
    assert len(tw.history) == 3 and tw.split["valid"].shape == (32,)
    np.testing.assert_array_equal(tw.split["valid"],
                                  np.random.default_rng(0).permutation(160)[-32:])
    # JAX's best epoch: the last strict improvement of the validation accuracy
    vals = [h["val"] for h in tw.history]
    assert tw.best_epoch == int(np.argmax(vals)) and tw.best_val == max(vals)
    want = scmogcn_match_flax_to_torch(_np_tree(jw.params))
    for name, value in tw.net.state_dict().items():
        _close(value, want[name], rtol=1e-4, atol=1e-6, name=name)
    _close(tw.feat_mod1, jw.feat_mod1)
    idx = np.arange(160, 200)
    _close(tw.predict(idx), jw.predict(idx), rtol=1e-4, atol=1e-4)
    lab = np.arange(40)
    assert tw.score(idx, lab, lab) == jw.score(idx, lab, lab)


def test_enhanced_score_and_matching_match_jax(monkeypatch):
    jw, tw, types = _fitted_pair(monkeypatch, epochs=2)
    idx = np.arange(160, 200)
    batch = np.arange(200) % 2
    got = tw.predict(idx, enhance=True, batch1=batch, batch2=batch)
    np.testing.assert_array_equal(got, jw.predict(idx, enhance=True, batch1=batch,
                                                  batch2=batch))
    truth = np.eye(40)
    assert tw.score(idx, labels_matrix=truth, enhance=True, batch1=batch, batch2=batch) == \
        jw.score(idx, labels_matrix=truth, enhance=True, batch1=batch, batch2=batch)
    np.testing.assert_array_equal(tw.predict_matching(), jw.predict_matching())
    assert tw.score_matching(got) == jw.score_matching(got)


def test_early_stopping_rule(monkeypatch):
    # every epoch scores the same: the best stays epoch 0 and the fit stops
    # early_stopping epochs later, as JAX's while_loop does
    monkeypatch.setattr(T, "match_val_score", lambda *a: torch.tensor(0.5))
    x1, x2, _ = _pair(n=80, g=20, p=6, seed=8)
    tw = T.ScMoGCNWrapper(layers=_spec(20, 6), latent_dim=LATENT, device="cpu")
    tw.fit(x1, x2, epochs=50, batch_size=16, early_stopping=3)
    assert len(tw.history) == 4 and tw.best_epoch == 0


def test_bipartite_matching_bit_equal():
    rng = np.random.default_rng(9)
    e1, e2 = rng.normal(size=(60, 5)), rng.normal(size=(60, 5))
    b1 = rng.integers(0, 3, 60)
    for q in (0.5, 0.95, 0.995):
        got = tmetrics.batch_separated_bipartite_matching(b1, b1, e1, e2, q)
        np.testing.assert_array_equal(got, jmetrics.batch_separated_bipartite_matching(
            b1, b1, e1, e2, q))
        assert got.dtype == np.float64 and (got.sum(1) == 1).all()
    logits = rng.normal(size=(20, 20))
    np.testing.assert_array_equal(tmetrics.get_bipartite_matching_adjacency_matrix_mk3(
        logits, 0.9, copy=True), jmetrics.get_bipartite_matching_adjacency_matrix_mk3(
        logits, 0.9, copy=True))
    np.testing.assert_array_equal(tmetrics._softmax(logits, 0), jmetrics._softmax(logits, 0))


@pytest.mark.parametrize("metric", ["l1", "l2"])
def test_nearest_neighbor_matching_matches_jax(metric):
    rng = np.random.default_rng(10)
    e1, e2 = rng.normal(size=(70, 6)), rng.normal(size=(50, 6))
    got = TB.nearest_neighbor_matching(e1, e2, metric, chunk=16, device="cpu")
    np.testing.assert_array_equal(got, JB.nearest_neighbor_matching(e1, e2, metric, chunk=16))
    assert got.shape == (50, 70) and got.dtype == np.float32
    assert TB.MatchingScoreMixin().score_matching(np.eye(4)) == 1.0
