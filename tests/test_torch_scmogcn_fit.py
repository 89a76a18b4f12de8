"""Port parity for scMoGNN's fits: the full-graph ``fit`` (AdamW, the split,
the lr schedule, best-validation selection) on CSR and BSR graphs, the
sampled fit with its numpy-drawn batches and features, and the joint
embedding's net and fit, each against the JAX package from the same initial
weights.

The JAX wrappers draw their initial weights from ``jax.random.key(seed)``;
the tests rebuild those parameters as the wrappers do, copy them into the
port's net (its ``_make_net`` patched to load them) and turn dropout off, so
both fits start and step alike. The JAX BSR path runs its Pallas kernel in
interpret mode on the CPU (a two-tile tiling).

Tolerances: predictions after 3 epochs at atol 1e-4 + rtol 1e-3, and the
sampled fit's after 2 epochs (8 steps) at 2e-4 + 1e-3: AdamW's first steps
move each weight by about the learning rate (1e-2) whatever its gradient's
size, so the forward's float32 gap (1e-5 of the output, see
tests/test_torch_scmogcn.py) grows step by step; the JE embedding the same.
Splits, draws and learning rates exactly.
"""

import jax
import numpy as np
import pytest
import torch

from dance_tpu.modules.multi_modality.joint_embedding import scmogcn as JJE
from dance_tpu.modules.multi_modality.predict_modality import scmogcn as J
from dance_tpu_torch.modules.multi_modality.joint_embedding import scmogcn as TJE
from dance_tpu_torch.modules.multi_modality.predict_modality import scmogcn as T
from dance_tpu_torch.ops import bsr as tbsr
from dance_tpu_torch.utils.params import scmogcn_flax_to_torch, scmogcn_je_flax_to_torch

CFG = dict(seed=0, hidden_size=16, conv_layers=2, edge_dropout=0.0, model_dropout=0.0)


def _data(seed=0, n=200, g=100, p=5):
    rng = np.random.default_rng(seed)
    x = rng.poisson(3.0, (n, g)) * (rng.random((n, g)) < 0.1)
    x[np.arange(n), rng.integers(0, g, n)] += 1
    x = x.astype(np.float32)
    w = rng.random((g, p)).astype(np.float32)
    return x, (np.log1p(x) @ w / g * 4).astype(np.float32)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _load_into(wrapper, state, monkeypatch):
    """Patch ``wrapper._make_net`` to load ``state`` into the net it makes."""
    make = wrapper._make_net

    def made(*args):
        net = make(*args)
        net.load_state_dict(state)
        return net
    monkeypatch.setattr(wrapper, "_make_net", made)


def _capture_splits(monkeypatch):
    """Record the ``split`` each package's ``fit`` hands to ``fit_graph``."""
    seen = {}
    for name, cls in (("jax", J.ScMoGCNWrapper), ("port", T.ScMoGCNWrapper)):
        inner = cls.fit_graph

        def fit_graph(self, g, y, split=None, *a, _name=name, _inner=inner, **kw):
            seen[_name] = split
            return _inner(self, g, y, split, *a, **kw)
        monkeypatch.setattr(cls, "fit_graph", fit_graph)
    return seen


@pytest.mark.parametrize("use_bsr", [False, True])
def test_fit_matches_jax(use_bsr, monkeypatch):
    x, y = _data()
    x_test = x[150:]
    jw = J.ScMoGCNWrapper(**CFG)
    jw.fit(x[:150], y[:150], x_test, epochs=0, use_bsr=use_bsr)  # the initial weights
    init = scmogcn_flax_to_torch(_np_tree(jw.params))
    seen = _capture_splits(monkeypatch)
    jw.fit(x[:150], y[:150], x_test, epochs=3, use_bsr=use_bsr)
    tw = T.ScMoGCNWrapper(device="cpu", **CFG)
    _load_into(tw, init, monkeypatch)
    tw.fit(x[:150], y[:150], x_test, epochs=3, use_bsr=use_bsr)
    for part in ("train", "valid"):
        np.testing.assert_array_equal(seen["port"][part], seen["jax"][part])
    assert len(seen["port"]["valid"]) == int(150 * 0.15)
    assert tw._lr == jw._lr == 1e-2 and len(tw.history) == 3
    assert all("val" in h and np.isfinite(h["loss"]) for h in tw.history)
    assert tw._graph.fmt == ("bsr" if use_bsr else "csr")
    np.testing.assert_allclose(tw.predict(), np.asarray(jw.predict()), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tw.predict(x_test), np.asarray(jw.predict(x_test)), rtol=1e-3,
                               atol=1e-4)
    assert tw.predict(x_test).shape == (50, y.shape[1])
    assert tw.score(x_test, y[150:]) == pytest.approx(jw.score(x_test, y[150:]), rel=1e-3)


def test_sampled_fit_matches_jax(monkeypatch):
    """Two epochs of cell batches of 64 with half the features drawn by
    degree: the same draws and steps as JAX, no BSR kernel."""
    x, y = _data(1)
    cfg = dict(CFG, batch_size=64, node_sampling_rate=0.5)
    jw = J.ScMoGCNWrapper(**cfg)
    jw.fit(x, y, epochs=0, sampling=True)
    init = scmogcn_flax_to_torch(_np_tree(jw.params))
    jw.fit(x, y, epochs=2, sampling=True)
    tw = T.ScMoGCNWrapper(device="cpu", **cfg)
    _load_into(tw, init, monkeypatch)
    spmm, calls = tbsr.bsr_spmm, []
    monkeypatch.setattr(tbsr, "bsr_spmm", lambda *a: calls.append(1) or spmm(*a))
    tw.fit(x, y, epochs=2, sampling=True)
    assert not calls and tw._graph.fmt == "csr" and len(tw.history) == 2
    np.testing.assert_allclose(tw.predict(), np.asarray(jw.predict()), rtol=1e-3, atol=2e-4)


def test_sampled_batches_follow_jax_draws():
    """The steps of an epoch, replayed from the JAX loop's draws
    (predict_modality/scmogcn.py:659-668) on the same generator."""
    train_ids, bs, n_feats, n_samp = np.arange(10, 180), 32, 40, 20
    p = np.random.default_rng(3).random(n_feats)
    p /= p.sum()
    mine, theirs = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(2):
        steps = list(T.sampled_batches(mine, train_ids, bs, n_feats, n_samp, p, 0.5))
        perm = theirs.permutation(train_ids)
        assert len(steps) == len(perm) // bs
        for s, (cells, feats) in enumerate(steps):
            np.testing.assert_array_equal(cells, perm[s * bs:(s + 1) * bs])
            np.testing.assert_array_equal(feats, theirs.choice(n_feats, n_samp, replace=False,
                                                               p=p))
    (cells, feats), = T.sampled_batches(mine, train_ids[:5], 8, n_feats, n_samp, p, 1.0)
    assert len(cells) == 5 and np.array_equal(feats, np.arange(n_feats))


def test_best_validation_weights_are_a_copy(monkeypatch):
    """The kept best weights do not follow AdamW's in-place updates."""
    x, y = _data(2)
    tw = T.ScMoGCNWrapper(device="cpu", **dict(CFG, epoch=6))
    scores = iter([0.5, 0.9, 0.9, 0.9, 0.9, 0.9])  # epoch 0 is the best
    kept = {}
    score = tw._score_graph

    def scored(g, idx, y_ref):
        if not kept:
            kept.update({k: v.clone() for k, v in tw.net.state_dict().items()})
        score(g, idx, y_ref)
        return next(scores)
    monkeypatch.setattr(tw, "_score_graph", scored)
    tw.fit(x, y, epochs=6)
    for k, v in tw.net.state_dict().items():
        assert torch.equal(v, kept[k]), k


def test_graph_cache_and_device_default():
    x, y = _data(3)
    tw = T.ScMoGCNWrapper(device="cpu", **CFG)
    tw.fit(x, y, epochs=1)
    g = tw._graph
    tw.fit(x, y, epochs=1)
    assert tw._graph is g
    tw.fit(x, y, epochs=1, use_bsr=True)
    assert tw._graph is not g and tw._graph.fmt == "bsr"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='auto'"):
            T.ScMoGCNWrapper()


# --------------------------------------------------------------------------
# joint embedding
# --------------------------------------------------------------------------

JE = dict(hidden=16, n_layers=2, z_dim=4)


def _je_data(seed=4):
    x, y = _data(seed, n=160, g=60, p=6)
    types = np.random.default_rng(seed).integers(0, 3, 160)
    return x, y, np.array(["ct%d" % t for t in types])


def test_je_net_matches_jax():
    x, y, _ = _je_data()
    jg = J.build_hetero_graph(np.concatenate([x, y], 1), use_bsr=False)
    tg = T.build_hetero_graph(np.concatenate([x, y], 1), use_bsr=False, device="cpu")
    jnet = JJE._JENet(z_dim=4, n_ct=3, hidden=16, n_layers=2, feature_size=tg.n_feats)
    params = jnet.init({"params": jax.random.key(0), "dropout": jax.random.key(0)}, jg)["params"]
    tnet = TJE._JENet(4, 3, 16, 2, tg.n_feats)
    tnet.load_state_dict(scmogcn_je_flax_to_torch(_np_tree(params)))
    jz, jlogits = jnet.apply({"params": params}, jg)
    z, logits = tnet(tg)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz), rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=1e-4,
                               atol=2e-5)
    with pytest.raises(KeyError, match="unexpected _JENet"):
        scmogcn_je_flax_to_torch({"tail": {}})


@pytest.mark.parametrize("labelled", [True, False])
def test_je_fit_matches_jax(labelled, monkeypatch):
    x, y, types = _je_data()
    ct = types if labelled else None
    jw = JJE.ScMoGCNWrapper(seed=0, **JE)
    jw.fit(x, y, ct, epochs=3, use_bsr=False)
    jg = J.build_hetero_graph(np.concatenate([x, y], 1), use_bsr=False)
    jnet = JJE._JENet(z_dim=4, n_ct=3 if labelled else 1, hidden=16, n_layers=2,
                      feature_size=jg.n_feats)
    init = jnet.init({"params": jax.random.key(0), "dropout": jax.random.key(0)}, jg)["params"]
    tw = TJE.ScMoGCNWrapper(seed=0, device="cpu", **JE)
    _load_into(tw, scmogcn_je_flax_to_torch(_np_tree(init)), monkeypatch)
    tw.fit(x, y, ct, epochs=3, use_bsr=False)
    assert len(tw.history) == 3 and tw.predict().shape == (160, 4)
    np.testing.assert_allclose(tw.predict(), jw.predict(), rtol=1e-3, atol=1e-4)
    if labelled:
        scores, emb = tw.score(None, types, return_pred=True)
        assert set(scores) == {"dance_nmi", "dance_ari"} and emb.shape == (160, 4)
        # the scIB suite on the same embedding as JAX's score(metric="openproblems")
        batch = np.arange(len(types)) % 2
        monkeypatch.setattr(jw, "predict", lambda x=None: tw.predict())
        got, emb = tw.score(None, types, metric="openproblems", batch=batch, return_pred=True)
        want = jw.score(None, types, metric="openproblems", batch=batch, return_pred=True)[0]
        assert set(got) == set(want) == {"asw_label", "asw_batch", "nmi", "graph_conn",
                                         "final_scores"}
        for key in want:  # silhouettes at 1e-6 of sklearn's, the rest exactly
            assert got[key] == pytest.approx(want[key], abs=1e-6), key
        assert tw.score(None, types, metric="openproblems", batch=batch) == got["final_scores"]
