"""Port parity for DeepImpute (dance_tpu_torch.modules.single_modality.
imputation.deepimpute) and the imputation front it brings: the target-gene
blocks (dance_tpu_torch.transforms.gene_holdout), the preprocessing, the
stacked ensemble's forward, gradients and Adam step, both early-stopping
protocols and ``predict``.

Inputs are made with numpy from a seed and handed to both packages; the
vmapped flax weights are copied into the stacked torch ensemble
(deepimpute_flax_to_torch, through a patched ``DeepImpute._make_net``) and
JAX's batch orders are handed to the port (through a patched
``epoch_batches`` / ``epoch_batches_masked``). Dropout is off, except in the
one step that hands JAX's dropout masks over (captured from flax's
``Dropout_0``). JAX's side runs its epoch functions (``_train_epoch``, and
the protocols' epoch scans at 3 epochs). Tolerances: the front exactly;
forwards and the loss at rtol 1e-5, gradients at 1e-5 of the largest, one
Adam step at 1e-5; fits' losses and validation losses at 1e-4, weights
within two learning rates a step and all but 0.1 % at rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from dance_tpu.data import AnnData, Data
from dance_tpu.modules.single_modality.imputation.deepimpute import DeepImpute as JDeepImpute
from dance_tpu.modules.single_modality.imputation.deepimpute import _SubNet as JSubNet
from dance_tpu.transforms import GeneHoldout as JGeneHoldout
from dance_tpu.utils.batch import epoch_batches as jepoch_batches
from dance_tpu.utils.batch import epoch_batches_masked as jepoch_batches_masked
from dance_tpu_torch.modules.single_modality.imputation import (DeepImpute, NeuralNetworkModel,
                                                                deepimpute_preprocess)
from dance_tpu_torch.modules.single_modality.imputation import deepimpute as tdi
from dance_tpu_torch.transforms import GeneHoldout
from dance_tpu_torch.utils.params import deepimpute_flax_to_torch
from torch_cases import assert_weights, typed_counts


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _state(tree) -> dict:
    return {k: v.numpy() for k, v in deepimpute_flax_to_torch(_np_tree(tree)).items()}


def _inputs(seed=0, n=120, g=40, block=16):
    counts, _, names = typed_counts(n, g, seed=seed)
    return deepimpute_preprocess(counts, names, seed=seed, sub_outputdim=block, n_top=3)


def _jax_model(inp, dropout=0.0, reference_protocol=False, lr=1e-3, seed=1):
    """A JAX DeepImpute set up as its ``fit`` sets itself up: the padded
    layout, the net, the vmapped init from ``key(seed)`` and Adam."""
    jm = JDeepImpute(inp.predictors, inp.targets, sub_outputdim=16, hidden_dim=8,
                     dropout=dropout, seed=seed, reference_protocol=reference_protocol)
    pred_idx, targ_idx, targ_mask, p_max, t_max = jm._pad_layout()
    jm._idx = (pred_idx, targ_idx, targ_mask)
    jm.net = JSubNet(out_dim=t_max, hidden_dim=8, dropout=dropout,
                     torch_init=reference_protocol)
    keys = jax.random.split(jax.random.key(seed), pred_idx.shape[0])
    init = jax.vmap(lambda r: jm.net.init({"params": r, "dropout": r},
                                          jnp.zeros((1, p_max)))["params"])(keys)
    jm._tx = optax.adam(lr)
    return jm, init


def _torch_model(inp, init, monkeypatch, dropout=0.0, reference_protocol=False, seed=1):
    make = DeepImpute._make_net

    def make_from_jax(self, *args):
        net = make(self, *args)
        net.load_state_dict(deepimpute_flax_to_torch(_np_tree(init)))
        return net

    monkeypatch.setattr(DeepImpute, "_make_net", make_from_jax)
    return DeepImpute(inp.predictors, inp.targets, sub_outputdim=16, hidden_dim=8,
                      dropout=dropout, seed=seed, reference_protocol=reference_protocol,
                      device="cpu")


def _views(jm, inp, sel=None):
    sel = np.arange(inp.x.shape[0]) if sel is None else sel
    return jm._pregather(jnp.asarray(inp.x[sel]), jnp.asarray(inp.x[sel]),
                         jnp.asarray(inp.train_mask[sel].astype(np.float32)))


# -- the front -----------------------------------------------------------------

def test_gene_holdout_matches_jax():
    x = np.log1p(typed_counts(100, 50, seed=2)[0])
    data = Data(AnnData(X=x.copy()))
    JGeneHoldout(n_top=4, batch_size=12, random_state=3)(data)
    targets, predictors = GeneHoldout(n_top=4, batch_size=12, random_state=3)(x)
    for got, want in ((targets, data.data.uns["targets"]),
                      (predictors, data.data.uns["predictors"])):
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("sparse", [False, True])
def test_deepimpute_preprocess_matches_jax_pipeline(sparse):
    counts, _, names = typed_counts(150, 60, seed=4)
    x = sp.csr_matrix(counts) if sparse else counts
    data = Data(AnnData(X=x.copy(), obs={"idx": np.arange(150)},
                        var=pd.DataFrame({"gidx": np.arange(60)}, index=names)))
    pipeline = JDeepImpute.preprocessing_pipeline(min_cells=0.1, n_top=3, sub_outputdim=16,
                                                  seed=5, log_level="WARNING")
    holdout = next(t for t in pipeline.transforms if isinstance(t, JGeneHoldout))
    holdout.random_state = 5  # the JAX pipeline leaves it unseeded
    pipeline(data)
    ad = data.data
    got = deepimpute_preprocess(x, names, seed=5, sub_outputdim=16, n_top=3)
    np.testing.assert_array_equal(got.cells, ad.obs["idx"].to_numpy())
    np.testing.assert_array_equal(got.genes, ad.var["gidx"].to_numpy())
    np.testing.assert_array_equal(got.gene_names, np.asarray(ad.var_names))
    want_x = ad.X.toarray() if sp.issparse(ad.X) else ad.X
    np.testing.assert_array_equal(got.x, want_x)
    raw = ad.raw.X.toarray() if sp.issparse(ad.raw.X) else ad.raw.X
    np.testing.assert_array_equal(got.x_raw, raw)
    for name in ("train_mask", "valid_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(got, name), ad.layers[name], err_msg=name)
    for field in ("targets", "predictors"):
        for g, w in zip(getattr(got, field), ad.uns[field]):
            np.testing.assert_array_equal(g, w)
    assert got.test_mask.any() and got.valid_mask.any()


# -- the ensemble ----------------------------------------------------------------

@pytest.mark.parametrize("reference_protocol", [False, True])
def test_subnet_forward_and_init_match_jax(reference_protocol, monkeypatch):
    inp = _inputs(6)
    jm, init = _jax_model(inp, reference_protocol=reference_protocol)
    xp = _views(jm, inp)[0]
    want = jax.vmap(lambda p, x: jm.net.apply({"params": p}, x))(init, xp)
    net = NeuralNetworkModel(len(inp.targets), xp.shape[2], want.shape[2], 8, 0.0)
    net.load_state_dict(deepimpute_flax_to_torch(_np_tree(init)))
    with torch.no_grad():
        got = net(torch.from_numpy(np.array(xp)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # the port's own init: flax's lecun-normal cut at 2 sigma with zero biases,
    # or nn.Linear's U(±1/sqrt(fan_in)) for kernels and biases
    net.reset_parameters(torch.Generator().manual_seed(0), reference_protocol)
    for w, b in ((net.w1, net.b1), (net.w2, net.b2)):
        bound = 1.0 / np.sqrt(w.shape[1])
        if reference_protocol:
            assert float(w.detach().abs().max()) <= bound >= float(b.detach().abs().max()) > 0
        else:
            assert float(w.detach().abs().max()) <= 2 * bound / 0.8796 + 1e-6
            assert float(w.detach().std()) == pytest.approx(bound, rel=0.2)
            assert not b.any()


def test_deepimpute_flax_to_torch_rejects_unknown_names():
    leaf = {"kernel": np.zeros((2, 3, 4)), "bias": np.zeros((2, 4))}
    for bad in ({"Dense_0": leaf}, {"Dense_0": leaf, "Dense_2": leaf},
                {"Dense_0": {**leaf, "scale": 0}, "Dense_1": leaf}):
        with pytest.raises(KeyError, match="unexpected"):
            deepimpute_flax_to_torch(bad)


def test_one_step_with_jax_dropout_masks_matches_jax(monkeypatch):
    """One Adam step on one batch of every cell, dropout 0.2, the masks JAX's
    step draws (flax's ``Dropout_0`` output, captured) handed to the port:
    the loss, the gradients (against ``jax.grad`` of JAX's per-subnet wMSE)
    and the weights after the step."""
    inp = _inputs(7)
    jm, init = _jax_model(inp, dropout=0.2)
    xp, yt, mt = _views(jm, inp)
    n, key = xp.shape[1], jax.random.key(8)
    rows = jepoch_batches(key, n, n)[0]
    sub_rngs = jax.random.split(jax.random.split(jax.random.fold_in(key, 7), 1)[0],
                                xp.shape[0])

    def loss_fn(params):
        def one(p, x, y, m, r):
            y_hat = jm.net.apply({"params": p}, x, training=True, rngs={"dropout": r})
            return jnp.sum(y * m * (y - y_hat) ** 2) / jnp.maximum(jnp.sum(m), 1.0)
        return jax.vmap(one)(params, xp[:, rows], yt[:, rows], mt[:, rows], sub_rngs).mean()

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(init)
    jnext, _, jepoch_loss = jm._train_epoch(init, jm._tx.init(init), xp, yt, mt, key, n)
    np.testing.assert_allclose(float(jepoch_loss), float(jloss), rtol=1e-6)
    masks = []
    for i in range(xp.shape[0]):
        p_i = jax.tree_util.tree_map(lambda a: a[i], init)
        _, st = jm.net.apply({"params": p_i}, xp[i, rows], training=True,
                             rngs={"dropout": sub_rngs[i]}, capture_intermediates=True)
        masks.append(np.asarray(st["intermediates"]["Dropout_0"]["__call__"][0]) != 0)
    keep = torch.from_numpy(np.stack(masks))
    monkeypatch.setattr(tdi, "flax_dropout", lambda h, rate, gen, rows=None, dim=0: torch.where(
        keep, h / (1 - rate), 0.0) if gen is not None else h)

    tm = _torch_model(inp, init, monkeypatch, dropout=0.2)
    tm.fit(inp.x, inp.x, mask=inp.train_mask, n_epochs=0, patience=0)
    tr = [torch.from_numpy(np.array(a)) for a in (xp, yt, mt)]
    r = torch.from_numpy(np.array(rows)).long()
    loss = tdi._wmse(tm.net(tr[0][:, r], torch.Generator()), tr[1][:, r], tr[2][:, r]).mean()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    loss.backward()
    want = _state(jgrads)
    scale = max(float(np.abs(w).max()) for w in want.values())
    for k, p in tm.net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k], rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=k)
    torch.optim.Adam(tm.net.parameters(), lr=1e-3).step()
    for k, v in _state(jnext).items():
        np.testing.assert_allclose(tm.net.state_dict()[k].numpy(), v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def _hand_orders(monkeypatch, keys, n, bs, masked):
    if masked:
        orders = iter([tuple(torch.from_numpy(np.array(a)) for a in
                             jepoch_batches_masked(k, n, bs)) for k in keys])
        monkeypatch.setattr(tdi, "epoch_batches_masked", lambda gen, n, bs: next(orders))
    else:
        orders = iter([torch.from_numpy(np.array(jepoch_batches(k, n, bs))).long()
                       for k in keys])
        monkeypatch.setattr(tdi, "epoch_batches", lambda gen, n, bs: next(orders))


@pytest.mark.parametrize("protocol", ["default", "reference", "no_validation"])
def test_deepimpute_fit_matches_jax(protocol, monkeypatch):
    """3 epochs of batches of 16 from the same weights and batch orders,
    dropout off: JAX's epoch scans of both early-stopping protocols, and its
    plain epochs where there is no validation split (patience 0, here with
    the reference protocol's init, which then trains as the default). The
    reference protocol at lr 1e-2 and patience 1, so that its accumulated
    gradients overshoot and subnets stop one by one."""
    inp = _inputs(9, n=140)
    reference = protocol != "default"
    lr, patience = (1e-2, 1) if protocol == "reference" else (1e-3, 5)
    patience = 0 if protocol == "no_validation" else patience
    jm, init = _jax_model(inp, reference_protocol=reference, lr=lr)
    n = inp.x.shape[0]
    perm = np.random.default_rng(1).permutation(n)
    if protocol == "default":
        n_val = max(int(0.05 * n), 1)
        va, tr = perm[:n_val], perm[n_val:]
    else:  # the reference's 90 % train split, kept without validation too
        tr, va = perm[:int(n * 0.9)], perm[int(n * 0.9):]
    train = _views(jm, inp, tr)
    keys = jax.random.split(jax.random.key(1), 3)
    opt = jm._tx.init(init)
    if protocol == "no_validation":
        params, losses = init, []
        for k in keys:
            params, opt, loss = jm._train_epoch(params, opt, *train, k, 16)
            losses.append(float(loss))
        vals = None
    elif protocol == "default":
        params, _, _, losses, vals, _ = jm._train_epochs_es(
            init, opt, *train, *_views(jm, inp, va), keys, jnp.int32(patience), 16)
    else:
        params, _, losses, stopped = jm._train_epochs_es_ref(
            init, opt, *train, *_views(jm, inp, va), keys, jnp.int32(patience), 16)
        vals = None
    _hand_orders(monkeypatch, keys, len(tr), 16, masked=protocol == "reference")
    tm = _torch_model(inp, init, monkeypatch, reference_protocol=reference)
    tm.fit(inp.x, inp.x, mask=inp.train_mask, batch_size=16, lr=lr, n_epochs=3,
           patience=patience)
    np.testing.assert_allclose([h["loss"] for h in tm.history], np.asarray(losses)[
        :len(tm.history)], rtol=1e-4)
    if vals is not None:
        np.testing.assert_allclose([h["val"] for h in tm.history], np.asarray(vals), rtol=1e-4)
    if protocol == "reference":
        np.testing.assert_array_equal(tm.stopped, np.asarray(stopped))
        assert 0 < tm.stopped.sum()
    got = {k: v.numpy() for k, v in tm.net.state_dict().items()}
    assert_weights(got, _state(params), lr, 3 * 9)
    jm.params = params
    pred = tm.predict(inp.x, mask=inp.train_mask, test_idx=np.arange(50), predict_raw=True)
    np.testing.assert_allclose(pred, jm.predict(inp.x, mask=inp.train_mask,
                                                test_idx=np.arange(50), predict_raw=True),
                               rtol=1e-4, atol=1e-5)
    assert tm.score(inp.x, inp.x) == pytest.approx(np.mean((inp.x - tm.predict(inp.x)) ** 2))


def test_deepimpute_stops_after_patience_and_keeps_the_best(monkeypatch):
    """A validation sequence scripted through ``_val``: the default protocol
    stops after ``patience`` epochs in a row without a new best and keeps the
    best epoch's weights."""
    inp = _inputs(10)
    m = DeepImpute(inp.predictors, inp.targets, sub_outputdim=16, hidden_dim=8, device="cpu")
    vals, snaps = iter([3.0, 2.0, 2.5, 1.9, 2.0, 1.9, 0.5]), []
    real_val = DeepImpute._val

    def scripted(self, val, loss_fn):
        snaps.append({k: v.clone() for k, v in self.net.state_dict().items()})
        real_val(self, val, loss_fn)
        return torch.tensor([next(vals)], dtype=torch.float64)

    monkeypatch.setattr(DeepImpute, "_val", scripted)
    m.fit(inp.x, inp.x, mask=inp.train_mask, n_epochs=20, patience=2)
    # a tie is no new best: two epochs after 1.9 it stops
    assert [h["val"] for h in m.history] == [3.0, 2.0, 2.5, 1.9, 2.0, 1.9]
    for k, v in m.net.state_dict().items():
        torch.testing.assert_close(v, snaps[3][k], rtol=0, atol=0)
