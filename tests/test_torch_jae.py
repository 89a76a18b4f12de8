"""Port parity for JAE: the net after the weight transfer (the tanh GELU,
the norm on each call's statistics, the latent's slices), one step's loss
with and without labels, batches and phase scores, its gradients and the
Adam step, on JAX's dropout masks; a fit on JAX's batch orders and masks;
``predict`` on new inputs, ``score`` (k-means NMI and the scIB suite) and
the reference-named helpers (dance_tpu_torch.modules.multi_modality.
joint_embedding.jae).

Inputs are made with numpy from a seed (``torch_cases.multimodal_pair``:
240 cells x 100 genes (log1p) <-> 25 proteins, 3 types); the flax weights
are copied into the port (``jae_flax_to_torch``); JAX's batch orders and
dropout masks, recomputed here from its keys by its own expressions
(jae.py:55-62, :95, :112-122, :158), are handed over through a patched
``epoch_batches`` and ``JAEWrapper._mask``. Tolerances: losses at rtol 1e-5
(atol 1e-6), forward values at rtol 1e-5 and atol 1e-6 of the largest value
(after three full-batch norms, which divide by standard deviations);
gradients within 1e-4 of each tensor's largest value; weights after one
Adam step on JAX's gradients at rtol 1e-5; the fit's losses and embedding
at rtol 1e-4, its weights by the ``torch_cases.assert_weights`` rule; the
scIB scores as in test_torch_scmogcn_fit (silhouettes at 1e-6, the rest
exactly).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dance_tpu.modules.multi_modality.joint_embedding import jae as J
from dance_tpu.utils.batch import epoch_batches as jax_epoch_batches
from dance_tpu_torch.modules.multi_modality.joint_embedding import JAEWrapper
from dance_tpu_torch.modules.multi_modality.joint_embedding import jae as T
from dance_tpu_torch.utils import labeled_clustering_evaluate
from dance_tpu_torch.utils.params import jae_flax_to_torch
from test_torch_dcca import random_flax_params
from test_torch_vae_babel import (_close, _grads_close, _np, _numpy_state, adam_step,
                                  step_with)
from torch_cases import assert_weights, multimodal_pair

HIDDEN = (32, 24, 16)


def _inputs():
    counts, prot, types = multimodal_pair()
    return np.log1p(counts), prot, types


def _jax_masks(rng, rows, hidden):
    """The keep masks JAX's ``encode`` draws from a step's key (jae.py:59)."""
    return [torch.from_numpy(np.array(jax.random.bernoulli(jax.random.fold_in(rng, i), 0.8,
                                                           (rows, d))))
            for i, d in enumerate(hidden)]


@pytest.mark.parametrize("case", ["labels_batches_phases", "unlabelled"])
def test_jae_forward_loss_grads_and_adam_step(case, monkeypatch):
    x1, x2, types = _inputs()
    x = np.concatenate([x1, x2], 1)
    rows = np.arange(0, 240, 3)
    bx, n = x[rows], len(rows)
    labelled = case == "labels_batches_phases"
    n_ct, n_b, n_ph = (3, 2, 2) if labelled else (0, 1, 0)
    rs = np.random.default_rng(4)
    ct = types[rows]
    phase = rs.standard_normal((n, n_ph)).astype(np.float32)
    net = J._JAE(in_dim=x.shape[1], z_dim=12, n_cell_types=n_ct, n_batches=n_b,
                 n_phases=n_ph, hidden=HIDDEN)
    params = random_flax_params(net, bx[:2], seed=2)
    rng = jax.random.key(9)

    def loss_fn(p):  # JAX's loss_fn of _train_epoch (jae.py:97-110)
        _, x_hat, ct_logits, b_logits, ph_pred = net.apply({"params": p}, bx, training=True,
                                                           rng=rng)
        loss = 0.7 * jnp.mean((x_hat - bx) ** 2)
        if labelled:
            loss = loss + 0.2 * optax.softmax_cross_entropy_with_integer_labels(
                ct_logits, ct).mean()
        if b_logits.shape[1] > 1:
            loss = loss + 0.05 * (-jax.nn.log_softmax(b_logits, -1).mean(-1)).mean()
        if ph_pred.shape[1]:
            loss = loss + 0.05 * jnp.mean((ph_pred - phase) ** 2)
        return loss

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    jout = jax.jit(lambda p: net.apply({"params": p}, bx, training=True, rng=rng))(params)
    tnet = T._JAE(x.shape[1], 12, n_ct, n_b, n_ph, HIDDEN)
    tnet.load_state_dict(jae_flax_to_torch(_np(params)))
    tw = JAEWrapper(seed=0, device="cpu")
    masks = iter(_jax_masks(rng, n, HIDDEN) * 2)
    monkeypatch.setattr(tw, "_mask", lambda shape, gen: next(masks))
    drop = lambda h: T.inverted_dropout(h, tw._mask(h.shape, None), T.DROPOUT)  # noqa: E731
    tb = torch.from_numpy(bx)
    for got, want in zip(tnet(tb, drop), jout):  # three full-batch norms in front
        _close(got.detach(), want, atol=1e-6 * float(np.abs(want).max(initial=0)))
    # evaluation: no dropout, the norm's statistics over the whole input
    want = jax.jit(lambda p: net.apply({"params": p}, x, method=net.encode))(params)
    _close(tnet.encode(torch.from_numpy(x)).detach(), want, atol=1e-6 * float(np.abs(want).max()))
    loss = T.jae_loss(tnet, tb, torch.from_numpy(ct), torch.from_numpy(phase), labelled, drop)
    loss.backward()
    _close(loss.detach(), jloss)
    _grads_close(tnet, jgrads, jae_flax_to_torch)
    opt = torch.optim.Adam(tnet.parameters(), lr=1e-4)
    step_with(opt, tnet, jgrads, jae_flax_to_torch)
    want = jae_flax_to_torch(_np(adam_step(params, jgrads, 1e-4)))
    for name, p in tnet.named_parameters():
        _close(p.detach(), want[name], name=name)


def _jax_draws(epochs, n, bs, hidden, seed=0):
    """JAX's batch orders and each step's masks (jae.py:95, :112-122, :158)."""
    orders, masks = [], []
    for key in jax.random.split(jax.random.key(seed), epochs):
        idx = np.array(jax_epoch_batches(key, n, bs))
        orders.append(torch.from_numpy(idx))
        skey = jax.random.fold_in(key, 1)
        for _ in idx:
            skey, rng = jax.random.split(skey)
            masks += _jax_masks(rng, bs, hidden)
    return orders, masks


def test_jae_fit_matches_jax(monkeypatch):
    """Two epochs at the defaults (hidden 150, 120, 100, z 61, batch 64: 4
    wrap-padded steps an epoch, Adam 1e-4) with cell types, the epochs'
    losses, the weights and the embedding."""
    x1, x2, types = _inputs()
    labels = np.array(["t%d" % t for t in types])
    epochs = 2
    jw = J.JAEWrapper(seed=0)
    inits, jlosses = [], []
    train = J.JAEWrapper._train_epochs

    def recorded(self, params, *args):
        inits.append(params)
        out = train(self, params, *args)
        jlosses.append(np.asarray(out[2]))
        return out
    monkeypatch.setattr(J.JAEWrapper, "_train_epochs", recorded)
    jw.fit(x1, x2, cell_type=labels, epochs=epochs)

    orders, masks = _jax_draws(epochs, len(x1), 64, (150, 120, 100))
    tw = JAEWrapper(seed=0, device="cpu")
    make = tw._make_net

    def made(*args):
        net = make(*args)
        net.load_state_dict(jae_flax_to_torch(_np(inits[0])))
        return net
    it_o, it_m = iter(orders), iter(masks)
    monkeypatch.setattr(tw, "_make_net", made)
    monkeypatch.setattr(tw, "_mask", lambda shape, gen: next(it_m))
    monkeypatch.setattr(T, "epoch_batches", lambda gen, n, bs: next(it_o))
    tw.fit(x1, x2, cell_type=labels, epochs=epochs)
    assert next(it_o, None) is None and next(it_m, None) is None  # every draw used
    _close([h["loss"] for h in tw.history], jlosses[0], rtol=1e-4)
    assert_weights({k: v.numpy() for k, v in tw.net.state_dict().items()},
                   _numpy_state(jae_flax_to_torch(_np(jw.params))), 1e-4, epochs * 4)
    _close(tw.predict(), jw.predict(), rtol=1e-4, atol=1e-4)
    _close(tw.predict(x1[::-1], x2[::-1]), jw.predict(x1[::-1], x2[::-1]), rtol=1e-4,
           atol=1e-4)

    scores, emb = tw.score(None, types, return_pred=True)
    assert scores == labeled_clustering_evaluate(emb, types, n_clusters=3, device="cpu")
    assert tw.score(None, types) == scores["dance_nmi"]
    # the scIB suite on the same embedding as JAX's score(metric="openproblems")
    batch = np.arange(len(types)) % 2
    monkeypatch.setattr(jw, "predict", lambda x=None: tw.predict())
    got = tw.score(None, types, metric="openproblems", batch=batch, return_pred=True)[0]
    want = jw.score(None, types, metric="openproblems", batch=batch, return_pred=True)[0]
    assert set(got) == set(want)
    for key in want:  # silhouettes at 1e-6 of sklearn's, the rest exactly
        assert got[key] == pytest.approx(want[key], abs=1e-6), key


def test_jae_helpers_and_defaults():
    rng = np.random.default_rng(1)
    y_pred = rng.standard_normal((20, 3)).astype(np.float32)
    _close(T.random_classification_loss(torch.from_numpy(y_pred), np.arange(3)),
           J.random_classification_loss(y_pred, np.arange(3)))
    assert T.JAE is T._JAE
    tw = JAEWrapper(device="cpu")
    assert (tw.z_dim, tw.seed, repr(tw)) == (61, 0, "JAEWrapper(z_dim=61)")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            JAEWrapper()
