"""Port parity for DCCA: the eight attention-transfer losses and the
distillation classes, the modality VAE (NB, ZINB and Bernoulli) forward
with JAX's normals and dropout masks after the weight transfer, one phase
step's loss, gradients and AdamW step, fits through every cycle kind (full
batch) and a minibatch fit on JAX's normals and batch orders, ``predict``
on new inputs and ``score`` (dance_tpu_torch.modules.multi_modality.
joint_embedding.dcca, dance_tpu_torch.utils.loss).

Inputs are made with numpy from a seed (``torch_cases.multimodal_pair``:
240 cells x 100 genes of raw counts <-> 25 proteins, the counts given as
log1p); the flax weights are copied into the port
(``dcca_flax_to_torch``); JAX's normals and orders, recomputed here from its
keys by its own expressions (dcca.py:238-302), and its dropout masks
(flax's ``Dropout_{i}`` outputs, captured) are handed over through patched
``DCCA._noise``, ``DCCA._mask`` and ``epoch_batches``. Tolerances: losses,
their gradients with respect to the latent and forward values at rtol 1e-5
(atol 1e-6); weight gradients within 1e-4 of each tensor's largest value;
weights after one AdamW step on JAX's gradients at rtol 1e-5; fits (droprate
0) at rtol 1e-4 on each phase's last loss and on the embedding, their
weights by the ``torch_cases.assert_weights`` rule (the minibatch fit at
rate 1e-3: see its docstring).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dance_tpu.modules.multi_modality.joint_embedding import dcca as J
from dance_tpu.utils import loss as JL
from dance_tpu.utils.batch import epoch_batches as jax_epoch_batches
from dance_tpu_torch.modules.multi_modality.joint_embedding import DCCA
from dance_tpu_torch.modules.multi_modality.joint_embedding import dcca as T
from dance_tpu_torch.utils import labeled_clustering_evaluate
from dance_tpu_torch.utils import loss as TL
from dance_tpu_torch.utils.optim import adamw
from dance_tpu_torch.utils.params import dcca_flax_to_torch
from test_torch_vae_babel import _close, _grads_close, _np, _numpy_state, step_with
from torch_cases import assert_weights, multimodal_pair

MODES = ["Eucli", "NST", "FT", "SL", "CC", "AT", "KL_div", "L1"]
HIDDEN, Z = (16, 12), 8
FIT_HIDDEN = (16,)  # the fits: one hidden layer, as the default


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("mode", MODES)
def test_attention_losses_match_jax(mode):
    """Each mode's value and its gradient with respect to the training
    latent, on the same arrays; the log-variances hold negatives, which
    ``KL_diver`` (log-variances as scales) clamps at 1e-12 as JAX does."""
    rng = np.random.default_rng(MODES.index(mode))
    lat, z_pre, mean, m_pre = (rng.standard_normal((30, Z)).astype(np.float32) for _ in range(4))
    lv, lv_pre = (rng.normal(0.5, 0.6, (30, Z)).astype(np.float32) for _ in range(2))

    def jax_loss(lat, mean):
        out = {"latent": lat, "mean": mean, "logvar": jnp.asarray(lv)}
        return jnp.sum(J._make_attention(mode)(out, jnp.asarray(z_pre), (m_pre, lv_pre)))

    want, (g_lat, g_mean) = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1)))(lat, mean)
    tl, tm = _t(lat).requires_grad_(), _t(mean).requires_grad_()
    out = {"latent": tl, "mean": tm, "logvar": _t(lv)}
    got = T._make_attention(mode)(out, _t(z_pre), (_t(m_pre), _t(lv_pre)))
    assert got.shape == J._make_attention(mode)(
        {"latent": lat, "mean": mean, "logvar": lv}, z_pre, (m_pre, lv_pre)).shape
    got.sum().backward()
    _close(got.sum().detach(), want)
    for t, g in ((tl, g_lat), (tm, g_mean)):  # None: the loss does not read it
        got_g = torch.zeros_like(t) if t.grad is None else t.grad
        _close(got_g, g, atol=1e-6 * float(np.abs(g).max()) + 1e-7)


def test_distillation_classes_match_jax():
    """The list forms, FactorTransfer's p2 = 2 and 4-d maps, and the mode
    that falls through (None) to ``Eucli``."""
    rng = np.random.default_rng(3)
    a, b = (rng.standard_normal((6, 4, 3, 2)).astype(np.float32) for _ in range(2))
    _close(torch.stack(TL.NSTLoss()([_t(a)], [_t(b)])), JL.NSTLoss()([a], [b]))
    _close(torch.stack(TL.Similarity()([_t(a)], [_t(b)])), JL.Similarity()([a], [b]))
    _close(TL.FactorTransfer(p2=2)(_t(a), _t(b)), JL.FactorTransfer(p2=2)(a, b))
    _close(TL.FactorTransfer()(_t(a), _t(b)), JL.FactorTransfer()(a, b))
    x, y = a.reshape(6, -1), b.reshape(6, -1)
    out = {"latent": _t(x)}
    _close(T._make_attention(None)(out, _t(y), None),
           J._make_attention(None)({"latent": x}, y, None))


def random_flax_params(net, *args, seed: int = 0):
    """Weights for a flax module of the shapes its ``init`` gives (traced,
    not compiled): normals over sqrt(fan-in) for kernels, 0.1 · normals for
    the rest. Parity needs only the same weights on both sides."""
    shapes = jax.eval_shape(lambda: net.init({"params": jax.random.key(0),
                                              "dropout": jax.random.key(0)}, *args))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape) * (
            1 / np.sqrt(a.shape[0]) if len(a.shape) == 2 else 0.1), jnp.float32), shapes)


def _flax_vae(dim, likelihood, seed):
    net = J._ModalityVAE(input_dim=dim, hidden=HIDDEN, z_dim=Z, likelihood=likelihood)
    return net, random_flax_params(net, jnp.zeros((1, dim)), jnp.zeros(1), seed=seed)


@jax.jit
def _adamw_step(params, grads):
    """One step of optax's ``adamw(1e-2, weight_decay=5e-4)`` from a fresh
    state, compiled."""
    tx = optax.adamw(1e-2, weight_decay=5e-4)
    return optax.apply_updates(params, tx.update(grads, tx.init(params), params)[0])


def _inputs():
    counts, prot, types = multimodal_pair()
    return np.log1p(counts), prot, types


def _masks(st):
    """The keep masks of flax's dropout layers in call order (encoder, then
    decoder), from their captured outputs."""
    inter = st["intermediates"]
    return [torch.from_numpy(np.asarray(inter[part][f"Dropout_{i}"]["__call__"][0]) != 0)
            for part in ("encoder", "decoder") for i in range(len(HIDDEN))]


@pytest.mark.parametrize("likelihood", ["NB", "ZINB", "Bernoulli"])
def test_vae_forward_loss_grads_and_adamw_step(likelihood, monkeypatch):
    """One attention phase step of modality 1 (KL weight 0.3, Eucli, sf 1):
    the forward, the loss, every gradient and (NB) the weights after
    AdamW."""
    x1, x2, _ = _inputs()
    if likelihood == "Bernoulli":
        x, xr = x2, (x2 > 0).astype(np.float32)
    else:
        x, xr = x1, np.expm1(x1)
    lsf = np.log(np.maximum(xr.sum(1), 1.0)).astype(np.float32)
    net, params = _flax_vae(x.shape[1], likelihood, seed=1)
    rng = jax.random.key(5)
    rs = np.random.default_rng(5)
    frozen = tuple(rs.standard_normal((len(x), Z)).astype(np.float32) for _ in range(3))
    attn = J._make_attention("Eucli")

    def loss_fn(p):  # JAX's loss_fn of _phase_epoch (dcca.py:203-210), its dropout captured
        out, st = net.apply({"params": p}, x, lsf, rng=rng, training=True,
                            rngs={"dropout": jax.random.fold_in(rng, 3)},
                            capture_intermediates=True, mutable=["intermediates"])
        loss = net.nll(out, xr) + 0.3 * J._gaussian_kl(out["mean"], out["logvar"])
        return jnp.mean(loss + 1.0 * attn(out, frozen[0], frozen[1:])), (out, st)

    (jloss, (jout, st)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    masks = _masks(st)
    tw = DCCA(layer_e_1=HIDDEN, z_dim=Z, Type_1=likelihood, seed=0, device="cpu")
    tnet = T._ModalityVAE(x.shape[1], HIDDEN, Z, likelihood)
    tnet.load_state_dict(dcca_flax_to_torch(_np(params)))
    masks = iter(masks * 2)
    monkeypatch.setattr(tw, "_mask", lambda shape, gen: next(masks))
    drop = tw._dropout(None)
    noise = torch.from_numpy(np.array(jax.random.normal(rng, (len(x), Z))))
    tout = tnet(_t(x), _t(lsf), noise, drop)
    for key in tout:
        _close(tout[key].detach(), jout[key], name=key)
    loss = T.dcca_loss(tnet, _t(x), _t(xr), _t(lsf), 0.3, noise, tw._attn,
                       tuple(_t(f) for f in frozen), 1.0, drop)
    loss.backward()
    _close(loss.detach(), jloss)
    _grads_close(tnet, jgrads, dcca_flax_to_torch)
    if likelihood == "NB":  # the update rule, the same for every likelihood's tree
        opt = adamw(tnet, 1e-2, weight_decay=5e-4)
        step_with(opt, tnet, jgrads, dcca_flax_to_torch)
        want = dcca_flax_to_torch(_np(_adamw_step(params, jgrads)))
        for name, p in tnet.named_parameters():
            _close(p.detach(), want[name], name=name)


def _jax_draws(cycle, attention, epochs, n, batch_size, seed=0):
    """JAX's phase keys, then each epoch's normals and orders (dcca.py:238-302):
    (normals in step order, orders in epoch order)."""
    key = jax.random.split(jax.random.key(seed), 3)[2]
    phase_keys = []
    for used_cycle in range(cycle + 1):
        key, pk = jax.random.split(key)
        if used_cycle == 1:
            key, pk2 = jax.random.split(key)
            phase_keys += [(2, pk)] + ([(2, pk2)] if attention is not None else [])
        else:
            phase_keys.append((1 if used_cycle % 2 == 0 else 2, pk))
    normals, orders = [], []
    for _, pk in phase_keys:
        for _ in range(epochs):
            pk, ek = jax.random.split(pk)
            if batch_size is None:
                normals.append(jax.random.normal(ek, (n, Z)))
                continue
            idx = np.array(jax_epoch_batches(jax.random.fold_in(ek, 7), n, batch_size))
            orders.append(torch.from_numpy(idx))
            skey = ek
            for _ in idx:
                skey, r = jax.random.split(skey)
                normals.append(jax.random.normal(r, (batch_size, Z)))
    return [torch.from_numpy(np.array(a)) for a in normals], orders


def _fit_both(monkeypatch, kw, fit_kw, batch_size=None, seed=0):
    x1, x2, _ = _inputs()
    jw = J.DCCA(layer_e_1=FIT_HIDDEN, layer_e_2=FIT_HIDDEN, z_dim=Z, droprate=0.0, seed=seed,
                **kw)
    phase_losses, inits = [], []
    run = J.DCCA._run_phase

    def recorded(self, *args, **kwargs):
        if not inits:  # both nets' initial weights, before phase 0 trains net 1
            inits.extend((self.params1, self.params2))
        phase_losses.append(run(self, *args, **kwargs))
        return phase_losses[-1]
    monkeypatch.setattr(J.DCCA, "_run_phase", recorded)
    jw.fit(x1, x2, batch_size=batch_size, **fit_kw)

    normals, orders = _jax_draws(jw.cycle, jw.attention_loss, fit_kw["epochs"], len(x1),
                                 batch_size, seed)
    tw = DCCA(layer_e_1=FIT_HIDDEN, layer_e_2=FIT_HIDDEN, z_dim=Z, droprate=0.0, seed=seed,
              device="cpu", **kw)
    make = tw._make_nets

    def made(*args):
        nets = make(*args)
        for net, p in zip(nets, inits):
            net.load_state_dict(dcca_flax_to_torch(_np(p)))
        return nets
    it_n, it_o = iter(normals), iter(orders)
    monkeypatch.setattr(tw, "_make_nets", made)
    monkeypatch.setattr(tw, "_noise", lambda shape, gen: next(it_n))
    monkeypatch.setattr(T, "epoch_batches", lambda gen, n, bs: next(it_o))
    tw.fit(x1, x2, batch_size=batch_size, **fit_kw)
    assert next(it_n, None) is None and next(it_o, None) is None  # every draw used
    return jw, tw, phase_losses, (x1, x2)


def _weights_close(tw, jw, lr, steps):
    for tnet, jp in ((tw.net1, jw.params1), (tw.net2, jw.params2)):
        assert_weights({k: v.numpy() for k, v in tnet.state_dict().items()},
                       _numpy_state(dcca_flax_to_torch(_np(jp))), lr, steps)


def test_dcca_fit_every_cycle_kind_matches_jax(monkeypatch):
    """Full batch at the default rate, cycle 3: modality 1 alone, modality 2
    without then with attention, modality 1 with attention, modality 2 with
    attention."""
    epochs = 2
    jw, tw, jlosses, (x1, x2) = _fit_both(monkeypatch, dict(cycle=3), dict(epochs=epochs))
    got = [h["loss"] for h in tw.history if h["epoch"] == epochs]
    assert [(h["modality"], h["attention"]) for h in tw.history[::epochs]] == [
        (1, False), (2, False), (2, True), (1, True), (2, True)]
    _close(got, jlosses, rtol=1e-4)
    _weights_close(tw, jw, 1e-2, 3 * epochs)
    _close(tw.predict(), jw.predict(), rtol=1e-4, atol=1e-4)
    types = multimodal_pair()[2]  # the k-means NMI, k-means held to JAX's in test_torch_scmogcn
    scores, emb = tw.score(None, types, return_pred=True)
    assert scores == labeled_clustering_evaluate(tw.predict(), types, n_clusters=3, device="cpu")
    assert tw.score(None, types) == scores["dance_nmi"] and np.array_equal(emb, tw.predict())
    # inputs given replace the training ones, with log library sizes of 0
    _close(tw.predict(x1[::-1], x2[::-1]), jw.predict(x1[::-1], x2[::-1]), rtol=1e-4, atol=1e-4)
    assert not tw._lsf1.any() and tw._x1.shape == x1.shape


def test_dcca_minibatch_fit_matches_jax(monkeypatch):
    """Batches of 64 (4 wrap-padded steps an epoch), ZINB counts, cycle 0,
    at rate 1e-3: at the default 1e-2 the two packages' weights part after
    ~8 such steps (rounding grown by Adam: in a cycle-3 fit 1 weight of
    6,689 is off rtol 1e-4 after one epoch a phase, 3,737 of 5,432 after
    two, while at 1e-3 or 1e-4 none is); the rule at 1e-2 is held by the
    one-step test and the full-batch fit."""
    epochs, lr = 2, 1e-3
    jw, tw, jlosses, _ = _fit_both(monkeypatch, dict(Type_1="ZINB", cycle=0),
                                   dict(epochs=epochs, lr1=lr), batch_size=64)
    assert len(tw.history) == epochs and [h["modality"] for h in tw.history] == [1] * epochs
    _close([tw.history[-1]["loss"]], jlosses, rtol=1e-4)
    _weights_close(tw, jw, lr, epochs * 4)
    _close(tw.predict(), jw.predict(), rtol=1e-4, atol=1e-4)


def test_dcca_defaults_and_device():
    tw = DCCA(device="cpu")
    assert (tw.z_dim, tw.z_dim2, tw.hidden1, tw.hidden2, tw.type_1, tw.type_2, tw.cycle,
            tw.sf1, tw.sf2) == (16, 16, (128,), (128,), "NB", "Bernoulli", 1, 2.0, 1.0)
    assert repr(tw) == "DCCA(z_dim=16, cycle=1, type_1='NB', type_2='Bernoulli')"
    with pytest.raises(ValueError, match="likelihood"):
        T._ModalityVAE(4, (3,), 2, "Poisson")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DCCA()
