"""Port parity for CMAE, prediction and matching: the generator and
discriminator after the weight transfer, both losses and their gradients,
one discriminator step then one generator step against JAX's
``_disc_step``/``_gen_step`` (two optax Adams), a 3-epoch fit on JAX's
batch orders, ``predict``/``encode``/``score``, the L1 matching matrix, the
checkpoint, and the reference-named helpers (dance_tpu_torch.modules.
multi_modality.{predict,match}_modality.cmae).

Inputs are made with numpy from a seed (240 cells, log1p of 100 genes <->
25 proteins); the flax weights are copied into the port
(``cmae_flax_to_torch``) and the batch orders are JAX's, handed over
through a patched ``epoch_batches_dropped``. Tolerances: forward values and
losses at rtol 1e-5 (atol 1e-6); gradients within 1e-4 of each tensor's
largest value; weights after one step on JAX's gradients at rtol 1e-5; the
fit's predictions,
latents and RMSE within 1e-4, its weights by the
``torch_cases.assert_weights`` rule; matching matrices identical.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dance_tpu.modules.multi_modality.match_modality import cmae as JM
from dance_tpu.modules.multi_modality.predict_modality import cmae as J
from dance_tpu_torch.modules.multi_modality.match_modality import cmae as TM
from dance_tpu_torch.modules.multi_modality.predict_modality import cmae as T
from dance_tpu_torch.utils.params import cmae_flax_to_torch
from test_torch_vae_babel import (_close, _grads_close, _np, _numpy_state, adam_step,
                                  step_with)
from torch_cases import assert_weights, multimodal_pair

Z, HIDDEN = 8, 16


def _inputs():
    counts, x2, _ = multimodal_pair()
    return np.log1p(counts), x2


def _jax_nets(x1, x2, seed=0):
    """JAX's nets and initial weights, drawn as ``CMAE.fit`` draws them."""
    net = J._CMAENet(dim1=x1.shape[1], dim2=x2.shape[1], z_dim=Z, hidden=HIDDEN)
    disc = J._Disc()
    key = jax.random.key(seed)
    g = jax.jit(net.init)(key, x1[:1], x2[:1])["params"]
    d = jax.jit(disc.init)(jax.random.fold_in(key, 1), jnp.zeros((1, Z)))["params"]
    return net, disc, g, d


def _torch_nets(x1, x2, g, d):
    tnet, tdisc = T._CMAENet(x1.shape[1], x2.shape[1], Z, HIDDEN), T._Disc(Z)
    tnet.load_state_dict(cmae_flax_to_torch(_np(g)))
    tdisc.load_state_dict(cmae_flax_to_torch(_np(d)))
    return tnet, tdisc


def _jax_losses(net, disc, w):
    """The JAX steps' losses, by their own expressions (cmae.py:98-126)."""
    bce = optax.sigmoid_binary_cross_entropy

    def gen(g, d, x1, x2):
        r1, r2, t12, t21, z1, z2 = net.apply({"params": g}, x1, x2)
        d_out = disc.apply({"params": d}, z1)
        return (w["recon"] * (jnp.mean((r1 - x1) ** 2) + jnp.mean((r2 - x2) ** 2))
                + w["trans"] * (jnp.mean((t12 - x2) ** 2) + jnp.mean((t21 - x1) ** 2))
                + w["adv"] * bce(d_out, jnp.ones_like(d_out)).mean()
                + w["align"] * jnp.mean((z1 - z2) ** 2))

    def dis(d, g, x1, x2):
        z1 = net.apply({"params": g}, x1, method=net.encode1)
        z2 = net.apply({"params": g}, x2, method=net.encode2)
        d1, d2 = disc.apply({"params": d}, z1), disc.apply({"params": d}, z2)
        return bce(d1, jnp.zeros_like(d1)).mean() + bce(d2, jnp.ones_like(d2)).mean()

    return jax.jit(jax.value_and_grad(gen)), jax.jit(jax.value_and_grad(dis))


def test_cmae_losses_grads_and_one_step():
    x1, x2 = _inputs()
    net, disc, g, d = _jax_nets(x1, x2)
    tnet, tdisc = _torch_nets(x1, x2, g, d)
    jw = J.CMAE(hyperparameters={"gan_w": 0.3, "super_w": 0.7}, z_dim=Z, hidden=HIDDEN)
    tw = T.CMAE(hyperparameters={"gan_w": 0.3, "super_w": 0.7}, z_dim=Z, hidden=HIDDEN,
                device="cpu")
    assert tw.loss_weights == jw.loss_weights
    rows = np.arange(0, 240, 3)
    bx1, bx2 = x1[rows], x2[rows]
    t1, t2 = torch.from_numpy(bx1), torch.from_numpy(bx2)
    with torch.no_grad():
        for got, want in zip(tnet(t1, t2), net.apply({"params": g}, bx1, bx2)):
            _close(got, want)
        z = tnet.encode1(t1)
        _close(tdisc(z), disc.apply({"params": d}, z.numpy()))
    gen_vg, dis_vg = _jax_losses(net, disc, jw.loss_weights)
    # the discriminator's step, then the generator's against the updated one
    dl, dg = dis_vg(d, g, bx1, bx2)
    d_opt = torch.optim.Adam(tdisc.parameters(), lr=1e-3)
    g_opt = torch.optim.Adam(tnet.parameters(), lr=1e-3)
    loss = T.cmae_disc_loss(tnet, tdisc, t1, t2)
    loss.backward()
    _close(loss.detach(), dl)
    _grads_close(tdisc, dg, cmae_flax_to_torch)
    assert all(p.grad is None for p in tnet.parameters())
    step_with(d_opt, tdisc, dg, cmae_flax_to_torch)
    jw.net, jw.disc, jw._g_tx, jw._d_tx = net, disc, optax.adam(1e-3), optax.adam(1e-3)
    d1, _, _ = jw._disc_step(g, d, jw._d_tx.init(d), bx1, bx2)
    for name, p in tdisc.named_parameters():
        _close(p.detach(), cmae_flax_to_torch(_np(d1))[name], name=name)
    _close(_np(d1)["Dense_0"]["kernel"], np.asarray(adam_step(d, dg, 1e-3)["Dense_0"]["kernel"]))
    gl, gg = gen_vg(g, d1, bx1, bx2)
    loss = T.cmae_gen_loss(tnet, tdisc, t1, t2, tw.loss_weights)
    loss.backward()
    _close(loss.detach(), gl)
    _grads_close(tnet, gg, cmae_flax_to_torch)
    step_with(g_opt, tnet, gg, cmae_flax_to_torch)
    g1, _, _ = jw._gen_step(g, d1, jw._g_tx.init(g), bx1, bx2)
    want = cmae_flax_to_torch(_np(g1))
    for name, p in tnet.named_parameters():
        _close(p.detach(), want[name], name=name)


def _fit_pair(x1, x2, epochs, bs, lr, monkeypatch, cls=T.CMAE, jcls=J.CMAE):
    """The JAX fit, and the port's from JAX's weights on JAX's orders."""
    jw = jcls(z_dim=Z, hidden=HIDDEN, seed=0)
    jw.fit(x1, x2, epochs=epochs, lr=lr, batch_size=bs)
    _, _, g, d = _jax_nets(x1, x2)
    keys = jax.random.split(jax.random.fold_in(jax.random.key(0), 7), epochs)
    nb = len(x1) // bs
    orders = iter([np.array(jax.random.permutation(k, len(x1)))[:nb * bs].reshape(nb, bs)
                   for k in keys])
    monkeypatch.setattr(T, "epoch_batches_dropped",
                        lambda gen, n, b: torch.from_numpy(next(orders)))
    tw = cls(z_dim=Z, hidden=HIDDEN, seed=0, device="cpu")
    make = tw._make_nets

    def made(*args):
        net, disc = make(*args)
        net.load_state_dict(cmae_flax_to_torch(_np(g)))
        disc.load_state_dict(cmae_flax_to_torch(_np(d)))
        return net, disc
    monkeypatch.setattr(tw, "_make_nets", made)
    return jw, tw


def test_cmae_fit_matches_jax(monkeypatch, tmp_path):
    x1, x2 = _inputs()
    epochs, bs, lr = 3, 64, 1e-3
    jw, tw = _fit_pair(x1, x2, epochs, bs, lr, monkeypatch)
    tw.fit(x1, x2, epochs=epochs, lr=lr, batch_size=bs, checkpoint_directory=str(tmp_path))
    assert len(tw.history) == epochs
    assert_weights({k: v.numpy() for k, v in tw.net.state_dict().items()},
                   _numpy_state(cmae_flax_to_torch(_np(jw.params))), lr, epochs * 3)
    _close(tw.predict(x1), jw.predict(x1), rtol=1e-4, atol=1e-4)
    for m, data in ((1, x1), (2, x2)):
        _close(tw.encode(data, m), jw.encode(data, m), rtol=1e-4, atol=1e-4)
    _close(tw.score(x1, x2), jw.score(x1, x2), rtol=1e-4)
    # one snapshot of both nets, found by the reference's lookup
    path = T.get_model_list(str(tmp_path), "gen")
    assert os.path.basename(path) == f"gen_{epochs:08d}.pt"
    saved = torch.load(path, weights_only=True)
    assert set(saved) == {"gen", "dis"}
    for k, v in tw.disc.state_dict().items():
        assert torch.equal(saved["dis"][k], v)
    assert T.get_model_list(str(tmp_path / "missing"), "gen") is None
    assert T.get_model_list(str(tmp_path), "dis") is None


def test_cmae_matching_matches_jax(monkeypatch):
    x1, x2 = _inputs()
    epochs, bs, lr = 2, 64, 1e-3
    jw, tw = _fit_pair(x1, x2, epochs, bs, lr, monkeypatch, TM.CMAE, JM.CMAE)
    tw.fit(x1, x2, epochs=epochs, lr=lr, batch_size=bs)
    # JAX's trained weights in the port: the latents agree to rounding, the
    # matchings exactly
    tw.net.load_state_dict(cmae_flax_to_torch(_np(jw.params)))
    te1, te2 = x1[200:], x2[200:]
    got, want = tw.predict_matching(te1, te2), jw.predict_matching(te1, te2)
    assert got.shape == (40, 40) and np.array_equal(got, want)
    assert tw.score_matching(got) == jw.score_matching(want)
    assert np.array_equal(tw.predict_matching(te1, te2, metric="l2"),
                          jw.predict_matching(te1, te2, metric="l2"))


def test_cmae_reference_helpers():
    gen = torch.Generator().manual_seed(0)
    w = torch.empty(300, 200)
    T.weights_init("gaussian")(w, gen)
    assert abs(float(w.std()) - 0.02) < 1e-3
    for name, std in (("default", (1 / 200) ** 0.5), ("kaiming", (2 / 200) ** 0.5),
                      ("xavier", (2 / 500) ** 0.5)):
        T.weights_init(name)(w, gen)
        assert abs(float(w.std()) / std - 1) < 0.02, name
        assert name == "xavier" or float(w.abs().max()) <= 2 * std / 0.87962566 + 1e-6
    T.weights_init("orthogonal")(w, gen)
    _close(w.T @ w, np.eye(200), atol=1e-5)
    with pytest.raises(AssertionError, match="Unsupported"):
        T.weights_init("uniform")
    for hyper in ({}, {"lr_policy": "constant", "lr": 3e-3},
                  {"lr_policy": "step", "lr": 1e-2, "step_size": 7, "gamma": 0.5}):
        want, got = J.get_scheduler(hyper), T.get_scheduler(hyper)
        for count in (0, 1, 6, 7, 8, 20, 21):
            _close(got(count), want(count))
    with pytest.raises(NotImplementedError):
        T.get_scheduler({"lr_policy": "cosine"})
