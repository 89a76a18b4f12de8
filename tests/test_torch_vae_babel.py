"""Port parity for the VAE blocks and BABEL: the Gaussian encoder and
decoder, the NB decoder (with and without a library), the
reparameterisation with JAX's normals, the Gaussian KL, BABEL's net, loss,
gradients and one Adam step from the flax weights, a fit with validation
selection and the early stop against JAX's ``_train_epochs_val`` on JAX's
batch orders, the no-validation fit, warm start, ``predict``/``score``, and
the reference-named helpers (dance_tpu_torch.nn.vae, modules.multi_modality.
predict_modality.babel).

Inputs are made with numpy from a seed (240 cells x 100 genes <-> 25
proteins, the JAX multimodal tests' size); the flax weights are copied into
the port (``babel_flax_to_torch``) and the batch orders are JAX's, handed
over through a patched ``epoch_batches``. Tolerances: forward values and
losses at rtol 1e-5 (atol 1e-6); gradients within 1e-4 of each tensor's
largest value; weights after one Adam step on JAX's gradients at rtol 1e-5
(:func:`step_with`); fits within 1e-4
on the validation RMSEs and predictions, their weights by the
``torch_cases.assert_weights`` rule, best and last epochs exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dance_tpu.modules.multi_modality.predict_modality import babel as J
from dance_tpu.nn import vae as JV
from dance_tpu.utils.batch import epoch_batches as jax_epoch_batches
from dance_tpu.utils.loss import nb_nll as jax_nb_nll
from dance_tpu_torch.modules.multi_modality.predict_modality import babel as T
from dance_tpu_torch.nn import vae as TV
from dance_tpu_torch.utils import params as P
from dance_tpu_torch.utils.params import babel_flax_to_torch
from torch_cases import assert_weights, multimodal_pair

CPU = torch.device("cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rtol=1e-5, atol=1e-6, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=name)


def _grads_close(tnet, jgrads, to_torch):
    """Every gradient within 1e-4 of its tensor's largest value; torch's None
    (a weight the loss does not reach) is JAX's zeros."""
    want = to_torch(_np(jgrads))
    for name, p in tnet.named_parameters():
        ref = want[name].numpy()
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        scale = max(float(np.abs(ref).max()), 1e-30)
        assert float(np.abs(got - ref).max()) <= 1e-4 * scale, name


@jax.jit
def _adam_step(params, grads, lr):
    tx = optax.adam(lr)
    return optax.apply_updates(params, tx.update(grads, tx.init(params), params)[0])


def adam_step(params, grads, lr):
    """One optax Adam step from a fresh state, compiled."""
    return _adam_step(params, grads, lr)


def step_with(opt, tnet, jgrads, to_torch):
    """One step of ``opt`` on JAX's gradients: the update rule held alone. A
    weight whose gradient is near Adam's eps moves by ``lr · g / (|g| +
    eps)``, which turns a rounding-level gap in ``g`` (~1e-10) into ~1e-6."""
    want = to_torch(_np(jgrads))
    for name, p in tnet.named_parameters():
        p.grad = want[name].clone()
    opt.step()


def _numpy_state(state):
    return {k: np.asarray(v) for k, v in state.items()}


def _block(params, heads):
    state = {}
    P._vae_block(state, "b", _np(params), heads)
    return {k[2:]: v for k, v in state.items()}


@pytest.mark.parametrize("hidden", [(16,), (24, 12)])
def test_vae_blocks_match_jax(hidden):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(30, 20)).astype(np.float32)
    z = rng.normal(size=(30, 6)).astype(np.float32)
    lib = rng.gamma(5.0, 20.0, (30, 1)).astype(np.float32)
    key = jax.random.key(0)
    enc, dec = JV.GaussianEncoder(hidden, 6), JV.GaussianDecoder(hidden, 11)
    nbd = JV.NBDecoder(hidden, 20)
    pe, pd = enc.init(key, x)["params"], dec.init(key, z)["params"]
    pn = nbd.init(key, z, lib)["params"]
    tenc, tdec = TV.GaussianEncoder(20, hidden, 6), TV.GaussianDecoder(6, hidden, 11)
    tnbd = TV.NBDecoder(6, hidden, 20)
    tenc.load_state_dict(_block(pe, ("mu", "logvar")))
    tdec.load_state_dict(_block(pd, ("out",)))
    tnbd.load_state_dict(_block(pn, ("mean", "disp")))
    with torch.no_grad():
        for g, w in zip(tenc(torch.from_numpy(x)), enc.apply({"params": pe}, x)):
            _close(g, w)
        _close(tdec(torch.from_numpy(z)), dec.apply({"params": pd}, z))
        for library in (lib, None):
            got = tnbd(torch.from_numpy(z), None if library is None else torch.from_numpy(library))
            for g, w in zip(got, nbd.apply({"params": pn}, z, library)):
                _close(g, w)
    mu, lv = (rng.normal(size=(30, 6)).astype(np.float32) for _ in range(2))
    noise = np.array(jax.random.normal(jax.random.key(3), mu.shape))
    _close(TV.reparameterize(torch.from_numpy(mu), torch.from_numpy(lv), torch.from_numpy(noise)),
           JV.reparameterize(jax.random.key(3), mu, lv))
    _close(TV.gaussian_kl(torch.from_numpy(mu), torch.from_numpy(lv)), JV.gaussian_kl(mu, lv))
    drawn = TV.reparameterize(torch.zeros(4000, 2), torch.zeros(4000, 2),
                              generator=torch.Generator().manual_seed(0))
    assert abs(float(drawn.std()) - 1.0) < 0.05


def _babel_case(hidden=16, seed=0):
    x1, x2, _ = multimodal_pair()
    net = J._Babel(dim1=x1.shape[1], dim2=x2.shape[1], hidden=hidden)
    lib = x1.sum(1, keepdims=True)
    params = jax.jit(net.init)(jax.random.key(seed), x1[:1], x2[:1], lib[:1])["params"]
    tnet = T._Babel(x1.shape[1], x2.shape[1], hidden)
    tnet.load_state_dict(babel_flax_to_torch(_np(params)))
    return x1, x2, lib, net, params, tnet


def _jax_babel_loss(net, params, bx1, bx2, blib):
    out, z1, z2 = net.apply({"params": params}, bx1, bx2, blib)
    return (jax_nb_nll(bx1, *out["11"]) + jax_nb_nll(bx1, *out["21"])
            + jnp.mean((out["12"] - bx2) ** 2) + jnp.mean((out["22"] - bx2) ** 2)
            + 0.1 * jnp.mean((z1 - z2) ** 2))


def test_babel_forward_loss_grads_and_adam_step():
    x1, x2, lib, net, params, tnet = _babel_case()
    rows = np.arange(0, 240, 4)
    bx1, bx2, blib = x1[rows], x2[rows], lib[rows]
    jout, jz1, jz2 = net.apply({"params": params}, bx1, bx2, blib)
    t = [torch.from_numpy(a) for a in (bx1, bx2, blib)]
    tout, tz1, tz2 = tnet(*t)
    for key in ("11", "21"):
        for g, w in zip(tout[key], jout[key]):
            _close(g.detach(), w)
    for key in ("12", "22"):
        _close(tout[key].detach(), jout[key])
    _close(tz1.detach(), jz1)
    _close(tz2.detach(), jz2)
    jloss, jgrads = jax.jit(jax.value_and_grad(_jax_babel_loss, argnums=1), static_argnums=0)(
        net, params, bx1, bx2, blib)
    opt = torch.optim.Adam(tnet.parameters(), lr=1e-3)
    loss = T.babel_loss(tnet, *t)
    loss.backward()
    _close(loss.detach(), jloss)
    _grads_close(tnet, jgrads, babel_flax_to_torch)
    step_with(opt, tnet, jgrads, babel_flax_to_torch)
    want = babel_flax_to_torch(_np(adam_step(params, jgrads, 1e-3)))
    for name, p in tnet.named_parameters():
        _close(p.detach(), want[name], atol=1e-6, name=name)


def _patch_orders(monkeypatch, orders):
    it = iter(orders)
    monkeypatch.setattr(T, "epoch_batches", lambda gen, n, bs: torch.from_numpy(next(it)))


def _port_wrapper(state, monkeypatch, hidden=16):
    tw = T.BabelWrapper(hidden=hidden, seed=0, device="cpu")
    make = tw._make_net

    def made(*args):
        net = make(*args)
        net.load_state_dict(state)
        return net
    monkeypatch.setattr(tw, "_make_net", made)
    return tw


@pytest.mark.parametrize("earlystop", [0, 20])
def test_babel_val_fit_matches_jax_epochs(earlystop, monkeypatch):
    x1, x2, _, net, params, _ = _babel_case()
    epochs, bs, lr, val_ratio = 5, 48, 3e-3, 0.15
    n = len(x1)
    n_val = int(n * val_ratio)
    perm = np.random.default_rng(0).permutation(n)
    tr, va = perm[:n - n_val], perm[n - n_val:]
    jw = J.BabelWrapper(dim_in=x1.shape[1], dim_out=x2.shape[1], hidden=16, seed=0)
    jw.net, jw._tx = net, optax.adam(lr)
    keys = jax.random.split(jax.random.key(0), epochs)
    lib1 = x1[tr].sum(1, keepdims=True)
    best, _, vals, best_val, best_epoch, ran, _ = jw._train_epochs_val(
        params, jw._tx.init(params), jnp.asarray(x1[tr]), jnp.asarray(x2[tr]),
        jnp.asarray(lib1), jnp.asarray(x1[va]), jnp.asarray(x2[va]), keys, bs, earlystop,
        len(va))
    ran = int(ran)
    _patch_orders(monkeypatch, [np.asarray(jax_epoch_batches(k, len(tr), bs)) for k in keys])
    tw = _port_wrapper(babel_flax_to_torch(_np(params)), monkeypatch)
    tw.fit(x1, x2, val_ratio=val_ratio, epochs=epochs, lr=lr, batch_size=bs,
           earlystop=earlystop)
    assert len(tw.history) == ran and tw.best_epoch == int(best_epoch)
    assert ran == (2 if earlystop == 0 else epochs)  # 0: e > 0 and e - best >= 0 at epoch 1
    _close([h["val"] for h in tw.history], np.asarray(vals)[:ran], rtol=1e-4, atol=1e-6)
    _close(tw.best_val, best_val, rtol=1e-4)
    state = {k: v.numpy() for k, v in tw.net.state_dict().items()}
    assert_weights(state, _numpy_state(babel_flax_to_torch(_np(best))), lr, ran * 5)
    jw.params = best
    _close(tw.predict(x1), jw.predict(x1), rtol=1e-4, atol=1e-4)
    _close(tw.score(x1, x2), jw.score(x1, x2), rtol=1e-4)


def test_babel_no_val_fit_and_warm_start(monkeypatch):
    x1, x2, _, net, params, _ = _babel_case()
    epochs, bs, lr = 3, 64, 3e-3
    jw = J.BabelWrapper(dim_in=x1.shape[1], dim_out=x2.shape[1], hidden=16, seed=0)
    jw.fit(x1, x2, val_ratio=0, epochs=epochs, lr=lr, batch_size=bs)
    keys = jax.random.split(jax.random.key(0), epochs)
    _patch_orders(monkeypatch, [np.asarray(jax_epoch_batches(k, len(x1), bs)) for k in keys])
    tw = _port_wrapper(babel_flax_to_torch(_np(params)), monkeypatch)
    tw.fit(x1, x2, val_ratio=0, epochs=epochs, lr=lr, batch_size=bs)
    assert [h["val"] for h in tw.history] == [None] * epochs
    assert_weights({k: v.numpy() for k, v in tw.net.state_dict().items()},
                   _numpy_state(babel_flax_to_torch(_np(jw.params))), lr, epochs * 4)
    _close(tw.predict(x1), jw.predict(x1), rtol=1e-4, atol=1e-4)
    # a second fit starts from the first's weights, in both packages
    net_before = tw.net
    before = {k: v.clone() for k, v in tw.net.state_dict().items()}
    tw.fit(x1, x2, val_ratio=0, epochs=0)
    assert tw.net is net_before
    for k, v in tw.net.state_dict().items():
        assert torch.equal(v, before[k])


def test_babel_defaults_and_device():
    x1, x2, _ = multimodal_pair(n=40)
    tw = T.BabelWrapper(hidden=8, device="cpu").fit(x1, x2, epochs=2, batch_size=16)
    assert tw.predict(x1).shape == x2.shape and len(tw.history) == 2
    assert np.isfinite([h["loss"] for h in tw.history]).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.BabelWrapper()


def test_babel_helpers_match_jax():
    x = np.linspace(-30, 30, 121, dtype=np.float32)
    _close(T.Exp()(torch.from_numpy(x)), J.Exp()(x))
    _close(T.Exp(1e-3, 10.0).forward(x), J.Exp(1e-3, 10.0)(x))
    for beta in (1.0, 2.5):
        _close(T.ClippedSoftplus(beta=beta)(torch.from_numpy(x)), J.ClippedSoftplus(beta=beta)(x))
    nested = {"a": torch.ones(2), "b": [torch.zeros(1), (torch.ones(3), 4)]}
    moved = T.recursive_to_device(nested, "cpu")
    assert moved["b"][1][1] == 4 and isinstance(moved["b"][1], tuple)
    assert torch.equal(moved["b"][1][0], torch.ones(3))
