"""Port parity for scMM, prediction and matching, in both log-variance
modes (free, and pinned as the reference architecture pins it): the net's
forward with JAX's normals after the weight transfer, the loss, its
gradients and one Adam step, a fit and a warm-started second fit on JAX's
batch orders and normals, ``predict``/``encode``/``score``, the L2 matching
matrix and the reference-named helpers (dance_tpu_torch.modules.
multi_modality.{predict,match}_modality.scmm).

Inputs are made with numpy from a seed (240 cells x 100 genes of raw counts
<-> 25 proteins); the flax weights are copied into the port
(``mmvae_flax_to_torch``); JAX's orders and normals, recomputed here from
its keys by its own expressions (scmm.py:110-114, :70-72), are handed over
through a patched ``epoch_batches_dropped`` and ``MMVAE._noise``.
Tolerances: forward values and losses at rtol 1e-5 (atol 1e-6); gradients
within 1e-4 of each tensor's largest value; weights after one step on JAX's
gradients at rtol 1e-5; fits within 1e-4 on predictions, latents and RMSE, their weights by
the ``torch_cases.assert_weights`` rule; matching matrices identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dance_tpu.modules.multi_modality.match_modality import scmm as JM
from dance_tpu.modules.multi_modality.predict_modality import scmm as J
from dance_tpu.nn.vae import gaussian_kl
from dance_tpu.utils.loss import nb_nll
from dance_tpu_torch.modules.multi_modality.match_modality import scmm as TM
from dance_tpu_torch.modules.multi_modality.predict_modality import scmm as T
from dance_tpu_torch.utils.params import mmvae_flax_to_torch
from test_torch_vae_babel import (_close, _grads_close, _np, _numpy_state, adam_step,
                                  step_with)
from torch_cases import assert_weights, multimodal_pair

Z = 8


def _case(ref: bool, seed: int = 0):
    x1, x2, _ = multimodal_pair()
    net = J._MMVAENet(dim1=x1.shape[1], dim2=x2.shape[1], z_dim=Z, ref_logvar=ref)
    key = jax.random.key(seed)
    params = jax.jit(net.init)(key, x1[:1], x2[:1], jax.random.fold_in(key, 9))["params"]
    tnet = T._MMVAENet(x1.shape[1], x2.shape[1], Z, ref_logvar=ref)
    tnet.load_state_dict(mmvae_flax_to_torch(_np(params)))
    return x1, x2, net, params, tnet


def _normals(rng, n):
    """The two latents' normals JAX draws from a step's key (scmm.py:70-72)."""
    r1, r2 = jax.random.split(rng)
    return tuple(torch.from_numpy(np.array(jax.random.normal(r, (n, Z)))) for r in (r1, r2))


@pytest.mark.parametrize("ref", [False, True])
def test_mmvae_forward_loss_grads_and_adam_step(ref):
    x1, x2, net, params, tnet = _case(ref)
    rows = np.arange(1, 240, 4)
    bx1, bx2 = x1[rows], x2[rows]
    rng = jax.random.key(5)
    jout, (jmu1, jlv1), (jmu2, jlv2) = net.apply({"params": params}, bx1, bx2, rng)
    t1, t2 = torch.from_numpy(bx1), torch.from_numpy(bx2)
    noise = _normals(rng, len(rows))
    tout, (mu1, lv1), (mu2, lv2) = tnet(t1, t2, noise)
    for key in ("11", "21"):
        for g, w in zip(tout[key], jout[key]):
            _close(g.detach(), w)
    for key in ("12", "22"):
        _close(tout[key].detach(), jout[key])
    for g, w in ((mu1, jmu1), (lv1, jlv1), (mu2, jmu2), (lv2, jlv2)):
        _close(g.detach(), w)

    def loss_fn(p):  # JAX's loss by its own expression (scmm.py:116-124)
        out, (m1, l1), (m2, l2) = net.apply({"params": p}, bx1, bx2, rng)
        ll = (nb_nll(bx1, *out["11"]) + nb_nll(bx1, *out["21"])
              + jnp.mean((out["12"] - bx2) ** 2) + jnp.mean((out["22"] - bx2) ** 2))
        return ll + 1e-3 * (gaussian_kl(m1, l1) + gaussian_kl(m2, l2))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    opt = torch.optim.Adam(tnet.parameters(), lr=1e-3)
    loss = T.mmvae_loss(tnet, t1, t2, noise)
    loss.backward()
    _close(loss.detach(), jloss)
    _grads_close(tnet, jgrads, mmvae_flax_to_torch)
    step_with(opt, tnet, jgrads, mmvae_flax_to_torch)
    want = mmvae_flax_to_torch(_np(adam_step(params, jgrads, 1e-3)))
    for name, p in tnet.named_parameters():
        _close(p.detach(), want[name], name=name)


def _patch_draws(monkeypatch, tw, epochs, n, bs, seed=0):
    """JAX's batch orders and normals for one ``fit`` of ``epochs`` epochs
    (scmm.py:110-114, 163)."""
    nb = n // bs
    orders, normals = [], []
    for key in jax.random.split(jax.random.key(seed), epochs):
        orders.append(np.array(jax.random.permutation(key, n))[:nb * bs].reshape(nb, bs))
        for step_key in jax.random.split(jax.random.fold_in(key, 3), nb):
            normals.extend(_normals(step_key, bs))
    it_o, it_n = iter(orders), iter(normals)
    monkeypatch.setattr(T, "epoch_batches_dropped", lambda gen, n_, b: torch.from_numpy(next(it_o)))
    monkeypatch.setattr(tw, "_noise", lambda shape, gen: next(it_n))


def _port(cls, params, monkeypatch, ref):
    tw = cls(z_dim=Z, seed=0, reference_protocol=ref, device="cpu")
    make = tw._make_net

    def made(*args):
        net = make(*args)
        net.load_state_dict(mmvae_flax_to_torch(_np(params)))
        return net
    monkeypatch.setattr(tw, "_make_net", made)
    return tw


@pytest.mark.parametrize("ref", [False, True])
def test_mmvae_fit_and_warm_start_match_jax(ref, monkeypatch):
    x1, x2, _, params, _ = _case(ref)
    bs, lr = 64, 1e-3
    jw = J.MMVAE(z_dim=Z, seed=0, reference_protocol=ref)
    tw = _port(T.MMVAE, params, monkeypatch, ref)
    for epochs in (2, 1):  # the second fit starts from the first's weights
        jw.fit(x1, x2, epochs=epochs, lr=lr, batch_size=bs)
        _patch_draws(monkeypatch, tw, epochs, len(x1), bs)
        tw.fit(x1, x2, epochs=epochs, lr=lr, batch_size=bs)
        assert len(tw.history) == epochs and np.isfinite([h["loss"] for h in tw.history]).all()
    assert_weights({k: v.numpy() for k, v in tw.net.state_dict().items()},
                   _numpy_state(mmvae_flax_to_torch(_np(jw.params))), lr, 9)
    _close(tw.predict(x1), jw.predict(x1), rtol=1e-4, atol=1e-4)
    for m, data in ((1, x1), (2, x2)):
        _close(tw.encode(data, m), jw.encode(data, m), rtol=1e-4, atol=1e-4)
    _close(tw.score(x1, x2), jw.score(x1, x2), rtol=1e-4)


def test_mmvae_matching_matches_jax():
    x1, x2, net, params, _ = _case(True)
    jw = JM.MMVAE(z_dim=Z, seed=0, reference_protocol=True)
    jw.net, jw.params = net, params
    tw = TM.MMVAE(z_dim=Z, seed=0, reference_protocol=True, device="cpu")
    tw.net = tw._make_net(x1.shape[1], x2.shape[1])
    tw.net.load_state_dict(mmvae_flax_to_torch(_np(params)))
    te1, te2 = x1[180:], x2[180:]
    got, want = tw.predict_matching(te1, te2), jw.predict_matching(te1, te2)
    assert got.shape == (60, 60) and np.array_equal(got, want)
    assert tw.score_matching(got) == jw.score_matching(want)
    assert np.array_equal(tw.predict_matching(te1, te2, metric="l1"),
                          jw.predict_matching(te1, te2, metric="l1"))


def test_mmvae_reference_helpers():
    counts, _, _ = multimodal_pair(n=30, g=12)
    counts[3] = 0
    _close(T.protein_preprocessing(counts), J.protein_preprocessing(counts))
    _close(T.atac_preprocessing(torch.from_numpy(counts)), J.atac_preprocessing(counts))
    assert T.rna_preprocessing(counts) is counts
    for name in ("eta", "eps", "log2", "log2pi", "logceilc", "logfloorc"):
        assert getattr(T.Constants, name) == pytest.approx(getattr(J.Constants, name), rel=1e-15)
