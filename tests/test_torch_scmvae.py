"""Port parity for scMVAE and what it stands on: the GMM losses and
``cdisttf``, optax's ``adamw`` with its ``eps``, the diagonal Gaussian
mixture against scikit-learn's, the reference-named helpers, the net
(Bernoulli, Poisson, Gaussian and ZINB second modality; ``model`` 0-3; the
GMM and the plain KL penalty) forward with JAX's normals and dropout masks
after the weight transfer, its ELBO terms, loss, gradients and one AdamW
step, ``init_gmm_params``, and a fit with the GMM prior fixed from the same
parameters on JAX's batch orders and normals against JAX's ``_fit_epochs`` (dance_tpu_torch.modules.
multi_modality.joint_embedding.scmvae, dance_tpu_torch.ops.mixture).

Inputs are made with numpy from a seed (``torch_cases.multimodal_pair``:
240 cells x 100 genes of raw counts <-> 25 proteins, given as
``expm1(|x2|)`` as the JAX benchmark does); the flax weights are copied into
the port (``scmvae_flax_to_torch``); JAX's normals and orders, recomputed
here from its keys by its own expressions (scmvae.py:206-217, :367-386,
:406), and its dropout masks (flax's ``Dropout_{i}`` outputs, captured) are
handed over through patched ``scMVAE._noise``, ``scMVAE._mask`` and
``epoch_batches``. Tolerances: losses, ELBO terms and forward values at
rtol 1e-5 (atol 1e-6 of each value's largest); gradients within 1e-4 of
each tensor's largest value, 1e-3 for the Poisson second modality (its
``x / rate`` term divides by rates the last layer computes near 0 by
cancellation: in float32 JAX's gradients are 1.3e-4 and the port's 2.6e-4
of the largest from the float64 ones); weights after one AdamW step on
JAX's gradients at rtol 1e-5; the port's AdamW at eps 0.01 within 1e-7 of
optax's after one step and 1e-5 over 1,200 (float32 rounding); the mixture's parameters within 1e-6
(relative to each array's largest) of sklearn's after EM from the same
start; ``init_gmm_params`` at rtol 1e-5; the fit's per-epoch losses and
embedding at rtol 1e-4, its weights by the ``torch_cases.assert_weights``
rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import sklearn.mixture
import torch

from dance_tpu.modules.multi_modality.joint_embedding import scmvae as J
from dance_tpu.utils import loss as JL
from dance_tpu.utils.batch import epoch_batches as jax_epoch_batches
from dance_tpu_torch.modules.multi_modality.joint_embedding import scMVAE
from dance_tpu_torch.modules.multi_modality.joint_embedding import scmvae as T
from dance_tpu_torch.ops import mixture as M
from dance_tpu_torch.utils import ari
from dance_tpu_torch.utils import loss as TL
from dance_tpu_torch.utils.optim import adamw
from dance_tpu_torch.utils.params import scmvae_flax_to_torch
from test_torch_dcca import random_flax_params
from test_torch_vae_babel import _close, _grads_close, _np, _numpy_state, step_with
from torch_cases import assert_weights, multimodal_pair

Z, K = 6, 3
WIDTHS = dict(encoder_1=[0, 16], encoder_2=[0, 16], encoder_l=[0, 8], decoder_share=[0, 12, 20],
              share_hidden=12, decoder_1=[0, 16], decoder_2=[0, 16], z_dim=Z, n_centroids=K)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rel_close(got, want, rtol=1e-5):
    want = np.asarray(want)
    _close(got, want, rtol=rtol, atol=1e-6 * float(np.abs(want).max(initial=1e-30)))


def _inputs(type2="Bernoulli"):
    counts, prot, types = multimodal_pair()
    x2 = np.expm1(np.abs(prot))
    return counts, ((x2 > 0).astype(np.float32) if type2 == "Bernoulli" else x2), types


@pytest.mark.parametrize("name", ["gmm_nll", "GMM_loss", "cdisttf"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(7)
    z, mu, logvar = (rng.standard_normal((40, Z)).astype(np.float32) for _ in range(3))
    if name == "gmm_nll":
        pi = rng.dirichlet(np.ones(K)).astype(np.float32)
        mu_k, lv_k = (rng.standard_normal((K, Z)).astype(np.float32) for _ in range(2))
        args = (z, pi, mu_k, lv_k)
    elif name == "GMM_loss":
        gamma = rng.dirichlet(np.ones(K), 40).astype(np.float32)
        mu_c = rng.standard_normal((Z, K)).astype(np.float32)
        var_c = rng.uniform(0.3, 2.0, (Z, K)).astype(np.float32)
        pi = rng.dirichlet(np.ones(K), 40).astype(np.float32)
        args = (gamma, (mu_c, var_c, pi), (mu, logvar))
    else:
        args = (z, mu[:25])
    to_t = lambda a: tuple(map(to_t, a)) if isinstance(a, tuple) else _t(a)  # noqa: E731
    _rel_close(getattr(TL, name)(*map(to_t, args)), getattr(JL, name)(*args))


@jax.jit
def _optax_adamw_run(p0, grads):
    """optax's ``adamw(1e-3, weight_decay=1e-6, eps=0.01)`` over the gradient
    sequence, as one scan: the weights after each step."""
    tx = optax.adamw(1e-3, weight_decay=1e-6, eps=0.01)

    def step(carry, g):
        p, state = carry
        updates, state = tx.update(g, state, p)
        p = optax.apply_updates(p, updates)
        return (p, state), p

    return jax.lax.scan(step, (p0, tx.init(p0)), grads)[1]


def test_adamw_eps_against_optax_over_1200_steps():
    """scMVAE's ``adamw(lr, weight_decay=1e-6, eps=0.01)``: eps outside the
    root, the decay on every weight, as optax's, on a fixed sequence of
    heavy-tailed gradients. The two float32 runs part by rounding only:
    ~5e-8 of the largest weight after a step, ~1e-6 after 1,200 (each of
    them is 1.3-1.8e-6 from the same rule run in float64)."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((7, 5)).astype(np.float32)
    grads = (rng.standard_normal((1200, 7, 5))
             * np.exp(rng.normal(0, 1, (1200, 1, 1)))).astype(np.float32)
    want = np.asarray(_optax_adamw_run(jnp.asarray(p0), jnp.asarray(grads)))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, got = adamw([tp], 1e-3, weight_decay=1e-6, eps=0.01), []
    for g in grads:
        tp.grad = torch.from_numpy(g)
        opt.step()
        got.append(tp.detach().numpy().copy())
    gap = np.abs(np.stack(got) - want).max(axis=(1, 2)) / np.abs(want).max()
    assert gap[0] <= 1e-7 and gap.max() <= 1e-5, (gap[0], gap.max())


def _blobs(separated: bool, seed=0):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((4, 5)) * (8.0 if separated else 1.0)
    labels = rng.integers(0, 4, 400)
    return centres[labels] + rng.standard_normal((400, 5)) * rng.uniform(0.3, 1.5, 5), labels


@pytest.mark.parametrize("separated", [True, False])
def test_mixture_em_matches_sklearn(separated):
    """From the port's k-means start handed to sklearn (``weights_init``,
    ``means_init``, ``precisions_init``): the same EM."""
    x, _ = _blobs(separated)
    xt = torch.from_numpy(x)
    resp = M.initial_responsibilities(xt, 4, seed=0)
    nk, means, cov = M.estimate_gaussian_parameters(xt, resp, 1e-4)
    sk = sklearn.mixture.GaussianMixture(
        4, covariance_type="diag", reg_covar=1e-4, weights_init=(nk / len(x)).numpy(),
        means_init=means.numpy(), precisions_init=1.0 / cov.numpy()).fit(x)
    gm = M.GaussianMixture(4, reg_covar=1e-4, random_state=0, device="cpu").fit(x)
    assert gm.means_.dtype == torch.float64 and gm.means_.device.type == "cpu"
    assert (gm.n_iter_, gm.converged_) == (sk.n_iter_, sk.converged_)
    assert gm.lower_bound_ == pytest.approx(sk.lower_bound_, rel=1e-9)
    for got, want in ((gm.weights_, sk.weights_), (gm.means_, sk.means_),
                      (gm.covariances_, sk.covariances_),
                      (gm.precisions_cholesky_, sk.precisions_cholesky_)):
        _close(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
    assert np.array_equal(gm.predict(x).numpy(), sk.predict(x))


def test_mixture_labels_match_sklearn_own_fit():
    """On well-separated data the port's fit (its own k-means start) labels
    the points as sklearn's own fit does."""
    x, truth = _blobs(True, seed=3)
    gm = M.GaussianMixture(4, reg_covar=1e-4, random_state=0, device="cpu").fit(x)
    sk = sklearn.mixture.GaussianMixture(4, covariance_type="diag", reg_covar=1e-4,
                                         random_state=0).fit(x)
    labels = gm.predict(x).numpy()
    assert ari(labels, sk.predict(x)) == 1.0 and ari(labels, truth) == 1.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            M.GaussianMixture(2).fit(x)
    with pytest.raises(ValueError, match="variance"):
        M.GaussianMixture(2, reg_covar=0.0, device="cpu").fit(np.ones((6, 2)))


def test_reference_helpers_match_jax():
    rng = np.random.default_rng(2)
    mus, lvs = (rng.standard_normal((3, 10, Z)).astype(np.float32) for _ in range(2))
    for got, want in zip(T.product_of_experts(_t(mus), _t(lvs)), J.product_of_experts(mus, lvs)):
        _rel_close(got, want)
    for got, want in zip(T.ProductOfExperts()(mus, lvs), J.ProductOfExperts()(mus, lvs)):
        _rel_close(got, want)
    for got, want in zip(T.prior_expert((2, 3)), J.prior_expert((2, 3))):
        assert got.shape == want.shape and not got.any()
    counts, x2, _ = _inputs("Possion")
    for got, want in zip(T.calculate_log_library_size(counts),
                         J.calculate_log_library_size(counts)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    p = rng.uniform(0.01, 0.99, x2.shape).astype(np.float32)
    for fn in ("_bernoulli_nll", "_poisson_nll", "_masked_mse"):
        _rel_close(getattr(T, fn)(_t(p), _t(x2)), getattr(J, fn)(p, x2))
    a, b, c, d = (rng.standard_normal((10, 1)).astype(np.float32) for _ in range(4))
    _rel_close(T._normal_kl(_t(a), _t(b), _t(c), _t(d ** 2)), J._normal_kl(a, b, c, d ** 2))
    net = T.build_multi_layers([5, 4, 3], generator=torch.Generator().manual_seed(0))
    assert [tuple(m.weight.shape) for m in net if hasattr(m, "weight")] == [(4, 5), (3, 4)]


def _flax_net(type2, model, x1, x2, seed=1, droprate=0.1):
    net = J._scMVAENet(dim1=x1.shape[1], dim2=x2.shape[1], z_dim=Z, hidden1=(16,), hidden2=(16,),
                       hidden_l=(8,), decoder_share=(12, 20), share_hidden=12,
                       dec1_hidden=(16,), dec2_hidden=(16,), type2=type2, n_centroids=K,
                       model=model, droprate=droprate)
    params = random_flax_params(net, x1[:1], x2[:1], seed=seed)
    rng = np.random.default_rng(seed)  # a GMM prior away from flax's zeros
    params = {**params, "pi_logit": jnp.asarray(rng.standard_normal(K), jnp.float32),
              "mu_c": jnp.asarray(rng.standard_normal((Z, K)), jnp.float32),
              "logvar_c": jnp.asarray(rng.normal(0, 0.3, (Z, K)), jnp.float32)}
    return net, params


class _Capturing:
    """A flax module whose plain ``apply`` also captures the intermediates
    (flax's dropout outputs among them) and keeps its outputs and them in
    ``seen``, inside the trace of the caller's function."""

    def __init__(self, net):
        self.net, self.seen = net, []

    def __getattr__(self, name):
        return getattr(self.net, name)

    def apply(self, variables, *args, method=None, **kwargs):
        if method is not None:
            return self.net.apply(variables, *args, method=method, **kwargs)
        out, st = self.net.apply(variables, *args, capture_intermediates=True,
                                 mutable=["intermediates"], **kwargs)
        self.seen += [out, st]
        return out


def _dropout_paths(type2):
    """flax's dropout layers in the port's call order."""
    paths = [("enc1", "_MLP_0", 1), ("enc2", "_MLP_0", 1), ("enc_l1", "_MLP_0", 1),
             ("share", None, 2), ("dec1", "_MLP_0", 1)]
    return paths + ([("enc_l2", "_MLP_0", 1)] if type2 == "ZINB" else []) + [("dec2", "_MLP_0", 1)]


def _masks(st, type2):
    inter, masks = st["intermediates"], []
    for block, sub, count in _dropout_paths(type2):
        scope = inter[block] if sub is None else inter[block][sub]
        masks += [torch.from_numpy(np.asarray(scope[f"Dropout_{i}"]["__call__"][0]) != 0)
                  for i in range(count)]
    return masks


def _normals(sk, rows, type2):
    """The normals JAX's ``__call__`` draws from a step's key (scmvae.py:210-217)."""
    rz, rl1, rl2 = jax.random.split(sk, 3)
    out = [jax.random.normal(rz, (rows, Z)), jax.random.normal(rl1, (rows, 1))]
    if type2 == "ZINB":
        out.append(jax.random.normal(rl2, (rows, 1)))
    return [torch.from_numpy(np.array(a)) for a in out]


@pytest.mark.parametrize("type2,model,penality", [("Bernoulli", 2, "GMM"), ("ZINB", 0, "GMM"),
                                                  ("Possion", 1, "GMM"),
                                                  ("Gaussian", 3, "Gaussian")])
def test_net_forward_terms_grads_and_adamw_step(type2, model, penality, monkeypatch):
    """One training step on 80 cells, dropout 0.1 on JAX's masks, KL weight
    0.4, scale factor 4: the forward, each ELBO term, the loss, every
    gradient (the GMM prior's included) and (the first case) the weights
    after AdamW at eps 0.01."""
    x1, x2, _ = _inputs(type2)
    rows = np.arange(0, 240, 3)
    bx1, bx2 = x1[rows], x2[rows]
    net, params = _flax_net(type2, model, x1, x2)
    jm = J.scMVAE(**WIDTHS, Type=type2, model=model, penality=penality)
    jm.net, jm._scale_factor = _Capturing(net), 4.0
    lib1 = J.calculate_log_library_size(bx1)
    lib2 = J.calculate_log_library_size(bx2) if type2 == "ZINB" else lib1
    sk = jax.random.key(11)

    def loss_fn(p):  # JAX's loss_fn of _epoch (scmvae.py:374-379), its forward captured
        jm.net.seen.clear()
        terms = jm._elbo_terms(p, bx1, bx2, *lib1, *lib2, sk, True)
        l1, l2, kl1, kl2, klz = terms
        return jnp.mean(4.0 * l1 + l2 + kl1 + kl2 + 0.4 * klz), (terms, *jm.net.seen)

    (jloss, (jterms, jout, st)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    tnet = T._scMVAENet(x1.shape[1], x2.shape[1], Z, (16,), (16,), (8,), (12, 20), 12, (16,),
                        (16,), type2, K, model)
    tnet.load_state_dict(scmvae_flax_to_torch(_np(params)))
    tw = scMVAE(**WIDTHS, Type=type2, model=model, penality=penality, device="cpu")
    masks = iter(_masks(st, type2) * 3)
    monkeypatch.setattr(tw, "_mask", lambda shape, gen: next(masks))
    drop = lambda h: T.inverted_dropout(h, tw._mask(h.shape, None), 0.1)  # noqa: E731
    noise = _normals(sk, len(rows), type2)
    t1, t2 = _t(bx1), _t(bx2)
    tlib1, tlib2 = tuple(map(_t, lib1)), tuple(map(_t, lib2))
    # the embedding: the posterior mean, without dropout
    _rel_close(tnet.embed(_t(x1), _t(x2)).detach(),
               jax.jit(lambda p: net.apply({"params": p}, x1, x2, method=net.embed))(params))
    tout = tnet(t1, t2, noise, drop)
    assert set(tout) == set(jout)
    for key in jout:
        _rel_close(tout[key].detach(), jout[key])
    for got, want in zip(T.elbo_terms(tnet, t1, t2, tlib1, tlib2, noise, drop, penality),
                         jterms):
        _rel_close(got.detach(), want)
    loss = T.scmvae_loss(tnet, t1, t2, tlib1, tlib2, 0.4, 4.0, noise, drop, penality)
    loss.backward()
    _close(loss.detach(), jloss)
    if type2 == "Possion":  # x / rate, with rates near 0 from the last layer's cancellation
        want = scmvae_flax_to_torch(_np(jgrads))
        for name, p in tnet.named_parameters():
            scale = float(want[name].abs().max())
            assert float((p.grad - want[name]).abs().max()) <= 1e-3 * scale, name
    else:
        _grads_close(tnet, jgrads, scmvae_flax_to_torch)
    if type2 == "Bernoulli":  # the update rule, the same for every tree
        opt = adamw(tnet, 1e-3, weight_decay=1e-6, eps=0.01)
        step_with(opt, tnet, jgrads, scmvae_flax_to_torch)
        tx = optax.adamw(1e-3, weight_decay=1e-6, eps=0.01)
        step = jax.jit(lambda p, g: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))
        want = scmvae_flax_to_torch(_np(step(params, jgrads)))
        for name, p in tnet.named_parameters():
            _close(p.detach(), want[name], name=name)


class _SeededMixture(sklearn.mixture.GaussianMixture):
    """sklearn's mixture started from the port's k-means responsibilities on
    the same latent, in float64 (the port's EM is float64)."""

    def fit(self, X, y=None):
        x = torch.from_numpy(np.asarray(X, np.float64))
        resp = M.initial_responsibilities(x, self.n_components, self.random_state)
        nk, means, cov = M.estimate_gaussian_parameters(x, resp, self.reg_covar)
        self.weights_init = (nk / len(x)).numpy()
        self.means_init, self.precisions_init = means.numpy(), 1.0 / cov.numpy()
        return super().fit(x.numpy())


def test_init_gmm_params_matches_jax(monkeypatch):
    x1, x2, _ = _inputs()
    net, params = _flax_net("Bernoulli", 2, x1, x2)
    jm = J.scMVAE(**WIDTHS, seed=0)
    jm.net, jm.params, jm._x1, jm._x2 = net, params, jnp.asarray(x1), jnp.asarray(x2)
    monkeypatch.setattr(sklearn.mixture, "GaussianMixture", _SeededMixture)
    jm.init_gmm_params()
    tw = scMVAE(**WIDTHS, seed=0, device="cpu")
    tw.net = T._scMVAENet(x1.shape[1], x2.shape[1], Z, (16,), (16,), (8,), (12, 20), 12, (16,),
                          (16,), "Bernoulli", K)
    tw.net.load_state_dict(scmvae_flax_to_torch(_np(params)))
    tw._x1, tw._x2 = _t(x1), _t(x2)
    tw.init_gmm_params()
    assert tw.gmm.converged_ and tw.gmm.means_.dtype == torch.float64
    for name in ("mu_c", "logvar_c", "pi_logit"):
        _rel_close(getattr(tw.net, name).detach(), jm.params[name])


def test_scmvae_fit_matches_jax(monkeypatch):
    """Three epochs (4 wrap-padded steps of 64 each), dropout 0, the rate
    stepped every 2 epochs and the KL weight annealed over 2, from the same
    weights and GMM prior, against JAX's ``_fit_epochs`` (scmvae.py:391):
    each epoch's loss, the lowest-loss epoch's weights and the embedding."""
    x1, x2, types = _inputs()
    epochs, lr, final_rate = 3, 2e-3, 1.5e-3
    net, params = _flax_net("Bernoulli", 2, x1, x2, droprate=0.0)
    jm = J.scMVAE(**WIDTHS, drop_rate=0.0, seed=0)
    jm.net, jm._batch_size, jm._scale_factor = net, 64, 4.0
    jm._tx = optax.inject_hyperparams(optax.adamw)(learning_rate=lr, weight_decay=1e-6, eps=0.01)
    x1j, x2j = jnp.asarray(x1), jnp.asarray(x2)
    lib = jnp.log(jnp.maximum(x1j.sum(1), 1e-7))  # JAX's fit (scmvae.py:458-464)
    libm, libv = jnp.full((240, 1), lib.mean()), jnp.full((240, 1), lib.var())
    key11 = jax.random.fold_in(jax.random.key(0), 11)
    best, _, jlosses = jm._fit_epochs(params, jm._tx.init(params), x1j, x2j, libm, libv, libm,
                                      libv, key11, jnp.float32(lr), jnp.float32(final_rate),
                                      epochs, 2, 2)
    jm.params, jm._x1, jm._x2 = best, x1j, x2j

    orders, normals = [], []
    for e in range(1, epochs + 1):  # JAX's draws (scmvae.py:367-386, :406)
        ke = jax.random.fold_in(key11, e)
        idx = np.array(jax_epoch_batches(jax.random.fold_in(ke, 1), len(x1), 64))
        orders.append(torch.from_numpy(idx))
        skey = jax.random.fold_in(ke, 2)
        for _ in idx:
            skey, sk = jax.random.split(skey)
            normals += _normals(sk, 64, "Bernoulli")
    tw = scMVAE(**WIDTHS, drop_rate=0.0, seed=0, device="cpu")
    make, state = tw._make_net, scmvae_flax_to_torch(_np(params))

    def made(*args):
        made_net = make(*args)
        made_net.load_state_dict(state)
        return made_net
    it_o, it_n = iter(orders), iter(normals)
    monkeypatch.setattr(tw, "_make_net", made)
    monkeypatch.setattr(tw, "init_gmm_params", lambda: None)  # the prior is in the weights
    monkeypatch.setattr(tw, "_noise", lambda shape, gen: next(it_n))
    monkeypatch.setattr(T, "epoch_batches", lambda gen, n, bs: next(it_o))
    tw.fit(x1, x2, epochs=epochs, lr=lr, final_rate=final_rate, adjust_epoch=2, anneal_epoch=2)
    assert next(it_o, None) is None and next(it_n, None) is None  # every draw used
    got = np.array([h["loss"] for h in tw.history])
    _close(got, jlosses, rtol=1e-4)
    assert [h["lr"] for h in tw.history] == pytest.approx([2e-3, 1.8e-3, 1.8e-3])
    assert [h["kl_weight"] for h in tw.history] == [0.5, 1.0, 1.0]
    assert tw.best_loss == got.min()
    assert_weights({k: v.numpy() for k, v in tw.net.state_dict().items()},
                   _numpy_state(scmvae_flax_to_torch(_np(best))), lr, epochs * 4)
    _close(tw.predict(), jm.predict(), rtol=1e-4, atol=1e-4)
    # inputs given are binarised for the Bernoulli decoder
    _close(tw.predict(x1, x2 * 3), jm.predict(x1, x2 * 3), rtol=1e-4, atol=1e-4)
    scores, emb = tw.score(None, types, return_pred=True)
    assert tw.score(None, types) == scores["dance_nmi"] and emb.shape == (240, Z)


def test_scmvae_defaults_and_device():
    tw = scMVAE(device="cpu")
    assert (tw.z_dim, tw.hidden1, tw.decoder_share, tw.Type, tw.n_centroids, tw.penality,
            tw.model, tw.droprate) == (16, (128,), (128, 256), "Bernoulli", 19, "GMM", 2, 0.1)
    with pytest.raises(ValueError, match="Type"):
        T._scMVAENet(4, 3, type2="Poisson")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            scMVAE()
