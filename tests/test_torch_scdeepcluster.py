"""Port parity for scDeepCluster and scDCC (dance_tpu_torch.modules.
single_modality.clustering.scdeepcluster / scdcc), the ZINB autoencoder
(dance_tpu_torch.nn.zinb_ae), optax's AMSGrad (dance_tpu_torch.utils.optim)
and torch's Adadelta as optax's, the clustering fronts and the pairwise
constraints (dance_tpu_torch.transforms.preprocess).

Inputs are made with numpy from a seed and handed to both packages; flax
weights are copied into the torch model (zinb_ae_flax_to_torch), and JAX's
batch orders and denoising normals are handed to the port (through a patched
``epoch_batches`` and ``ScDeepCluster._noise``). JAX's side runs its
step-level functions (``_pretrain_epoch``, ``_cluster_epoch``,
``_constraint_step``) with the keys its ``fit`` would draw, not its
whole-fit scans. Tolerances: the optimizers over 1,200 steps at 1e-6 of the
largest weight; forwards at rtol 1e-5; losses at rtol 1e-5 and gradients at
1e-5 of the largest; one optimizer step at 1e-5; 2 + 2-epoch fits' losses at
1e-4, their weights within two learning rates a step and all but 0.1 % at
rtol 1e-4, their ``q`` at 1e-4; the fronts exactly, gene order included.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from dance_tpu.data import AnnData, Data
from dance_tpu.modules.single_modality.clustering.scdcc import ScDCC as JScDCC
from dance_tpu.modules.single_modality.clustering.scdeepcluster import (
    ScDeepCluster as JScDeepCluster)
from dance_tpu.nn.zinb_ae import ZINBAutoencoder as JZINBAutoencoder
from dance_tpu.transforms.preprocess import generate_random_pair as jgenerate_random_pair
from dance_tpu.utils.batch import epoch_batches as jepoch_batches
from dance_tpu.utils.loss import cluster_kl_loss as jkl
from dance_tpu.utils.loss import soft_assign as jsoft_assign
from dance_tpu.utils.loss import zinb_nll as jzinb_nll
from dance_tpu_torch.modules.single_modality.clustering import (ScDCC, ScDeepCluster,
                                                                scdcc_preprocess,
                                                                scdeepcluster_preprocess)
from dance_tpu_torch.modules.single_modality.clustering import scdeepcluster as tsdc
from dance_tpu_torch.modules.single_modality.clustering.scdeepcluster import euclidean_dist
from dance_tpu_torch.nn.zinb_ae import DispAct, MeanAct, TorchDense, ZINBAutoencoder
from dance_tpu_torch.ops.cluster import KMeansResult
from dance_tpu_torch.transforms import generate_random_pair
from dance_tpu_torch.utils.loss import cluster_kl_loss, soft_assign, zinb_nll
from dance_tpu_torch.utils.optim import amsgrad
from dance_tpu_torch.utils.params import zinb_ae_flax_to_torch
from torch_cases import assert_weights, typed_counts

LAYERS = dict(encodeLayer=(16, 8), decodeLayer=(8, 16))


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _state(tree) -> dict:
    return {k: v.numpy() for k, v in zinb_ae_flax_to_torch(_np_tree(tree)).items()}


def _grads(model) -> dict:
    return {k: p.grad.numpy() for k, p in model.named_parameters() if p.grad is not None}


def _close_grads(got: dict, want: dict):
    scale = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-5 * scale, err_msg=k)


# -- optimizers --------------------------------------------------------------

def _trajectories(jtx, opt_cls, kw, steps=1200, seed=0):
    """The weights after each of ``steps`` updates on the same fixed gradient
    sequence (heavy-tailed scales, so that the second moment's max moves)."""
    rng = np.random.default_rng(seed)
    p0 = rng.standard_normal((7, 5)).astype(np.float32)
    grads = (rng.standard_normal((steps, 7, 5))
             * np.exp(rng.normal(0, 1, (steps, 1, 1)))).astype(np.float32)
    p, state, update = jnp.asarray(p0), jtx.init(jnp.asarray(p0)), jax.jit(jtx.update)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = opt_cls([tp], **kw)
    want, got = [], []
    for g in grads:
        u, state = update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, u)
        tp.grad = torch.from_numpy(g.copy())
        opt.step()
        want.append(np.asarray(p))
        got.append(tp.detach().numpy().copy())
    return np.stack(got), np.stack(want)


@pytest.mark.parametrize("name", ["amsgrad", "torch_amsgrad", "adadelta"])
def test_optimizers_against_optax_over_1200_steps(name):
    """The port's ``amsgrad`` follows optax's AMSGrad, which keeps the max of
    the bias-corrected second moment; torch's ``Adam(amsgrad=True)`` keeps the
    max of the raw one and leaves it from step 2 on. torch's Adadelta at eps
    1e-6 is optax's."""
    jtx, opt_cls, kw = {
        "amsgrad": (optax.amsgrad(1e-3), amsgrad, dict(lr=1e-3)),
        "torch_amsgrad": (optax.amsgrad(1e-3), torch.optim.Adam, dict(lr=1e-3, amsgrad=True)),
        "adadelta": (optax.adadelta(1.0, rho=0.95), torch.optim.Adadelta,
                     dict(lr=1.0, rho=0.95, eps=1e-6)),
    }[name]
    got, want = _trajectories(jtx, opt_cls, kw)
    gap = np.abs(got - want).max(axis=(1, 2)) / np.abs(want).max()
    if name == "torch_amsgrad":
        assert gap[0] <= 1e-6 and gap.max() > 1e-3, gap.max()
    else:
        assert gap.max() <= 1e-6, gap.max()


def test_amsgrad_skips_parameters_without_gradients():
    a, b = (torch.nn.Parameter(torch.ones(3)) for _ in range(2))
    opt = amsgrad([a, b], lr=0.1)
    a.grad = torch.ones(3)
    opt.step()
    assert torch.all(a < 1) and torch.all(b == 1) and b not in opt.state


# -- the autoencoder -----------------------------------------------------------

def _jax_ae(x, z_dim=4, sigma=1.0, seed=0):
    jae = JZINBAutoencoder(input_dim=x.shape[1], z_dim=z_dim, encode_layers=(16, 8),
                           decode_layers=(8, 16), sigma=sigma)
    return jae, jae.init(jax.random.key(seed), jnp.asarray(x[:1]))["params"]


def _torch_ae(x, params, z_dim=4, sigma=1.0):
    ae = ZINBAutoencoder(x.shape[1], z_dim, (16, 8), (8, 16), sigma=sigma)
    ae.load_state_dict(zinb_ae_flax_to_torch(_np_tree(params)))
    return ae


@pytest.mark.parametrize("sigma", [0.0, 2.5])
def test_zinb_autoencoder_forward_matches_jax(sigma):
    counts, _, _ = typed_counts(seed=1)
    x = np.log1p(counts)
    jae, params = _jax_ae(x, sigma=sigma)
    rng = jax.random.key(5)
    want = jae.apply({"params": params}, jnp.asarray(x), noise_rng=rng)
    ae = _torch_ae(x, params, sigma=sigma)
    noise = torch.from_numpy(np.array(jax.random.normal(rng, x.shape)))
    with torch.no_grad():
        got = ae(torch.from_numpy(x), noise=noise)
        z = ae.encode(torch.from_numpy(x))
    for name, g, w in zip(("z", "mean", "disp", "pi"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(z.numpy(), got[0].numpy())
    np.testing.assert_allclose(MeanAct()(z).numpy(), np.clip(np.exp(z.numpy()), 1e-5, 1e6),
                               rtol=1e-6)
    assert float(DispAct()(torch.tensor([-30.0]))) == np.float32(1e-4)


def test_torch_dense_is_linear_default_init():
    torch.manual_seed(3)
    ref = torch.nn.Linear(9, 5)
    dense = TorchDense(9, 5)
    dense.reset_parameters(torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(dense.weight.detach().numpy(), ref.weight.detach().numpy())
    np.testing.assert_array_equal(dense.bias.detach().numpy(), ref.bias.detach().numpy())


def test_zinb_ae_flax_to_torch_rejects_unknown_names():
    for bad in ({"encoder": {"Dense_0": {}}}, {"latent": {}},
                {"enc_mu": {"Dense_0": {"kernel": np.zeros((2, 2)), "bias": np.zeros(2)},
                            "Dense_1": {}}}):
        with pytest.raises(KeyError, match="unexpected"):
            zinb_ae_flax_to_torch(bad)


def test_pretrain_and_dec_steps_match_jax():
    """One step of each loss from the same weights and noise: the pretrain's
    ZINB NLL with AMSGrad, the DEC stage's KL + ZINB (gradients for ``mu``
    too) with Adadelta, and scDCC's constraint loss with Adam."""
    counts, _, names = typed_counts(seed=2)
    inp = scdeepcluster_preprocess(counts, names)
    x, xr = inp.x, inp.x_raw
    sf = (inp.n_counts / np.median(inp.n_counts)).astype(np.float32)
    jae, params = _jax_ae(x, sigma=2.5)
    rng = jax.random.key(6)
    noise = np.array(jax.random.normal(rng, x.shape))
    mu = np.random.default_rng(7).standard_normal((3, 4)).astype(np.float32)
    p = np.random.default_rng(8).dirichlet(np.ones(3), x.shape[0]).astype(np.float32)
    ml1, ml2, cl1, cl2 = (np.random.default_rng(9).integers(0, x.shape[0], 20)
                          for _ in range(4))
    jx, jxr, jsf = jnp.asarray(x), jnp.asarray(xr), jnp.asarray(sf)[:, None]

    def pt_loss(params):
        _, mean, disp, pi = jae.apply({"params": params}, jx, noise_rng=rng)
        return jzinb_nll(jxr, mean, disp, pi, scale_factor=jsf)

    def dec_loss(theta):
        params, mu = theta
        z, mean, disp, pi = jae.apply({"params": params}, jx, noise_rng=rng)
        return jkl(jnp.asarray(p), jsoft_assign(z, mu, 1.0)) + jzinb_nll(jxr, mean, disp, pi,
                                                                         scale_factor=jsf)

    jm = JScDCC(x.shape[1], 4, 3, sigma=2.5, **LAYERS)
    jm.model = jae

    def con_loss(params, mu):
        return jm._constraint_loss_impl(params, mu, jx, *(jnp.asarray(a) for a in
                                                            (ml1, ml2, cl1, cl2)))

    for stage in ("pretrain", "dec", "constraint"):
        ae = _torch_ae(x, params, sigma=2.5)
        tmu = torch.nn.Parameter(torch.from_numpy(mu.copy()))
        tx, txr, tsf = torch.from_numpy(x), torch.from_numpy(xr), torch.from_numpy(sf)[:, None]
        if stage == "pretrain":
            jl, jg = jax.jit(jax.value_and_grad(pt_loss))(params)
            tx_ = optax.amsgrad(1e-3)
            jnext = optax.apply_updates(params, tx_.update(jg, tx_.init(params))[0])
            mean, disp, pi = ae.noisy_heads(tx, torch.from_numpy(noise))
            loss = zinb_nll(txr, mean, disp, pi, scale_factor=tsf)
            opt = amsgrad(ae.parameters(), lr=1e-3)
        elif stage == "dec":
            jl, (jg, jgmu) = jax.jit(jax.value_and_grad(dec_loss))((params, jnp.asarray(mu)))
            tx_ = optax.adadelta(1.0, rho=0.95)
            state = tx_.init((params, jnp.asarray(mu)))
            jnext, jmu = optax.apply_updates((params, jnp.asarray(mu)), tx_.update(
                (jg, jgmu), state, (params, jnp.asarray(mu)))[0])
            z, mean, disp, pi = ae(tx, noise=torch.from_numpy(noise))
            loss = (cluster_kl_loss(torch.from_numpy(p), soft_assign(z, tmu, 1.0))
                    + zinb_nll(txr, mean, disp, pi, scale_factor=tsf))
            opt = torch.optim.Adadelta([*ae.parameters(), tmu], lr=1.0, rho=0.95, eps=1e-6)
        else:
            jl, (jg, jgmu) = jax.jit(jax.value_and_grad(con_loss, argnums=(0, 1)))(
                params, jnp.asarray(mu))
            tx_ = optax.adam(1e-3)
            jnext, jmu = optax.apply_updates((params, jnp.asarray(mu)), tx_.update(
                (jg, jgmu), tx_.init((params, jnp.asarray(mu))))[0])
            tm = ScDCC(x.shape[1], 4, 3, device="cpu", **LAYERS)
            tm.model, tm.mu = ae, tmu
            loss = tm.constraint_loss(tx, *(torch.from_numpy(a) for a in (ml1, ml2, cl1, cl2)))
            opt = torch.optim.Adam([*ae.parameters(), tmu], lr=1e-3)
        np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5, err_msg=stage)
        loss.backward()
        grads, want = _grads(ae), _state(jg)
        if stage == "constraint":  # the decoder is off this loss's path: no gradient
            off = {k: v for k, v in want.items() if k not in grads}
            assert off and all(k.startswith("dec") and not v.any() for k, v in off.items())
            want = {k: v for k, v in want.items() if k in grads}
        if stage != "pretrain":
            grads["mu"], want["mu"] = tmu.grad.numpy(), np.asarray(jgmu)
        _close_grads(grads, want)
        opt.step()
        for k, v in _state(jnext).items():
            np.testing.assert_allclose(ae.state_dict()[k].numpy(), v, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{stage} {k}")
        if stage != "pretrain":
            np.testing.assert_allclose(tmu.detach().numpy(), np.asarray(jmu), rtol=1e-5,
                                       atol=1e-5)


# -- whole fits from the same weights, batches and noise -----------------------

def _jax_fit(jm, inp, init, mu0, *, pt_epochs, pt_bs, dec_epochs, bs, pairs=None):
    """JAX's fit, step by step, with the keys its ``fit`` draws; returns what
    the port is held to and the batch orders and normals to hand it."""
    x, xr = jnp.asarray(inp.x), jnp.asarray(inp.x_raw)
    sf = jnp.asarray(inp.n_counts / np.median(inp.n_counts), jnp.float32)
    n, d = inp.x.shape
    pt_bs, bs = min(pt_bs, n), min(bs, n)
    orders, noises, pt_losses, dec_losses = [], [], [], []
    jm._pt_tx = optax.amsgrad(1e-3)
    params, opt = init, jm._pt_tx.init(init)
    for ek in jax.random.split(jax.random.split(jax.random.key(jm.seed))[1], pt_epochs):
        orders.append(jepoch_batches(ek, n, pt_bs))
        noises += [jax.random.normal(k, (pt_bs, d))
                   for k in jax.random.split(jax.random.fold_in(ek, 1), orders[-1].shape[0])]
        params, opt, loss = jm._pretrain_epoch(params, opt, x, xr, sf, ek, pt_bs)
        pt_losses.append(float(loss))
    mu = jnp.asarray(mu0)
    jm._cl_tx = optax.adadelta(1.0, rho=0.95)
    opt = jm._cl_tx.init((params, mu))
    if pairs is not None:
        jm._ctx = optax.adam(1e-3)
        c_state = jm._ctx.init((params, mu))
        pairs = [jnp.asarray(a, jnp.int32) for a in pairs]
    orders.append(jepoch_batches(jax.random.key(0), n, bs))
    key = jax.random.fold_in(jax.random.key(jm.seed), 13)
    for _ in range(dec_epochs):
        state = (params, mu, None) if pairs is None else (params, mu, None, None)
        q, z, p = jm._dec_refresh(state, {"x": x})
        key, ek = jax.random.split(key)
        noises += [jax.random.normal(k, (bs, d))
                   for k in jax.random.split(ek, orders[-1].shape[0])]
        params, mu, opt, loss = jm._cluster_epoch(params, mu, opt, x, xr, sf, p, ek, bs)
        dec_losses.append(float(loss))
        if pairs is not None:
            params, mu, c_state = jm._constraint_step(params, mu, c_state, x, *pairs)
    orders = [torch.from_numpy(np.array(o)).long() for o in orders]
    noises = [torch.from_numpy(np.array(e)) for e in noises]
    return dict(params=params, mu=np.asarray(mu), q=np.asarray(q), z=np.asarray(z),
                pt_losses=pt_losses, dec_losses=dec_losses, orders=orders, noises=noises)


def _hand_over(monkeypatch, ref):
    orders, noises = iter(ref["orders"]), iter(ref["noises"])
    monkeypatch.setattr(tsdc, "epoch_batches", lambda gen, n, bs: next(orders))
    monkeypatch.setattr(ScDeepCluster, "_noise", lambda self, shape, gen: next(noises))
    return orders, noises


def _check_fit(tm, ref, pt_epochs, dec_epochs, steps):
    np.testing.assert_allclose([h["loss"] for h in tm.pretrain_history], ref["pt_losses"],
                               rtol=1e-4)
    np.testing.assert_allclose([h["loss"] for h in tm.history], ref["dec_losses"], rtol=1e-4)
    got = {k: v.numpy() for k, v in tm.model.state_dict().items()}
    got["mu"], want = tm.mu.detach().numpy(), _state(ref["params"])
    want["mu"] = ref["mu"]
    assert_weights(got, want, 1e-3, steps)
    np.testing.assert_allclose(tm.q, ref["q"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tm.get_latent(), ref["z"], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tm.predict(), ref["q"].argmax(1))
    assert len(tm.pretrain_history) == pt_epochs and tm.dec_out["epoch"] == dec_epochs


def test_scdeepcluster_fit_matches_jax(monkeypatch):
    """2 pretrain epochs (batches of 64 over the cells, the last wrap-padded)
    and 2 DEC epochs on the fixed order from given centres, refreshing every
    epoch, no tolerance stop. The DEC stage's Adadelta at lr 1 steps a weight
    by up to ~sqrt(1e-6 + E[dx²]) / sqrt(E[g²]) g ≈ 4.5e-3 at first, so the
    two-lr bound is taken at 1e-3 over the 2 x 3 pretrain steps plus 2 x 3 x 5
    for the DEC steps."""
    counts, types, names = typed_counts(seed=3)
    inp = scdeepcluster_preprocess(counts, names, types)
    d = inp.x.shape[1]
    jm = JScDeepCluster(d, 4, sigma=1.0, seed=2, **LAYERS)
    init = jm.model.init(jax.random.key(11), jnp.asarray(inp.x[:1]))["params"]
    mu0 = np.random.default_rng(12).standard_normal((3, 4)).astype(np.float32)
    ref = _jax_fit(jm, inp, init, mu0, pt_epochs=2, pt_bs=64, dec_epochs=2, bs=64)
    orders, noises = _hand_over(monkeypatch, ref)
    tm = ScDeepCluster(d, 4, sigma=1.0, seed=2, device="cpu", **LAYERS)
    tm.model.load_state_dict(zinb_ae_flax_to_torch(_np_tree(init)))
    tm.fit(inp.inputs, n_clusters=3, init_centroid=mu0, y_pred_init=np.zeros(len(inp.labels), int),
           pt_epochs=2, pt_batch_size=64, epochs=2, batch_size=64, tol=0.0)
    assert next(orders, None) is None and next(noises, None) is None
    _check_fit(tm, ref, 2, 2, 6 + 30)


def test_scdcc_fit_matches_jax(monkeypatch):
    """scDCC: as scDeepCluster's, the k-means centres handed over, with
    constraint pairs from ``generate_random_pair`` and one Adam step on them
    after each DEC epoch."""
    counts, types, names = typed_counts(seed=4)
    inp = scdcc_preprocess(counts, names, types, n_top_genes=30)
    d = inp.x.shape[1]
    random.seed(5)
    np.random.seed(5)
    ml1, ml2, cl1, cl2, _ = generate_random_pair(inp.labels, range(len(inp.labels)), 60)
    jm = JScDCC(d, 4, 3, seed=1, **LAYERS)
    init = jm.model.init(jax.random.key(13), jnp.asarray(inp.x[:1]))["params"]
    mu0 = np.random.default_rng(14).standard_normal((3, 4)).astype(np.float32)
    ref = _jax_fit(jm, inp, init, mu0, pt_epochs=2, pt_bs=64, dec_epochs=2, bs=64,
                   pairs=(ml1, ml2, cl1, cl2))
    _hand_over(monkeypatch, ref)
    monkeypatch.setattr(tsdc, "kmeans", lambda z, k, **_: KMeansResult(
        torch.zeros(z.shape[0], dtype=torch.long), torch.from_numpy(mu0), torch.zeros(())))
    tm = ScDCC(d, 4, 3, seed=1, device="cpu", **LAYERS)
    assert tm.sigma == 2.5
    tm.model.load_state_dict(zinb_ae_flax_to_torch(_np_tree(init)))
    tm.fit(inp.inputs, ml_ind1=ml1, ml_ind2=ml2, cl_ind1=cl1, cl_ind2=cl2, pt_epochs=2,
           pt_batch_size=64, epochs=2, batch_size=64, tol=0.0)
    _check_fit(tm, ref, 2, 2, 6 + 30 + 2)
    assert tm.constraint_step is not None


def test_fit_with_labels_keeps_the_best_refresh_and_saves_the_pretrain(tmp_path):
    counts, types, names = typed_counts(seed=6)
    inp = scdeepcluster_preprocess(counts, names, types)
    path = str(tmp_path / "ae.pt")
    tm = ScDeepCluster(inp.x.shape[1], 4, device="cpu", pretrain_path=path, **LAYERS)
    tm.fit(inp.inputs, inp.labels, n_clusters=3, pt_epochs=1, epochs=4, tol=0.0)
    out = tm.dec_out
    assert np.isfinite(out["best_ari"])
    np.testing.assert_array_equal(tm.predict(), out["best_labels"].numpy())
    np.testing.assert_allclose(tm.predict_proba().sum(1), 1.0, rtol=1e-5)
    assert tm.score(None, inp.labels) == pytest.approx(out["best_ari"])
    other = ScDeepCluster(inp.x.shape[1], 4, device="cpu", seed=9, **LAYERS)
    other.load_pretrained(path)  # the pretrained weights, not the DEC stage's
    assert not torch.equal(other.model.enc_mu.weight, tm.model.enc_mu.weight)
    ScDCC(inp.x.shape[1], 4, 3, device="cpu", **LAYERS).fit(inp.inputs, pt_epochs=1, epochs=1)
    assert float(euclidean_dist(np.ones(3), np.zeros(3))) == 3.0


# -- the fronts ----------------------------------------------------------------

def _jax_front(counts, names, types, pipeline):
    adata = AnnData(X=counts.copy(), obs={"idx": np.arange(counts.shape[0]), "Group": types},
                    var=pd.DataFrame({"gidx": np.arange(len(names))}, index=names))
    data = Data(adata)
    pipeline(data)
    return data.data


@pytest.mark.parametrize("method", ["scdeepcluster", "scdcc"])
@pytest.mark.parametrize("sparse", [False, True])
def test_clustering_fronts_match_jax_pipelines(method, sparse):
    counts, types, names = typed_counts(200, 60, seed=7)
    x = sp.csr_matrix(counts) if sparse else counts
    if method == "scdcc":
        ad = _jax_front(x, names, types, JScDCC.preprocessing_pipeline(n_top_genes=25,
                                                                       log_level="WARNING"))
        got = scdcc_preprocess(x, names, types, n_top_genes=25)
        assert list(got.gene_names) == sorted(got.gene_names) and len(got.gene_names) == 25
    else:
        ad = _jax_front(x, names, types, JScDeepCluster.preprocessing_pipeline(
            log_level="WARNING"))
        got = scdeepcluster_preprocess(x, names, types)
    np.testing.assert_array_equal(got.gene_names, np.asarray(ad.var_names))
    np.testing.assert_array_equal(got.cells, ad.obs["idx"].to_numpy())
    np.testing.assert_array_equal(got.labels, ad.obs["Group"].to_numpy())
    raw = ad.raw.X.toarray() if sp.issparse(ad.raw.X) else ad.raw.X
    np.testing.assert_array_equal(got.x_raw, raw)
    np.testing.assert_array_equal(got.n_counts, ad.obs["n_counts"].to_numpy())
    np.testing.assert_allclose(got.x, ad.X, rtol=1e-6, atol=1e-6)


def test_generate_random_pair_matches_jax():
    labels = np.random.default_rng(8).integers(0, 3, 50)
    out = []
    for fn in (jgenerate_random_pair, generate_random_pair):
        random.seed(9)
        np.random.seed(9)
        out.append(fn(labels, range(50), 200, error_rate=0.1))
    for got, want in zip(*out):
        np.testing.assert_array_equal(got, want)
    ml1, ml2, cl1, cl2, errors = out[1]
    assert errors == 20 and len(ml1) + len(cl1) == 200
    assert (labels[ml1] == labels[ml2]).mean() < 1 and (labels[cl1] != labels[cl2]).mean() < 1
