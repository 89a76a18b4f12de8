"""Port parity for the blocks under the ZINB/DEC clustering family: the
losses (dance_tpu_torch.utils.loss), ``mean_act``/``disp_act``
(nn.zinb_ae), ``normalize_per_cell`` and ``scale`` (sc.pp), the epoch
batches (utils.batch), the DEC loop (nn.dec_loop), the pretrain mixins
(modules.base) and ``TAGConv`` (nn.gnn).

Inputs are made with numpy from a seed and handed to both packages; flax
weights are copied into the torch modules. The JAX BSR path runs its Pallas
kernel in interpret mode on the CPU. Tolerances: loss values at rtol 1e-5
(per element of the NB likelihoods also 8 ulps of the lgamma terms that
cancel in them), their gradients at rtol 1e-4 and atol 1e-6 (float32
transcendental functions in two libraries); preprocessing bit for bit or at float32 rounding; layer
outputs at rtol 1e-5 (sums in another order); the DEC loop's bookkeeping
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.special import gammaln

from dance_tpu.data import AnnData
from dance_tpu.nn import zinb_ae as jzinb
from dance_tpu.nn.dec_loop import run_dec_loop as jrun_dec_loop
from dance_tpu.nn.gnn import TAGConv as JTAGConv
from dance_tpu.ops import pallas_kernels as jpk
from dance_tpu.ops.sparse import csr_from_scipy as jcsr_from_scipy
from dance_tpu.sc import pp as jpp
from dance_tpu.utils.batch import epoch_batches as jepoch_batches
from dance_tpu.utils import loss as jloss
from dance_tpu.utils.loss import target_distribution as jtarget
from dance_tpu_torch.modules.base import BasePretrain, NNPretrain, TorchNNPretrain
from dance_tpu_torch.nn import dec_loop
from dance_tpu_torch.nn.gnn import TAGConv
from dance_tpu_torch.nn.zinb_ae import disp_act, mean_act
from dance_tpu_torch.ops import bsr as tbsr
from dance_tpu_torch.ops.sparse import csr_from_scipy
from dance_tpu_torch.sc import pp as tpp
from dance_tpu_torch.utils import loss as tloss
from dance_tpu_torch.utils.batch import epoch_batches, epoch_batches_masked
from dance_tpu_torch.utils.params import tagconv_flax_to_torch

VAL_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-6


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _zinb_inputs(seed=0, n=40, g=30):
    """Counts with many zeros; positive means and dispersions over several
    decades; dropout probabilities including ones next to 0 and 1."""
    rng = np.random.default_rng(seed)
    x = rng.poisson(rng.gamma(0.5, 2.0, (n, g))).astype(np.float32)
    mean = np.exp(rng.normal(0, 1.5, (n, g))).astype(np.float32)
    disp = np.exp(rng.normal(0, 1.5, (n, g))).astype(np.float32)
    pi = rng.random((n, g)).astype(np.float32)
    pi[0, :5] = [1e-7, 1e-4, 0.999, 1 - 1e-6, 0.5]
    pi[1, :3] = [0.0, 1e-7, 1 - 1e-7]
    sf = rng.gamma(4.0, 0.25, (n, 1)).astype(np.float32)
    return x, mean, disp, pi, sf


def _value_and_grads(jfn, tfn, args, argnums):
    """Value of ``fn(*args)`` (summed against fixed weights when it is not a
    scalar) and its gradients with respect to ``args[argnums]``, in both
    packages."""
    out = np.asarray(jfn(*[jnp.asarray(a) for a in args]))
    w = np.random.default_rng(99).random(out.shape).astype(np.float32) if out.ndim else None

    def jscalar(*a):
        v = jfn(*a)
        return jnp.sum(v * w) if w is not None else v

    jgrads = jax.grad(jscalar, argnums=argnums)(*[jnp.asarray(a) for a in args])
    targs = [torch.tensor(a, requires_grad=i in argnums) for i, a in enumerate(args)]
    tout = tfn(*targs)
    (tout * torch.from_numpy(w)).sum().backward() if w is not None else tout.backward()
    tgrads = [targs[i].grad.numpy() for i in argnums]
    return out, tout.detach().numpy(), [np.asarray(g) for g in jgrads], tgrads


def _close(name, got, want, rtol, atol):
    """``|got - want| <= atol + rtol |want|`` elementwise, ``atol`` a scalar or
    an array."""
    assert got.shape == want.shape and np.isfinite(got).all(), name
    err = np.abs(got.astype(np.float64) - want) - rtol * np.abs(want.astype(np.float64))
    worst = np.unravel_index(np.argmax(err - atol), err.shape) if err.ndim else ()
    assert np.all(err <= atol), (f"{name}: |{got[worst]} - {want[worst]}| over "
                                 f"{rtol} rel + {np.broadcast_to(atol, err.shape)[worst]} abs")


def _assert_matches(jfn, tfn, args, argnums, atol=0.0, grad_atol=GRAD_ATOL):
    """Values at ``VAL_RTOL`` (plus ``atol``), gradients at ``GRAD_RTOL`` plus
    ``grad_atol`` (one per gradient, or shared)."""
    want, got, jgrads, tgrads = _value_and_grads(jfn, tfn, args, argnums)
    _close("value", got, want, VAL_RTOL, atol)
    grad_atol = grad_atol if isinstance(grad_atol, (list, tuple)) else [grad_atol] * len(argnums)
    for i, (g, w, a) in enumerate(zip(tgrads, jgrads, grad_atol)):
        _close(f"grad {i}", g, w, GRAD_RTOL, a)


# --------------------------------------------------------------------------
# losses and activations
# --------------------------------------------------------------------------


def _lgamma_ulps(x, disp, reduce):
    """Per element, 8 float32 ulps of the lgamma terms that cancel in the NB
    likelihood, ``lgamma(θ) + lgamma(x + 1) − lgamma(x + θ)``, plus one: a
    value near 0 keeps the terms' rounding. (XLA's float32 lgamma is ~3 ulps
    off float64 at θ ~ 130 and 4.8e-7 off at 1; torch's closer.) The mean
    over elements needs no such floor."""
    if reduce:
        return 0.0
    x, disp = x.astype(np.float64), disp.astype(np.float64)
    terms = np.abs(gammaln(disp)) + np.abs(gammaln(x + 1)) + np.abs(gammaln(x + disp)) + 1.0
    return 8 * np.finfo(np.float32).eps * terms


@pytest.mark.parametrize("reduce", [True, False])
@pytest.mark.parametrize("scaled", [True, False])
def test_nb_nll_matches_jax(reduce, scaled):
    x, mean, disp, _, sf = _zinb_inputs(1)
    sf = sf if scaled else np.float32(1.0)
    _assert_matches(lambda x, m, d, s: jloss.nb_nll(x, m, d, s, reduce=reduce),
                    lambda x, m, d, s: tloss.nb_nll(x, m, d, s, reduce=reduce),
                    (x, mean, disp, sf), (1, 2), atol=_lgamma_ulps(x, disp, reduce))


@pytest.mark.parametrize("ridge_lambda", [0.0, 0.3])
@pytest.mark.parametrize("reduce", [True, False])
def test_zinb_nll_matches_jax(ridge_lambda, reduce):
    x, mean, disp, pi, sf = _zinb_inputs(2)
    assert (x < 1e-8).mean() > 0.2  # the zero case is well covered
    _assert_matches(
        lambda x, m, d, p, s: jloss.zinb_nll(x, m, d, p, s, ridge_lambda, reduce=reduce),
        lambda x, m, d, p, s: tloss.zinb_nll(x, m, d, p, s, ridge_lambda, reduce=reduce),
        (x, mean, disp, pi, sf), (1, 2, 3), atol=_lgamma_ulps(x, disp, reduce))


def test_loss_classes_match_jax():
    x, mean, disp, pi, sf = _zinb_inputs(3)
    jx, tx = [jnp.asarray(a) for a in (x, mean, disp, pi, sf)], \
        [torch.from_numpy(a) for a in (x, mean, disp, pi, sf)]
    np.testing.assert_allclose(tloss.NBLoss()(*tx[:3], tx[4]).numpy(),
                               np.asarray(jloss.NBLoss()(*jx[:3], jx[4])), rtol=VAL_RTOL)
    np.testing.assert_allclose(tloss.ZINBLoss(0.5)(*tx).numpy(),
                               np.asarray(jloss.ZINBLoss(0.5)(*jx)), rtol=VAL_RTOL)


@pytest.mark.parametrize("alpha", [1.0, 2.5])
def test_soft_assign_matches_jax(alpha):
    rng = np.random.default_rng(4)
    z, mu = rng.normal(0, 2, (50, 6)).astype(np.float32), rng.normal(0, 2, (5, 6)).astype(np.float32)
    _assert_matches(lambda z, m: jloss.soft_assign(z, m, alpha),
                    lambda z, m: tloss.soft_assign(z, m, alpha), (z, mu), (0, 1))


def test_target_distribution_and_kl_match_jax():
    rng = np.random.default_rng(5)
    q = rng.random((60, 7)).astype(np.float32) + 1e-3
    q /= q.sum(1, keepdims=True)
    q[0] = [1.0, 0, 0, 0, 0, 0, 0]  # a hard assignment: log(0 + EPS)
    _assert_matches(jloss.target_distribution, tloss.target_distribution, (q,), (0,))
    p = np.asarray(jloss.target_distribution(jnp.asarray(q)))
    _assert_matches(jloss.cluster_kl_loss, tloss.cluster_kl_loss, (p, q), (0, 1))


def test_dist_loss_matches_jax():
    # quarters: every product and sum of the Gram identity is exact in float32,
    # so the diagonal's d² is 0 in both (its rounding noise under a sqrt would
    # otherwise set the mean)
    z = np.random.default_rng(6).integers(-12, 13, (40, 5)).astype(np.float32) / 4
    z[1] = z[0]  # a zero distance off the diagonal too: sqrt(0 + 1e-10)
    _assert_matches(lambda z: jloss.dist_loss(z, 0.5, 20.0), lambda z: tloss.dist_loss(z, 0.5, 20.0),
                    (z,), (0,), grad_atol=_gram_ulps(z, 0.5, 20.0))


def _gram_ulps(z, lo, hi):
    """Per coordinate, 4 float32 ulps of the terms that cancel in the
    gradient of :func:`dist_loss` through the Gram identity: each pair's
    ``∂L/∂d²`` times ``2 z_i`` and ``2 z_j``, which cancel exactly only in
    exact arithmetic. The diagonal's ``∂L/∂d²`` is huge (a zero distance,
    1 / (2 sqrt(1e-10)) = 5e4 / n² of the exp terms), so in both packages this
    gradient carries float32 noise of ~10 % of its size here (JAX against
    torch: 1.7 of these ulps); the value is exact to rounding."""
    z = z.astype(np.float64)
    d2 = ((z[:, None] - z[None]) ** 2).sum(-1)
    d = np.sqrt(d2 + 1e-10)
    g = np.abs(np.exp(-(hi - d)) - np.exp(-(d - lo))) / (2 * d) / d.size
    g = g + g.T
    scale = 2 * (g.sum(1)[:, None] * np.abs(z) + g @ np.abs(z))
    return 4 * np.finfo(np.float32).eps * scale


@pytest.mark.parametrize("name", ["mean_act", "disp_act"])
def test_activations_match_jax(name):
    x = np.linspace(-30, 30, 241).astype(np.float32)  # both clamps reached
    jfn, tfn = getattr(jzinb, name), {"mean_act": mean_act, "disp_act": disp_act}[name]
    _assert_matches(jfn, tfn, (x,), (0,))


# --------------------------------------------------------------------------
# normalize_per_cell, scale
# --------------------------------------------------------------------------


def _expr(seed=7, n=30, g=20):
    rng = np.random.default_rng(seed)
    x = (rng.poisson(1.5, (n, g)) * (rng.random((n, g)) < 0.5)).astype(np.float32)
    x[4] = 0  # below min_counts
    x[:, 3] = 0  # a constant gene: std 0 -> 1
    return x


@pytest.mark.parametrize("target", [None, 1e4])
@pytest.mark.parametrize("sparse", [True, False])
def test_normalize_per_cell_matches_jax(sparse, target):
    x = _expr()
    xin = sp.csr_matrix(x) if sparse else x
    adata = AnnData(X=xin.copy(), obs={"i": np.arange(x.shape[0])})
    jpp.normalize_per_cell(adata, counts_per_cell_after=target)
    got, kept, n_counts = tpp.normalize_per_cell(xin, counts_per_cell_after=target)
    assert sp.issparse(got) == sparse and got.dtype == np.float32
    np.testing.assert_array_equal(np.nonzero(kept)[0], adata.obs["i"].to_numpy())
    np.testing.assert_array_equal(n_counts, adata.obs["n_counts"].to_numpy())
    want = adata.X.toarray() if sparse else adata.X
    np.testing.assert_array_equal(got.toarray() if sparse else got, want)


@pytest.mark.parametrize("zero_center,max_value", [(True, None), (True, 1.5), (False, 2.0)])
@pytest.mark.parametrize("sparse", [True, False])
def test_scale_matches_jax(sparse, zero_center, max_value):
    x = _expr(8)
    xin = sp.csr_matrix(x) if sparse else x
    adata = AnnData(X=xin.copy(), var={"g": np.arange(x.shape[1])})
    jpp.scale(adata, zero_center=zero_center, max_value=max_value)
    got, mean, std = tpp.scale(xin, zero_center=zero_center, max_value=max_value)
    np.testing.assert_array_equal(got, adata.X)
    np.testing.assert_array_equal(mean, adata.var["mean"].to_numpy())
    np.testing.assert_array_equal(std, adata.var["std"].to_numpy())
    assert std[3] == 1.0


# --------------------------------------------------------------------------
# epoch batches
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,bs", [(10, 4), (12, 4), (5, 8)])
def test_epoch_batches_wrap_pad_like_jax(n, bs):
    gen = torch.Generator().manual_seed(0)
    idx = epoch_batches(gen, n, bs).numpy()
    want = np.asarray(jepoch_batches(jax.random.key(0), n, bs))
    assert idx.shape == want.shape == (-(-n // min(bs, n)), min(bs, n))
    flat = idx.ravel()
    np.testing.assert_array_equal(np.sort(flat[:n]), np.arange(n))  # a permutation first
    np.testing.assert_array_equal(flat[n:], flat[:flat.size - n])   # then its head again


def test_epoch_batches_masked_zero_the_padding():
    idx, mask = epoch_batches_masked(torch.Generator().manual_seed(1), 10, 4)
    assert idx.shape == mask.shape == (3, 4) and mask.dtype == torch.float32
    np.testing.assert_array_equal(mask.numpy().ravel(), [1.0] * 10 + [0.0] * 2)
    np.testing.assert_array_equal(np.sort(idx.numpy().ravel()[:10]), np.arange(10))
    assert (idx.numpy().ravel()[10:] == 0).all()
    full, mask = epoch_batches_masked(None, 8, 4)
    assert full.shape == (2, 4) and bool(mask.all())


# --------------------------------------------------------------------------
# the DEC loop against JAX's on toy refresh/train functions
# --------------------------------------------------------------------------

N_TOY, K_TOY = 30, 3


def _toy_data(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (N_TOY, K_TOY)).astype(np.float32),
            rng.normal(0, 1, (N_TOY, K_TOY)).astype(np.float32),
            rng.integers(0, K_TOY, N_TOY))


def _jax_toy(base, drift):
    """State is an epoch counter t; q = softmax(base + t drift) drifts across
    the clusters; an epoch adds 1 to t and returns the sum of p as its loss."""
    def refresh(state, data):
        q = jax.nn.softmax(data["base"] + state * data["drift"], axis=1)
        return q, q * 2.0, jtarget(q)

    def train(state, p, key, data, batch_size):
        return state + 1.0, jnp.sum(p)

    return refresh, train, {"base": jnp.asarray(base), "drift": jnp.asarray(drift)}


def _torch_toy(base, drift):
    base, drift = torch.from_numpy(base), torch.from_numpy(drift)

    def refresh(state):
        q = torch.softmax(base + state * drift, dim=1)
        return q, q * 2.0, tloss.target_distribution(q)

    def train(state, p):
        return state + 1.0, torch.sum(p)

    return refresh, train


@pytest.mark.parametrize("epochs,tol,interval,labelled", [
    (9, -1.0, 1, True),    # never stops; best ARI over every epoch
    (10, -1.0, 3, True),   # refresh every third epoch
    (12, 0.2, 1, False),   # stops on tol before training
    (12, 0.2, 4, True),    # tol checked at the refreshes only
    (0, 0.1, 1, True),     # no epoch: the initial refresh
])
def test_run_dec_loop_matches_jax(epochs, tol, interval, labelled):
    base, drift, y = _toy_data(epochs + interval)
    drift *= 0.4
    labels0 = np.asarray(jnp.argmax(jnp.asarray(base), 1))
    jrefresh, jtrain, data = _jax_toy(base, drift)
    jstate, jout = jrun_dec_loop(jrefresh, jtrain, jnp.float32(0.0), data,
                                 jnp.asarray(labels0, jnp.int32), jnp.asarray(y, jnp.int32),
                                 jax.random.key(0), epochs, tol,
                                 n_true=K_TOY if labelled else 0, batch_size=1,
                                 update_interval=interval)
    trefresh, ttrain = _torch_toy(base, drift)
    tstate, tout = dec_loop.run_dec_loop(trefresh, ttrain, 0.0, labels0, y if labelled else None,
                                         epochs, tol, update_interval=interval)
    assert float(tstate) == float(jstate)
    assert tout["epoch"] == int(jout["epoch"]) and tout["stop"] == bool(jout["stop"])
    for key in ("q", "z", "best_q", "best_z"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]), rtol=1e-6,
                                   atol=1e-7, err_msg=key)
    for key in ("labels", "best_labels"):
        np.testing.assert_array_equal(np.asarray(tout[key]), np.asarray(jout[key]), err_msg=key)
    assert tout["delta"] == pytest.approx(float(jout["delta"]), abs=1e-7)
    assert tout["loss"] == pytest.approx(float(jout["loss"]), rel=1e-6)
    if labelled:
        assert tout["best_ari"] == pytest.approx(float(jout["best_ari"]), abs=1e-6)


def test_run_dec_loop_first_best_ari_wins():
    """Refreshes whose labels score the same ARI keep the first."""
    y = np.array([0, 0, 1, 1])
    qs = [torch.tensor([[1., 0], [1, 0], [0, 1], [0, 1]]),   # ARI 1
          torch.tensor([[0., 1], [0, 1], [1, 0], [1, 0]]),   # ARI 1 again (relabelled)
          torch.tensor([[1., 0], [0, 1], [1, 0], [0, 1]])]   # worse
    calls = []

    def refresh(state):
        calls.append(state)
        q = qs[state]
        return q, q, q

    _, out = dec_loop.run_dec_loop(refresh, lambda s, p: (s + 1, 0.0), 0, np.zeros(4), y, 3, -1.0)
    assert calls == [0, 1, 2] and out["best_ari"] == 1.0 and out["best_q"] is qs[0]
    assert out["q"] is qs[2]


# --------------------------------------------------------------------------
# pretrain mixins
# --------------------------------------------------------------------------


class _Toy(NNPretrain):
    def __init__(self, path=None):
        super().__init__()
        self.model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
        self.pretrain_path = path
        self.pretrained = 0

    def pretrain(self, scale=1.0):
        self.pretrained += 1
        with torch.no_grad():
            for p in self.model.parameters():
                p.mul_(scale)


def test_nn_pretrain_freezes_named_submodules():
    toy = _Toy()
    toy.fix_module("0")
    assert not any(p.requires_grad for p in toy.model[0].parameters())
    assert all(p.requires_grad for p in toy.model[1].parameters())
    before = [p.detach().clone() for p in toy.model.parameters()]
    opt = torch.optim.Adam([p for p in toy.model.parameters()], lr=0.1)
    toy.model(torch.ones(5, 3)).sum().backward()
    opt.step()
    after = list(toy.model.parameters())
    assert all(torch.equal(b, a) for b, a in zip(before[:2], after[:2]))   # frozen
    assert not any(torch.equal(b, a) for b, a in zip(before[2:], after[2:]))
    with toy.pretrain_context("0"):
        assert all(p.requires_grad for p in toy.model.parameters())
    assert not toy.model[0].weight.requires_grad and toy._frozen == {"0"}
    toy.unfix_modules("0")
    assert toy.model[0].weight.requires_grad and not toy._frozen
    assert TorchNNPretrain is NNPretrain and issubclass(NNPretrain, BasePretrain)


def test_nn_pretrain_saves_loads_and_skips(tmp_path):
    path = str(tmp_path / "pt.pt")
    toy = _Toy(path)
    toy._pretrain(scale=2.0)  # pretrains, then saves
    assert toy.pretrained == 1 and toy.is_pretrained
    toy._pretrain(scale=2.0)  # already pretrained: skipped
    assert toy.pretrained == 1
    toy._pretrain(scale=2.0, force_pretrain=True)
    assert toy.pretrained == 2
    saved = torch.load(path, weights_only=True)
    other = _Toy(path)
    assert not all(torch.equal(saved[k], v) for k, v in other.model.state_dict().items())
    other._pretrain(scale=3.0)  # loads the file instead of pretraining
    assert other.pretrained == 0 and other.is_pretrained
    for k, v in toy.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v)
    no_path = _Toy()
    no_path._pretrain()  # warns that nothing is saved, and pretrains
    assert no_path.pretrained == 1


# --------------------------------------------------------------------------
# TAGConv against JAX, CSR and BSR
# --------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("use_bsr", [False, True])
def test_tagconv_matches_jax(use_bsr, k):
    rng = np.random.default_rng(10 + k)
    n, d_in, d_out = 150, 9, 5
    adj = sp.random(n, n, density=0.05, random_state=k, format="csr", dtype=np.float32)
    adj = adj + adj.T
    h = rng.normal(0, 1, (n, d_in)).astype(np.float32)
    gout = rng.normal(0, 1, (n, d_out)).astype(np.float32)
    jadj = jpk.bsr_from_scipy(adj) if use_bsr else jcsr_from_scipy(adj)
    jconv = JTAGConv(d_out, k=k)
    params = jconv.init(jax.random.key(k), jadj, jnp.asarray(h))
    want = np.asarray(jconv.apply(params, jadj, jnp.asarray(h)))
    jgrads = jax.grad(lambda p, x: jnp.sum(jconv.apply(p, jadj, x) * gout), argnums=(0, 1))(
        params, jnp.asarray(h))

    conv = TAGConv(d_in, d_out, k=k)
    conv.load_state_dict(tagconv_flax_to_torch(_np_tree(params["params"])))
    tadj = tbsr.bsr_from_scipy(adj) if use_bsr else csr_from_scipy(adj)
    th = torch.from_numpy(h).requires_grad_(True)
    got = conv(tadj, th)
    (got * torch.from_numpy(gout)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgrads[1]), rtol=1e-5, atol=1e-5)
    want_state = tagconv_flax_to_torch(_np_tree(jgrads[0]["params"]))
    for name, p in conv.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_state[name].numpy(), rtol=1e-5,
                                   atol=1e-4, err_msg=name)


def test_tagconv_flax_to_torch_rejects_unknown_names():
    with pytest.raises(KeyError, match="unexpected"):
        tagconv_flax_to_torch({"LayerNorm_0": {}})
    with pytest.raises(KeyError, match="unexpected"):
        tagconv_flax_to_torch({"Dense_1": {"kernel": np.zeros((2, 2)), "bias": np.zeros(2)}})
