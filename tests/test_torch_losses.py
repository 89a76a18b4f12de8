"""Port parity for the losses of dance_tpu_torch.utils.loss that no ported
model calls (counterpart: dance_tpu/utils/loss.py:144-472, 602-666): the
masked losses, the similarity losses, the standard-normal KL, the warm-ups,
BABEL's paired and quad losses, the reference-named classes and factories,
the scVI log-likelihoods and scMVAE's helpers. The losses the models use are
held where their models are tested.

Inputs are made with numpy from a seed. Each loss is held against JAX's on
the same inputs, its value at rtol 1e-5 and its gradients with respect to
the float inputs at rtol 1e-4, atol 1e-6 (float32 transcendental functions
of two libraries); the warm-ups and the learning-rate rule exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dance_tpu.utils import loss as J
from dance_tpu_torch.utils import loss as T


def _inputs(seed=0, n=24, g=10):
    rng = np.random.default_rng(seed)
    counts = rng.poisson(rng.gamma(0.5, 3.0, (n, g))).astype(np.float32)
    pos = np.exp(rng.normal(0, 1, (n, g))).astype(np.float32)
    theta = np.exp(rng.normal(0, 1, (n, g))).astype(np.float32)
    prob = rng.uniform(0.02, 0.98, (n, g)).astype(np.float32)
    a = rng.normal(0, 1, (n, g)).astype(np.float32)
    b = rng.normal(0, 1, (n, g)).astype(np.float32)
    mask = rng.random((n, g)) < 0.3
    binary = (rng.random((n, g)) < 0.4).astype(np.float32)
    logp = rng.normal(0, 1, n).astype(np.float32)
    return dict(counts=counts, pos=pos, theta=theta, prob=prob, a=a, b=b, mask=mask,
                binary=binary, logp=logp, p=prob / prob.sum(1, keepdims=True),
                q=pos / pos.sum(1, keepdims=True))


CASES = {
    "masked_mse": (lambda m, d: m.masked_mse(d["a"], d["b"], d["mask"]), ("a", "b")),
    "masked_rmse": (lambda m, d: m.masked_rmse(d["a"], d["b"], d["mask"]), ("a", "b")),
    "cosine_similarity_loss": (lambda m, d: m.cosine_similarity_loss(d["a"], d["b"]),
                               ("a", "b")),
    "sce_loss": (lambda m, d: m.sce_loss(d["a"], d["b"], alpha=3.0), ("a", "b")),
    "kl_divergence": (lambda m, d: m.kl_divergence(d["a"], d["b"] * 0.3), ("a", "b")),
    "kld_loss": (lambda m, d: m.kld_loss(d["p"], d["q"]), ("p", "q")),
    "BCELoss": (lambda m, d: m.BCELoss()((d["prob"], None), d["binary"]), ("prob",)),
    "MSELoss": (lambda m, d: m.MSELoss()((d["a"],), d["b"]), ("a", "b")),
    "RMSELoss": (lambda m, d: m.RMSELoss()((d["a"],), d["b"]), ("a", "b")),
    "DistanceProbLoss": (lambda m, d: m.DistanceProbLoss(weight=2.0, norm=2)(
        (d["a"], d["logp"]), d["b"]), ("a", "b", "logp")),
    "total_variation": (lambda m, d: m.total_variation(d["a"]), ("a",)),
    "negative_binom_loss": (lambda m, d: m.negative_binom_loss(scale_factor=1.5)(
        d["pos"], d["theta"], d["counts"]), ("pos", "theta")),
    "zero_inflated_negative_binom_loss": (
        lambda m, d: m.zero_inflated_negative_binom_loss(ridge_lambda=0.1, tv_lambda=0.05)(
            d["pos"], d["theta"], d["prob"], d["counts"]), ("pos", "theta", "prob")),
    "scvi_log_nb_positive": (lambda m, d: m.scvi_log_nb_positive(d["counts"], d["pos"],
                                                                 d["theta"]), ("pos", "theta")),
    "scvi_log_zinb_positive": (lambda m, d: m.scvi_log_zinb_positive(
        d["counts"], d["pos"], d["theta"][0], d["a"]), ("pos", "a")),
    "NegativeBinomialLoss": (lambda m, d: m.NegativeBinomialLoss(l1_lambda=0.01)(
        (d["pos"], d["theta"], d["a"]), d["counts"]), ("pos", "theta", "a")),
    "ZeroInflatedNegativeBinomialLoss": (
        lambda m, d: m.ZeroInflatedNegativeBinomialLoss(ridge_lambda=0.1, l1_lambda=0.01)(
            (d["pos"], d["theta"], d["prob"], d["a"]), d["counts"]), ("pos", "theta", "prob")),
    "PairedLoss": (lambda m, d: m.PairedLoss(w2=0.5)((d["a"], d["pos"]), (d["b"], d["theta"])),
                   ("a", "pos")),
    "QuadLoss": (lambda m, d: m.QuadLoss(loss1_weight=2.0)(
        (d["a"], d["b"], d["pos"], d["theta"]), (d["prob"], d["q"])), ("a", "b", "pos")),
    "binary_cross_entropy": (lambda m, d: m.binary_cross_entropy(d["prob"], d["binary"]),
                             ("prob",)),
    "log_nb_positive": (lambda m, d: m.log_nb_positive(d["counts"], d["pos"], d["theta"]),
                        ("pos", "theta")),
    "log_zinb_positive": (lambda m, d: m.log_zinb_positive(d["counts"], d["pos"], d["theta"],
                                                           d["a"]), ("pos", "theta", "a")),
    "NB_loss": (lambda m, d: m.NB_loss(d["counts"], d["pos"], d["theta"]), ("pos", "theta")),
    "mse_loss": (lambda m, d: m.mse_loss(d["counts"], d["pos"]), ("pos",)),
    "poisson_loss": (lambda m, d: m.poisson_loss(d["counts"], d["pos"]), ("pos",)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_value_and_gradients_match_jax(name):
    fn, wrt = CASES[name]
    data = _inputs(seed=len(name))
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    want = np.asarray(fn(J, jdata))
    w = (np.random.default_rng(1).random(want.shape).astype(np.float32) if want.ndim
         else np.float32(1.0))

    def jscalar(*args):
        return jnp.sum(fn(J, {**jdata, **dict(zip(wrt, args))}) * w)

    jgrads = jax.grad(jscalar, argnums=tuple(range(len(wrt))))(*[jdata[k] for k in wrt])
    tdata = {k: torch.from_numpy(np.asarray(v)) for k, v in data.items()}
    for k in wrt:
        tdata[k] = tdata[k].clone().requires_grad_(True)
    got = fn(T, tdata)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    (got * torch.from_numpy(np.asarray(w))).sum().backward()
    for k, g in zip(wrt, jgrads):
        np.testing.assert_allclose(tdata[k].grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-6,
                                   err_msg=f"{name} d/d{k}")


def test_warmups_match_jax():
    for jw, tw in ((J.SigmoidWarmup(5, 2.0, 3.0), T.SigmoidWarmup(5, 2.0, 3.0)),
                   (J.LinearWarmup(7, 2.0), T.LinearWarmup(7, 2.0)),
                   (J.NullWarmup(0.5), T.NullWarmup(0.5)),
                   (J.Warmup(0.3, 1.0), T.Warmup(0.3, 1.0)),
                   (J.DelayedLinearWarmup(4, 0.25, 0.6), T.DelayedLinearWarmup(4, 0.25, 0.6))):
        assert [jw.step() for _ in range(12)] == [tw.step() for _ in range(12)]
    assert [next(J.Warmup()) for _ in range(3)] == [next(T.Warmup()) for _ in range(3)]


def test_paired_loss_invertible_matches_jax():
    d = _inputs(seed=3)
    j, t = J.PairedLossInvertible(), T.PairedLossInvertible()
    # advance past the link warm-up's delay so both terms count
    for _ in range(1005):
        next(j.link_warmup), next(t.link_warmup)

    def preds(m, x):
        return ((x["pos"], x["theta"], x["a"]), (x["pos"], x["theta"], x["prob"], x["b"]),
                ((x["a"], x["logp"]), (x["b"], x["logp"])))

    jd = {k: jnp.asarray(v) for k, v in d.items()}
    td = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    for _ in range(3):
        want = float(j(preds(J, jd), (jd["counts"], jd["counts"])))
        got = float(t(preds(T, td), (td["counts"], td["counts"])))
        assert got == pytest.approx(want, rel=1e-5)


def test_adjust_learning_rate_and_get_mean():
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(2))], lr=1.0)
    for it in (0, 9, 10, 55, 300):
        want = J.adjust_learning_rate(0.1, None, it, 0.01, 10)
        assert T.adjust_learning_rate(0.1, opt, it, 0.01, 10) == want
        assert opt.param_groups[0]["lr"] == want
    normal = torch.distributions.Normal(torch.tensor([1.5]), torch.tensor([2.0]))
    assert float(T.get_mean(normal)) == 1.5

    class Sampler:
        def sample(self, shape):
            return torch.arange(12.0).reshape(*shape, 3)[: shape[0]]

    np.testing.assert_allclose(T.get_mean(Sampler(), K=4).numpy(), [4.5, 5.5, 6.5])


def test_distance_prob_loss_needs_a_positive_weight():
    with pytest.raises(ValueError, match="positive"):
        T.DistanceProbLoss(weight=0.0)
