"""Losses (counterpart: dance_tpu/utils/loss.py): the negative binomial and
zero-inflated negative binomial likelihoods of the ZINB autoencoders, the DEC
soft assignment, its target distribution and KL loss, the latent distance
barrier, graph-sc's ``binary_ce_logits`` (:22-126), the GMM negative
log-likelihood (:133), the masked losses, the similarity losses and the
standard-normal KL (:144-178), the warm-ups (:181-210, :405-440), BABEL's
paired and quad losses and the reference-named surface (:216-472: ``kld_loss``,
the BCE/MSE/RMSE/``DistanceProbLoss`` classes, ``total_variation``, the
NB/ZINB factories and classes, the scVI log-likelihoods,
``PairedLossInvertible``), scMVAE's GMM ELBO term ``GMM_loss`` (:475), DCCA's
distillation / attention-transfer family (:493-600) and the scMVAE/scMM
helpers (:602-666: ``binary_cross_entropy``, ``log_nb_positive``,
``log_zinb_positive``, ``NB_loss``, ``mse_loss``, ``poisson_loss``,
``adjust_learning_rate``, ``get_mean``).

Plain functions and callables on tensors, with the JAX package's ``EPS``
placement and its ``x < 1e-8`` zero case; ``jax.lax.lgamma`` is
``torch.lgamma``. ``NBLoss``, ``ZINBLoss`` and the distillation classes keep
the callable classes' names. Of the distillation losses ``Eucli_dis``,
``L1_dis``, ``KL_diver`` and ``Attention`` return a value per cell, the
others a scalar. ``KL_diver`` takes log-variances as Normal *scales*, as JAX
and the reference do (loss.py:566-576): kept so. The warm-ups are host
Python, as in JAX. ``adjust_learning_rate`` returns the step's rate, as JAX
does, and also sets it on a torch optimizer when one is given, as the
reference does (JAX's optax schedules have no optimizer to set). The NB and
ZINB factories' and classes' ``debug`` flags, which JAX never reads, are not
taken.
"""

import math
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-10


def nb_nll(x: torch.Tensor, mean: torch.Tensor, disp: torch.Tensor, scale_factor=1.0,
           reduce: bool = True) -> torch.Tensor:
    """Negative binomial negative log-likelihood of counts ``x`` (counterpart:
    loss.py:22). ``disp`` is the inverse dispersion (theta); ``scale_factor``
    scales the mean per cell (library size)."""
    mean = mean * scale_factor
    disp = torch.clamp(disp, EPS, 1e6)
    t1 = torch.lgamma(disp + EPS) + torch.lgamma(x + 1.0) - torch.lgamma(x + disp + EPS)
    t2 = ((disp + x) * torch.log1p(mean / (disp + EPS))
          + x * (torch.log(disp + EPS) - torch.log(mean + EPS)))
    nll = t1 + t2
    return torch.mean(nll) if reduce else nll


def zinb_nll(x: torch.Tensor, mean: torch.Tensor, disp: torch.Tensor, pi: torch.Tensor,
             scale_factor=1.0, ridge_lambda: float = 0.0, reduce: bool = True) -> torch.Tensor:
    """Zero-inflated negative binomial NLL (counterpart: loss.py:38); ``pi``
    is the dropout probability, ``ridge_lambda`` an L2 penalty on it."""
    mean = mean * scale_factor
    disp = torch.clamp(disp, EPS, 1e6)
    nb_case = nb_nll(x, mean, disp, reduce=False) - torch.log(1.0 - pi + EPS)
    zero_nb = torch.pow(disp / (disp + mean + EPS), disp)
    zero_case = -torch.log(pi + (1.0 - pi) * zero_nb + EPS)
    result = torch.where(x < 1e-8, zero_case, nb_case)
    if ridge_lambda > 0:
        result = result + ridge_lambda * torch.square(pi)
    return torch.mean(result) if reduce else result


class NBLoss:
    """Callable :func:`nb_nll` under the reference class name (counterpart: loss.py:56)."""

    def __call__(self, x, mean, disp, scale_factor=1.0):
        return nb_nll(x, mean, disp, scale_factor)


class ZINBLoss:
    """Callable :func:`zinb_nll` under the reference class name (counterpart: loss.py:63)."""

    def __init__(self, ridge_lambda: float = 0.0):
        self.ridge_lambda = ridge_lambda

    def __call__(self, x, mean, disp, pi, scale_factor=1.0):
        return zinb_nll(x, mean, disp, pi, scale_factor, self.ridge_lambda)


def soft_assign(z: torch.Tensor, centers: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """Student-t soft cluster assignment ``q_ij`` of DEC (counterpart: loss.py:77)."""
    d2 = torch.sum((z[:, None, :] - centers[None, :, :]) ** 2, dim=-1)
    q = torch.pow(1.0 + d2 / alpha, -(alpha + 1.0) / 2.0)
    return q / torch.sum(q, dim=1, keepdim=True)


def target_distribution(q: torch.Tensor) -> torch.Tensor:
    """The sharpened target ``p_ij`` of the clustering KL (counterpart: loss.py:84)."""
    weight = (q ** 2) / torch.sum(q, dim=0, keepdim=True)
    return weight / torch.sum(weight, dim=1, keepdim=True)


def cluster_kl_loss(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """KL(p || q) averaged over cells (counterpart: loss.py:90)."""
    return torch.mean(torch.sum(p * (torch.log(p + EPS) - torch.log(q + EPS)), dim=1))


def dist_loss(z: torch.Tensor, min_dist: float = 1.0, max_dist: float = 20.0) -> torch.Tensor:
    """Soft barrier keeping the latent pairwise distances inside
    [``min_dist``, ``max_dist``]: the mean of ``exp(-(d - min)) + exp(-(max -
    d))`` over all pairs, ``d²`` from the Gram identity (counterpart:
    loss.py:99)."""
    r = torch.sum(z * z, dim=-1)
    d2 = r[:, None] + r[None, :] - 2.0 * (z @ z.T)
    d = torch.sqrt(torch.clamp(d2, min=0.0) + 1e-10)
    return torch.mean(torch.exp(-(d - min_dist)) + torch.exp(-(max_dist - d)))


def binary_ce_logits(logits: torch.Tensor, target: torch.Tensor,
                     pos_weight: Optional[Union[float, torch.Tensor]] = None) -> torch.Tensor:
    """Mean sigmoid binary cross entropy from logits, with ``pos_weight``
    scaling the positive term: ``(1 + (w - 1) t) softplus(l) - w t l``
    (counterpart: loss.py:113). ``softplus`` is ``logaddexp(l, 0)``, the
    function ``jax.nn.softplus`` computes; ``F.softplus`` returns ``l`` itself
    above 20."""
    sp = torch.logaddexp(logits, torch.zeros((), dtype=logits.dtype, device=logits.device))
    if pos_weight is None:
        return torch.mean(sp - target * logits)
    return torch.mean((1.0 + (pos_weight - 1.0) * target) * sp - pos_weight * target * logits)


def gmm_nll(z: torch.Tensor, pi: torch.Tensor, mu: torch.Tensor,
            logvar: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of the rows of ``z`` under a diagonal
    Gaussian mixture: weights ``pi`` (K,), means ``mu`` and log-variances
    ``logvar`` (K, D) (counterpart: loss.py:133)."""
    z = z[:, None, :]
    logp = (-0.5 * (math.log(2 * math.pi) + logvar + (z - mu) ** 2 / torch.exp(logvar))).sum(-1)
    logp = logp + torch.log(pi + EPS)[None, :]
    return -torch.mean(torch.logsumexp(logp, dim=1))


def GMM_loss(gamma: torch.Tensor, c_params, z_params) -> torch.Tensor:
    """The GMM-prior ELBO's KL term per cell (counterpart: loss.py:475):
    ``gamma`` the responsibilities (N, K), ``c_params`` = (mu_c (D, K),
    var_c (D, K), pi (N, K)), ``z_params`` = (mu, logvar) (N, D)."""
    mu_c, var_c, pi = c_params
    mu, logvar = z_params
    mu_e, lv_e = mu[:, :, None], logvar[:, :, None]
    logpzc = -0.5 * torch.sum(
        gamma * torch.sum(math.log(2 * math.pi) + torch.log(var_c) + torch.exp(lv_e) / var_c
                          + (mu_e - mu_c) ** 2 / var_c, dim=1), dim=1)
    logpc = torch.sum(gamma * torch.log(pi), dim=1)
    qentropy = -0.5 * torch.sum(1 + logvar + math.log(2 * math.pi), dim=1)
    logqcx = torch.sum(gamma * torch.log(gamma), dim=1)
    return -logpzc - logpc + qentropy + logqcx


# -- DCCA's distillation / attention-transfer family (loss.py:493-600) --------


class Eucli_dis:
    """Squared euclidean distance per cell (counterpart: loss.py:493)."""

    def __call__(self, g_s: torch.Tensor, g_t: torch.Tensor) -> torch.Tensor:
        return torch.sum((g_s - g_t) ** 2, dim=1)


class L1_dis:
    """L1 distance per cell (counterpart: loss.py:500)."""

    def __call__(self, g_s: torch.Tensor, g_t: torch.Tensor) -> torch.Tensor:
        return torch.sum(torch.abs(g_s - g_t), dim=1)


def _l2_normalize(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` over its euclidean norm along ``dim``, the norm floored at 1e-12."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=1e-12)


class NSTLoss:
    """Neuron-selectivity transfer, a polynomial-kernel MMD (counterpart:
    loss.py:511)."""

    def __call__(self, g_s, g_t):
        return [self.nst_loss(f_s, f_t) for f_s, f_t in zip(g_s, g_t)]

    def nst_loss(self, f_s: torch.Tensor, f_t: torch.Tensor) -> torch.Tensor:
        f_s = _l2_normalize(f_s.reshape(f_s.shape[0], f_s.shape[1], -1), 2)
        f_t = _l2_normalize(f_t.reshape(f_t.shape[0], f_t.shape[1], -1), 2)
        return self.poly_kernel(f_s, f_s).mean() - 2 * self.poly_kernel(f_s, f_t).mean()

    @staticmethod
    def poly_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.sum(a[:, None] * b[:, :, None], dim=-1) ** 2


class FactorTransfer:
    """Factor-transfer distillation (counterpart: loss.py:528)."""

    def __init__(self, p1: int = 2, p2: int = 1):
        self.p1, self.p2 = p1, p2

    def __call__(self, f_s: torch.Tensor, f_t: torch.Tensor) -> torch.Tensor:
        diff = self.factor(f_s) - self.factor(f_t)
        return torch.abs(diff).mean() if self.p2 == 1 else (diff ** self.p2).mean()

    def factor(self, f: torch.Tensor) -> torch.Tensor:
        return _l2_normalize((f ** self.p1).mean(1).reshape(f.shape[0], -1), 1)


class Similarity:
    """Similarity-preserving distillation (counterpart: loss.py:544)."""

    def __call__(self, g_s, g_t):
        return [self.similarity_loss(f_s, f_t) for f_s, f_t in zip(g_s, g_t)]

    @staticmethod
    def similarity_loss(f_s: torch.Tensor, f_t: torch.Tensor) -> torch.Tensor:
        bsz = f_s.shape[0]
        f_s, f_t = f_s.reshape(bsz, -1), f_t.reshape(bsz, -1)
        gs = _l2_normalize(f_s @ f_s.T, 1)
        gt = _l2_normalize(f_t @ f_t.T, 1)
        return torch.sum((gt - gs) ** 2) / (bsz * bsz)


class Correlation:
    """Correlation-congruence distillation (counterpart: loss.py:558)."""

    def __call__(self, f_s: torch.Tensor, f_t: torch.Tensor) -> torch.Tensor:
        delta = torch.abs(f_s - f_t)
        return torch.mean(torch.sum(delta[:-1] * delta[1:], dim=1))


class KL_diver:
    """KL between two diagonal Gaussians given as (mean, scale) pairs, per
    cell, the scales clamped at 1e-12 (counterpart: loss.py:566). DCCA hands
    it log-variances as the scales, as the reference does: kept so."""

    def __call__(self, mean_1, scale_1, mean_2, scale_2) -> torch.Tensor:
        s1 = torch.clamp(scale_1, min=1e-12)
        s2 = torch.clamp(scale_2, min=1e-12)
        return torch.sum(torch.log(s2 / s1) + (s1 ** 2 + (mean_1 - mean_2) ** 2) / (2 * s2 ** 2)
                         - 0.5, dim=1)


class Attention:
    """Attention transfer: the norm of the difference of the row-normalised
    maps, per cell (counterpart: loss.py:579)."""

    def __init__(self, p: int = 2):
        self.p = p

    def __call__(self, g_s: torch.Tensor, g_t: torch.Tensor) -> torch.Tensor:
        diff = _l2_normalize(g_s, 1) - _l2_normalize(g_t, 1)
        return torch.linalg.vector_norm(diff, dim=1)


def cdisttf(data_1: torch.Tensor, data_2: torch.Tensor) -> torch.Tensor:
    """Pairwise euclidean distances from the Gram identity, negative squares
    clamped to 0 (counterpart: loss.py:590)."""
    d2 = (torch.sum(data_1 ** 2, 1)[:, None] + torch.sum(data_2 ** 2, 1)[None, :]
          - 2 * data_1 @ data_2.T)
    return torch.sqrt(torch.clamp(d2, min=0.0))


def masked_mse(pred, true, mask) -> torch.Tensor:
    """The squared error over the masked entries (at least one) (counterpart:
    loss.py:145)."""
    mask = mask.to(pred.dtype)
    return torch.sum((pred - true) ** 2 * mask) / torch.clamp(torch.sum(mask), min=1.0)


def masked_rmse(pred, true, mask) -> torch.Tensor:
    """Counterpart: loss.py:150."""
    return torch.sqrt(masked_mse(pred, true, mask))


def _unit_rows(a: torch.Tensor) -> torch.Tensor:
    return a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True), min=EPS)


def cosine_similarity_loss(a, b) -> torch.Tensor:
    """One less the mean cosine similarity of the rows (counterpart:
    loss.py:158)."""
    return 1.0 - torch.mean(torch.sum(_unit_rows(a) * _unit_rows(b), dim=-1))


def sce_loss(a, b, alpha: float = 2.0) -> torch.Tensor:
    """The scaled cosine error, mean of ``(1 - cos)^alpha`` (counterpart:
    loss.py:164)."""
    return torch.mean((1.0 - torch.sum(_unit_rows(a) * _unit_rows(b), dim=-1)) ** alpha)


def kl_divergence(mu, logvar) -> torch.Tensor:
    """The standard-normal KL of a diagonal Gaussian, summed over the last
    axis, averaged over the rows (counterpart: loss.py:171)."""
    return -0.5 * torch.mean(torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar), dim=-1))


class SigmoidWarmup:
    """``maximum / (1 + exp(-(t - midpoint) / scale))`` at step t = 1, 2, ...
    (counterpart: loss.py:181)."""

    def __init__(self, midpoint: int, scale: float = 1.0, maximum: float = 1.0):
        self.midpoint, self.scale, self.maximum = midpoint, scale, maximum
        self.t = 0

    def step(self) -> float:
        self.t += 1
        return float(self.maximum / (1.0 + np.exp(-(self.t - self.midpoint) / self.scale)))


class LinearWarmup:
    """``min(t / interval, 1) maximum`` at step t = 1, 2, ... (counterpart:
    loss.py:192)."""

    def __init__(self, interval: int, maximum: float = 1.0):
        self.interval, self.maximum = interval, maximum
        self.t = 0

    def step(self) -> float:
        self.t += 1
        return float(min(self.t / self.interval, 1.0) * self.maximum)


class NullWarmup:
    """Always ``maximum`` (counterpart: loss.py:203)."""

    def __init__(self, maximum: float = 1.0):
        self.maximum = maximum

    def step(self) -> float:
        return self.maximum


def _mean_sq(p, t):
    return torch.mean((p - t) ** 2)


class PairedLoss:
    """``w1 loss1(p11, t1) + w2 loss2(p12, t2)``, MSE by default
    (counterpart: loss.py:216)."""

    def __init__(self, loss1=None, loss2=None, w1: float = 1.0, w2: float = 1.0):
        self.loss1 = loss1 or _mean_sq
        self.loss2 = loss2 or _mean_sq
        self.w1, self.w2 = w1, w2

    def __call__(self, preds, targets):
        (p11, p12), (t1, t2) = preds, targets
        return self.w1 * self.loss1(p11, t1) + self.w2 * self.loss2(p12, t2)


class QuadLoss:
    """BABEL's four paths: both outputs of modality 1 by ``loss1`` (times
    ``loss1_weight``), both of modality 2 by ``loss2`` (counterpart:
    loss.py:229)."""

    def __init__(self, loss1=None, loss2=None, loss1_weight: float = 1.0):
        self.loss1 = loss1 or _mean_sq
        self.loss2 = loss2 or _mean_sq
        self.loss1_weight = loss1_weight

    def __call__(self, preds, targets):
        (p11, p21, p12, p22), (t1, t2) = preds, targets
        return (self.loss1_weight * (self.loss1(p11, t1) + self.loss1(p21, t1))
                + self.loss2(p12, t2) + self.loss2(p22, t2))


def kld_loss(p, q) -> torch.Tensor:
    """Row-wise KL(p || q), averaged (counterpart: loss.py:250)."""
    return torch.mean(torch.sum(p * torch.log(p / (q + 1e-6)), dim=1))


class BCELoss:
    """BCE of the first element of a prediction tuple, clipped to [1e-7,
    1 - 1e-7] (counterpart: loss.py:255)."""

    def __call__(self, x, target):
        p = torch.clamp(x[0], 1e-7, 1 - 1e-7)
        return -torch.mean(target * torch.log(p) + (1 - target) * torch.log1p(-p))


class MSELoss:
    """MSE of the first element of a prediction tuple (counterpart: loss.py:264)."""

    def __call__(self, x, target):
        return torch.mean((x[0] - target) ** 2)


class RMSELoss:
    """RMSE of the first element of a prediction tuple (counterpart: loss.py:271)."""

    def __call__(self, x, target):
        return torch.sqrt(torch.mean((x[0] - target) ** 2))


class DistanceProbLoss:
    """``weight x`` the ``norm``-distance of ``z`` to ``target_z`` less
    ``logp``, averaged (counterpart: loss.py:278)."""

    def __init__(self, weight: float = 5.0, norm: int = 1):
        if weight <= 0:
            raise ValueError(f"weight must be positive, got {weight}")
        self.weight = weight
        self.norm = norm

    def __call__(self, x, target_z):
        z, logp = x[:2]
        d = torch.sum(torch.abs(z - target_z) ** self.norm, dim=-1) ** (1.0 / self.norm)
        if d.dim() == 2:
            d = torch.mean(d, dim=1)
        return torch.mean(self.weight * d - logp)


def total_variation(x) -> torch.Tensor:
    """The summed absolute difference of neighbouring features (counterpart:
    loss.py:294)."""
    return torch.sum(torch.abs(x[:, :-1] - x[:, 1:]))


def negative_binom_loss(scale_factor: float = 1.0, eps: float = 1e-10, mean: bool = True):
    """DCA's NB loss ``loss(preds, theta, truth)`` (counterpart: loss.py:299)."""

    def loss(preds, theta, truth):
        y_pred = preds * scale_factor
        theta = torch.clamp(theta, max=1e6)
        t1 = torch.lgamma(theta + eps) + torch.lgamma(truth + 1.0) - torch.lgamma(
            truth + theta + eps)
        t2 = ((theta + truth) * torch.log1p(y_pred / (theta + eps))
              + truth * (torch.log(theta + eps) - torch.log(y_pred + eps)))
        ret = t1 + t2
        return torch.mean(ret) if mean else ret

    return loss


def zero_inflated_negative_binom_loss(ridge_lambda: float = 0.0, tv_lambda: float = 0.0,
                                      eps: float = 1e-10, scale_factor: float = 1.0):
    """DCA's ZINB loss ``loss(preds, theta, pi, truth)`` with the ridge and
    total-variation penalties on the dropout (counterpart: loss.py:316)."""
    nb_loss_func = negative_binom_loss(mean=False, eps=eps, scale_factor=scale_factor)

    def loss(preds, theta_disp, pi_dropout, truth):
        nb_case = nb_loss_func(preds, theta_disp, truth) - torch.log(1.0 - pi_dropout + eps)
        y_pred = preds * scale_factor
        theta = torch.clamp(theta_disp, max=1e6)
        zero_nb = torch.pow(theta / (theta + y_pred + eps), theta)
        zero_case = -torch.log(pi_dropout + (1.0 - pi_dropout) * zero_nb + eps)
        result = torch.where(truth < 1e-8, zero_case, nb_case)
        result = result + ridge_lambda * pi_dropout ** 2
        result = result + tv_lambda * total_variation(pi_dropout)
        return torch.mean(result)

    return loss


def scvi_log_nb_positive(x, mu, theta, eps=1e-8) -> torch.Tensor:
    """scVI's NB log-likelihood, averaged (counterpart: loss.py:339)."""
    log_theta_mu_eps = torch.log(theta + mu + eps)
    res = (theta * (torch.log(theta + eps) - log_theta_mu_eps)
           + x * (torch.log(mu + eps) - log_theta_mu_eps)
           + torch.lgamma(x + theta) - torch.lgamma(theta) - torch.lgamma(x + 1))
    return torch.mean(res)


def scvi_log_zinb_positive(x, mu, theta, pi, eps=1e-8) -> torch.Tensor:
    """scVI's ZINB log-likelihood with dropout logits ``pi``, averaged
    (counterpart: loss.py:349)."""
    if theta.dim() == 1:
        theta = theta[None, :]
    softplus_pi = F.softplus(-pi)
    log_theta_eps = torch.log(theta + eps)
    log_theta_mu_eps = torch.log(theta + mu + eps)
    pi_theta_log = -pi + theta * (log_theta_eps - log_theta_mu_eps)
    case_zero = F.softplus(pi_theta_log) - softplus_pi
    case_non_zero = (-softplus_pi + pi_theta_log + x * (torch.log(mu + eps) - log_theta_mu_eps)
                     + torch.lgamma(x + theta) - torch.lgamma(theta) - torch.lgamma(x + 1))
    return torch.mean(torch.where(x < eps, case_zero, case_non_zero))


class NegativeBinomialLoss:
    """:func:`negative_binom_loss` over a ``(mean, dispersion, ...,
    encoded)`` tuple, plus ``l1_lambda`` times the encoding's L1 norm
    (counterpart: loss.py:367)."""

    def __init__(self, scale_factor: float = 1.0, eps: float = 1e-10, l1_lambda: float = 0.0,
                 mean: bool = True):
        self.loss = negative_binom_loss(scale_factor=scale_factor, eps=eps, mean=mean)
        self.l1_lambda = l1_lambda

    def __call__(self, preds, target):
        mean_, theta = preds[:2]
        out = self.loss(mean_, theta, target)
        if self.l1_lambda:
            out = out + self.l1_lambda * torch.abs(preds[-1]).sum()
        return out


class ZeroInflatedNegativeBinomialLoss:
    """:func:`zero_inflated_negative_binom_loss` over a ``(mean,
    dispersion, dropout, ..., encoded)`` tuple (counterpart: loss.py:385)."""

    def __init__(self, ridge_lambda: float = 0.0, tv_lambda: float = 0.0,
                 l1_lambda: float = 0.0, eps: float = 1e-10, scale_factor: float = 1.0):
        self.loss = zero_inflated_negative_binom_loss(ridge_lambda=ridge_lambda,
                                                      tv_lambda=tv_lambda, eps=eps,
                                                      scale_factor=scale_factor)
        self.l1_lambda = l1_lambda

    def __call__(self, preds, target):
        mean_, theta, pi = preds[:3]
        out = self.loss(mean_, theta, pi, target)
        if self.l1_lambda:
            out = out + self.l1_lambda * torch.abs(preds[-1]).sum()
        return out


class Warmup:
    """0, inc, 2 inc, ... capped at ``t_max``, one value a step (counterpart:
    loss.py:405)."""

    def __init__(self, inc: float = 5e-3, t_max: float = 1.0):
        self.t, self.t_max, self.inc, self.counter = 0.0, t_max, inc, 0

    def __iter__(self):
        return self

    def __next__(self):
        retval = self.t
        self.t = min(self.t + self.inc, self.t_max)
        self.counter += 1
        return retval

    step = __next__


class DelayedLinearWarmup:
    """:class:`Warmup` that stays at 0 until step ``delay`` (counterpart:
    loss.py:423)."""

    def __init__(self, delay: int = 2000, inc: float = 5e-3, t_max: float = 1.0):
        self.t, self.t_max, self.inc = 0.0, t_max, inc
        self.delay, self.counter = delay, 0

    def __iter__(self):
        return self

    def __next__(self):
        self.counter += 1
        retval = self.t
        if self.counter >= self.delay:
            self.t = min(self.t + self.inc, self.t_max)
        return retval

    step = __next__


def _mean_abs(x, y):
    return torch.mean(torch.abs(x - y))


class PairedLossInvertible:
    """Both modalities' losses, the link term between their encodings and
    the invertible bottleneck's alignment under delayed warm-ups
    (counterpart: loss.py:443)."""

    def __init__(self, loss1=NegativeBinomialLoss, loss2=ZeroInflatedNegativeBinomialLoss,
                 loss3=DistanceProbLoss, link_func=_mean_abs, link_strength: float = 1e-3,
                 inv_strength: float = 1.0):
        self.loss1, self.loss2, self.loss3 = loss1(), loss2(), loss3()
        self.link = link_strength
        self.link_f = link_func
        self.link_warmup = DelayedLinearWarmup(delay=1000, inc=5e-3, t_max=link_strength)
        self.inv_warmup = DelayedLinearWarmup(delay=2000, inc=5e-3, t_max=inv_strength)

    def __call__(self, preds, target):
        preds1, preds2, (enc1_pred, enc2_pred) = preds
        target1, target2 = target
        retval = self.loss1(preds1, target1) + self.loss2(preds2, target2)
        if self.link > 0:
            lw = next(self.link_warmup)
            if lw > 1e-6:
                retval = retval + lw * torch.mean(self.link_f(preds1[-1], preds2[-1]))
        iw = next(self.inv_warmup)
        return retval + iw * (self.loss3(enc1_pred, enc2_pred[0])
                              + self.loss3(enc2_pred, enc1_pred[0]))


def binary_cross_entropy(recon_x, x) -> torch.Tensor:
    """Per-sample summed BCE (counterpart: loss.py:602)."""
    return -torch.sum(x * torch.log(recon_x + 1e-8) + (1 - x) * torch.log(1 - recon_x + 1e-8),
                      dim=1)


def log_nb_positive(x, mu, theta, eps=1e-8) -> torch.Tensor:
    """Counterpart: loss.py:610 (:func:`scvi_log_nb_positive`)."""
    return scvi_log_nb_positive(x, mu, theta, eps=eps)


def log_zinb_positive(x, mu, theta, pi, eps=1e-8) -> torch.Tensor:
    """Counterpart: loss.py:616 (:func:`scvi_log_zinb_positive`)."""
    return scvi_log_zinb_positive(x, mu, theta, pi, eps=eps)


def NB_loss(y_true, y_pred, theta, eps=1e-10) -> torch.Tensor:
    """The per-sample *negated* summed NB NLL, as the reference returns it
    (counterpart: loss.py:622)."""
    t1 = torch.lgamma(theta + eps) + torch.lgamma(y_true + 1.0) - torch.lgamma(
        y_true + theta + eps)
    t2 = ((theta + y_true) * torch.log1p(y_pred / (theta + eps))
          + y_true * (torch.log(theta + eps) - torch.log(y_pred + eps)))
    return -torch.sum(t1 + t2, dim=1)


def mse_loss(y_true, y_pred) -> torch.Tensor:
    """Per-sample squared error on the entries where the truth is nonzero
    (its sign as the mask) (counterpart: loss.py:636)."""
    return torch.sum(((y_pred - y_true) * torch.sign(y_true)) ** 2, dim=1)


def poisson_loss(y_true, y_pred) -> torch.Tensor:
    """Per-sample summed Poisson NLL (counterpart: loss.py:644)."""
    return torch.sum(y_pred - y_true * torch.log(y_pred + 1e-10) + torch.lgamma(y_true + 1.0),
                     dim=1)


def adjust_learning_rate(init_lr, optimizer, iteration, max_lr, adjust_epoch) -> float:
    """``max(init_lr 0.9^(iteration // adjust_epoch), max_lr)`` (counterpart:
    loss.py:652), set on ``optimizer``'s groups when it is a torch optimizer."""
    lr = max(init_lr * (0.9 ** (iteration // adjust_epoch)), max_lr)
    if isinstance(optimizer, torch.optim.Optimizer):
        for group in optimizer.param_groups:
            group["lr"] = lr
    return lr


def get_mean(d, K: int = 100):
    """A distribution's ``mean``, or the mean of ``K`` samples when it has
    none (counterpart: loss.py:660)."""
    mean = getattr(d, "mean", None)
    if mean is not None:
        return mean
    return torch.mean(d.sample((K,)), dim=0)


__all__ = ["Attention", "BCELoss", "Correlation", "DelayedLinearWarmup", "DistanceProbLoss",
           "EPS", "Eucli_dis", "FactorTransfer", "GMM_loss", "KL_diver", "L1_dis",
           "LinearWarmup", "MSELoss", "NBLoss", "NB_loss", "NSTLoss", "NegativeBinomialLoss",
           "NullWarmup", "PairedLoss", "PairedLossInvertible", "QuadLoss", "RMSELoss",
           "SigmoidWarmup", "Similarity", "Warmup", "ZINBLoss",
           "ZeroInflatedNegativeBinomialLoss", "adjust_learning_rate", "binary_ce_logits",
           "binary_cross_entropy", "cdisttf", "cluster_kl_loss", "cosine_similarity_loss",
           "dist_loss", "get_mean", "gmm_nll", "kl_divergence", "kld_loss", "log_nb_positive",
           "log_zinb_positive", "masked_mse", "masked_rmse", "mse_loss",
           "negative_binom_loss", "nb_nll", "poisson_loss", "sce_loss", "scvi_log_nb_positive",
           "scvi_log_zinb_positive", "soft_assign", "target_distribution", "total_variation",
           "zero_inflated_negative_binom_loss", "zinb_nll"]
