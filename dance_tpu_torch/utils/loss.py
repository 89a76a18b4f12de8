"""Losses (counterpart: dance_tpu/utils/loss.py): the negative binomial and
zero-inflated negative binomial likelihoods of the ZINB autoencoders, the DEC
soft assignment, its target distribution and KL loss, the latent distance
barrier, graph-sc's ``binary_ce_logits`` (:22-126), the GMM negative
log-likelihood (:133), scMVAE's GMM ELBO term ``GMM_loss`` (:475) and DCCA's
distillation / attention-transfer family (:493-600).

Plain functions and callables on tensors, with the JAX package's ``EPS``
placement and its ``x < 1e-8`` zero case; ``jax.lax.lgamma`` is
``torch.lgamma``. ``NBLoss``, ``ZINBLoss`` and the distillation classes keep
the callable classes' names. Of the distillation losses ``Eucli_dis``,
``L1_dis``, ``KL_diver`` and ``Attention`` return a value per cell, the
others a scalar. ``KL_diver`` takes log-variances as Normal *scales*, as JAX
and the reference do (loss.py:566-576): kept so. The rest of the JAX file
(masked and BABEL losses, warm-ups) waits for the models that use it
(ROADMAP Queue 1).
"""

import math
from typing import Optional, Union

import torch

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


__all__ = ["Attention", "Correlation", "EPS", "Eucli_dis", "FactorTransfer", "GMM_loss",
           "KL_diver", "L1_dis", "NBLoss", "NSTLoss", "Similarity", "ZINBLoss",
           "binary_ce_logits", "cdisttf", "cluster_kl_loss", "dist_loss", "gmm_nll", "nb_nll",
           "soft_assign", "target_distribution", "zinb_nll"]
