"""Losses (counterpart: dance_tpu/utils/loss.py:22-126): the negative
binomial and zero-inflated negative binomial likelihoods of the ZINB
autoencoders, the DEC soft assignment, its target distribution and KL loss,
the latent distance barrier, and graph-sc's ``binary_ce_logits``.

Plain functions on tensors, with the JAX package's ``EPS`` placement and its
``x < 1e-8`` zero case; ``jax.lax.lgamma`` is ``torch.lgamma``. ``NBLoss``
and ``ZINBLoss`` keep the callable classes' names. The rest of the JAX file
(GMM, masked, distillation and BABEL losses, warm-ups) waits for the models
that use it (ROADMAP Queue 1).
"""

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


__all__ = ["EPS", "NBLoss", "ZINBLoss", "binary_ce_logits", "cluster_kl_loss", "dist_loss",
           "nb_nll", "soft_assign", "target_distribution", "zinb_nll"]
