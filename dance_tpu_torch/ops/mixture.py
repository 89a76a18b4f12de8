"""A Gaussian mixture with diagonal covariances, fitted by EM on a device:
the port's counterpart of scikit-learn's ``GaussianMixture(n_components,
covariance_type="diag", reg_covar, random_state)``, which the JAX scMVAE fits
to warm-start its GMM prior
(dance_tpu/modules/multi_modality/joint_embedding/scmvae.py:420-439). The JAX
package has no module of its own for it; the card's machine has no sklearn.

sklearn's defaults and steps: one initialisation (``n_init=1``) from the
hard responsibilities of one k-means run (``init_params="kmeans"``), then
at most ``max_iter=100`` EM iterations, stopped when the mean log-likelihood
of the E-step changes by less than ``tol=1e-3``. The M-step is sklearn's
``_estimate_gaussian_parameters``: ``nk = Σ resp + 10 eps``, the means
``respᵀ x / nk`` and the diagonal variances ``E[x²] − 2 E[x] μ + μ² +
reg_covar``, the weights ``nk`` over their sum. The E-step is the
log-density through the precisions' Cholesky factors ``1 / sqrt(var)``,
plus the log-weights, normalised by ``logsumexp``. Everything runs in
float64 (sklearn keeps a float32 input in float32; the port's EM does not,
so a float32 latent is held to a float64 fit).

The k-means draw is the port's (:func:`~dance_tpu_torch.ops.cluster.kmeans`
with one k-means++ start from ``random_state``, sklearn's 300 iterations and
its relative tolerance 1e-4), not sklearn's, which the card cannot run: the
same data can start EM from another partition. The tests hold the EM itself
against sklearn from the same initial parameters
(``tests/test_torch_scmvae.py``).
"""

import math
from typing import Optional, Tuple

import numpy as np
import torch

from dance_tpu_torch.ops.cluster import kmeans
from dance_tpu_torch.utils import resolve_device

MAX_ITER, TOL = 100, 1e-3  # sklearn's defaults: EM iterations, change of the lower bound


def estimate_gaussian_parameters(x: torch.Tensor, resp: torch.Tensor,
                                 reg_covar: float) -> Tuple[torch.Tensor, ...]:
    """sklearn's ``_estimate_gaussian_parameters`` for diagonal covariances:
    ``(nk, means, variances)`` of the soft counts ``resp`` (n, K) over the
    rows of ``x`` (n, D)."""
    nk = resp.sum(0) + 10 * torch.finfo(resp.dtype).eps
    sums = resp.T @ x
    means = sums / nk[:, None]
    avg_x2 = (resp.T @ (x * x)) / nk[:, None]
    avg_x_means = means * sums / nk[:, None]
    return nk, means, avg_x2 - 2 * avg_x_means + means ** 2 + reg_covar


def initial_responsibilities(x: torch.Tensor, n_components: int, seed: int) -> torch.Tensor:
    """One-hot responsibilities (n, K) of one k-means run on the rows of
    ``x`` (sklearn's ``init_params="kmeans"``), in ``x``'s dtype."""
    labels = kmeans(x, n_components, n_init=1, n_iter=300, tol=1e-4, seed=seed).labels
    return torch.nn.functional.one_hot(labels, n_components).to(x.dtype)


class GaussianMixture:
    """EM for a mixture of ``n_components`` Gaussians with diagonal
    covariances, in float64, after sklearn's ``GaussianMixture`` with
    ``covariance_type="diag"`` and its defaults (``MAX_ITER``, ``TOL``,
    one k-means start). ``fit(x)`` takes an array (run on
    ``device``: the card unless the CPU is named) or a tensor (run where it
    lies). After it: ``weights_`` (K,), ``means_`` and ``covariances_``
    (K, D), ``precisions_cholesky_``, ``converged_``, ``n_iter_`` and
    ``lower_bound_``, as sklearn names them, the tensors on the device the
    fit ran on."""

    def __init__(self, n_components: int, *, reg_covar: float = 1e-6, random_state: int = 0,
                 device=None):
        self.n_components, self.reg_covar = n_components, reg_covar
        self.random_state, self.device = random_state, device

    def _as_tensor(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
            x = x.to(resolve_device("auto" if self.device is None else self.device))
        return x.to(torch.float64)

    def _set(self, weights, means, covariances):
        if not bool((covariances > 0).all()):
            raise ValueError("GaussianMixture: a variance is not positive; raise reg_covar")
        self.weights_, self.means_, self.covariances_ = weights, means, covariances
        self.precisions_cholesky_ = 1.0 / torch.sqrt(covariances)

    def _log_resp(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The E-step: ``(log p(x_i), log resp)`` of every row."""
        prec = self.precisions_cholesky_ ** 2
        log_det = torch.log(self.precisions_cholesky_).sum(1)
        log_prob = (torch.sum(self.means_ ** 2 * prec, 1) - 2.0 * (x @ (self.means_ * prec).T)
                    + (x ** 2) @ prec.T)
        weighted = (-0.5 * (x.shape[1] * math.log(2 * math.pi) + log_prob) + log_det
                    + torch.log(self.weights_))
        norm = torch.logsumexp(weighted, dim=1)
        return norm, weighted - norm[:, None]

    def fit(self, x, resp: Optional[torch.Tensor] = None) -> "GaussianMixture":
        """EM from the parameters of ``resp`` (n, K), by default the
        responsibilities of one k-means run (:func:`initial_responsibilities`)."""
        x = self._as_tensor(x)
        if resp is None:
            resp = initial_responsibilities(x, self.n_components, self.random_state)
        nk, means, covariances = estimate_gaussian_parameters(
            x, resp.to(x), self.reg_covar)
        self._set(nk / x.shape[0], means, covariances)
        lower_bound, self.converged_ = -math.inf, False
        for n_iter in range(1, MAX_ITER + 1):
            prev = lower_bound
            norm, log_resp = self._log_resp(x)
            nk, means, covariances = estimate_gaussian_parameters(
                x, torch.exp(log_resp), self.reg_covar)
            self._set(nk / nk.sum(), means, covariances)
            lower_bound = float(norm.mean())
            if abs(lower_bound - prev) < TOL:
                self.converged_ = True
                break
        self.n_iter_, self.lower_bound_ = n_iter, lower_bound
        return self

    def predict(self, x) -> torch.Tensor:
        """The most responsible component of each row."""
        return self._log_resp(self._as_tensor(x))[1].argmax(1)


__all__ = ["GaussianMixture", "estimate_gaussian_parameters", "initial_responsibilities"]
