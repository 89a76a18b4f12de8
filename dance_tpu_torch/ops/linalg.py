"""Truncated SVD, PCA, the PCA projection, the SVD embedding and the
Gaussian random projection (counterpart: dance_tpu/ops/linalg.py:19-128).

``solver="auto"`` takes the exact SVD when ``min(m, n) <= 1024`` and the
randomized range finder (Halko et al.) otherwise, as the JAX package does.
The random test matrix comes from an explicit ``torch.Generator`` seeded with
``seed``; it is not the JAX package's ``jax.random`` draw, so randomized
results agree with it only to the accuracy of the method. The sparse-input
path (``_rsvd_sparse``, linalg.py:74) is not part of this slice.
"""

from typing import NamedTuple

import math

import torch


def _rsvd(x: torch.Tensor, n_components: int, generator: torch.Generator,
          n_oversample: int = 10, n_iter: int = 4):
    """Counterpart: ``_rsvd`` (linalg.py:19-34)."""
    m, n = x.shape
    k = min(n_components + n_oversample, min(m, n))
    omega = torch.randn((n, k), generator=generator, dtype=x.dtype).to(x.device)
    q, _ = torch.linalg.qr(x @ omega)
    for _ in range(n_iter):  # power iterations sharpen the spectrum
        q, _ = torch.linalg.qr(x.T @ q)
        q, _ = torch.linalg.qr(x @ q)
    ub, s, vt = torch.linalg.svd(q.T @ x, full_matrices=False)
    u = q @ ub
    return u[:, :n_components], s[:n_components], vt[:n_components]


def _sign_flip(u: torch.Tensor, vt: torch.Tensor):
    """Largest-|v| entry positive per component, sklearn's
    ``svd_flip(u_based_decision=False)`` (counterpart: linalg.py:37)."""
    max_idx = vt.abs().argmax(dim=1)
    signs = torch.sign(vt[torch.arange(vt.shape[0], device=vt.device), max_idx])
    return u * signs[None, :], vt * signs[:, None]


def randomized_svd(x: torch.Tensor, n_components: int, *, seed: int = 0,
                   solver: str = "auto"):
    """Truncated SVD of a dense ``x`` -> (U, S, Vt) with sklearn's signs
    (counterpart: linalg.py:45). The computation runs on ``x``'s device, in
    float32."""
    x = x.to(torch.float32)
    if solver == "auto":
        solver = "exact" if min(x.shape) <= 1024 else "randomized"
    if solver == "exact":
        u, s, vt = torch.linalg.svd(x, full_matrices=False)
        u, s, vt = u[:, :n_components], s[:n_components], vt[:n_components]
    elif solver == "randomized":
        gen = torch.Generator().manual_seed(seed)
        u, s, vt = _rsvd(x, n_components, gen)
    else:
        raise ValueError(f"unknown solver {solver!r}")
    u, vt = _sign_flip(u, vt)
    return u, s, vt


class PCAResult(NamedTuple):
    embedding: torch.Tensor           # (n, k) transformed data
    components: torch.Tensor          # (k, d) principal axes
    mean: torch.Tensor                # (d,)
    explained_variance: torch.Tensor  # (k,)


def pca(x: torch.Tensor, n_components: int, *, seed: int = 0) -> PCAResult:
    """PCA via the SVD of the centred matrix, sklearn-parity signs
    (counterpart: linalg.py:102)."""
    x = x.to(torch.float32)
    mean = x.mean(dim=0)
    u, s, vt = randomized_svd(x - mean[None, :], n_components, seed=seed)
    return PCAResult(u * s[None, :], vt, mean, s ** 2 / (x.shape[0] - 1))


def pca_transform(x, result: PCAResult) -> torch.Tensor:
    """New rows projected onto a fitted PCA, ``(x - mean) componentsᵀ``, in
    float32 on the result's device (counterpart: linalg.py:113)."""
    x = torch.as_tensor(x, dtype=torch.float32).to(result.mean.device)
    return (x - result.mean[None, :]) @ result.components.T


def svd_embedding(x: torch.Tensor, n_components: int, **kwargs):
    """TruncatedSVD's embedding, without centring: ``(U S, Vt)`` of
    :func:`randomized_svd` (counterpart: linalg.py:118)."""
    u, s, vt = randomized_svd(x, n_components, **kwargs)
    return u * s[None, :], vt


def gram_schmidt_gauss_proj(generator: torch.Generator, n_features: int, n_components: int,
                            dtype=torch.float32) -> torch.Tensor:
    """A random Gaussian projection, (n_features, n_components) standard
    normals over sqrt(n_components), drawn from ``generator`` on its device
    (counterpart: linalg.py:124, which draws from a ``jax.random`` key; the
    draws differ, the law is the same)."""
    z = torch.randn((n_features, n_components), generator=generator, dtype=dtype,
                    device=generator.device)
    return z / math.sqrt(n_components)


__all__ = ["PCAResult", "gram_schmidt_gauss_proj", "pca", "pca_transform", "randomized_svd",
           "svd_embedding"]
