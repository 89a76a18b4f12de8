"""Non-negative matrix factorisation by Frobenius multiplicative updates,
and the non-negative least squares built on it (counterpart:
dance_tpu/ops/nmf.py).

``V ≈ W H``: ``H <- H (WᵀV) / (WᵀW H + EPS)``, then ``W <- W (V Hᵀ) / (W H Hᵀ
+ EPS)``, ``n_iter`` times (``_nmf_mu`` :25); with W fixed, ``WᵀV`` and
``WᵀW`` are formed once (``_nmf_mu_fixed_w`` :68). A factor not given starts
at ``sqrt(mean(V) / k) |N(0, 1)|`` (:41-66).

Where this differs from the JAX package:

- Every product is IEEE float32 on the device (default the CUDA card; the
  CPU only when named). JAX's SPOTlight runs the loops at
  ``Precision.DEFAULT``, one bf16 pass on a TPU; ``precision`` is gone.
- The iterations are a Python loop (JAX: one ``fori_loop``), with in-place
  updates.
- The starting factors come from a CPU ``torch.Generator`` seeded with
  ``seed`` (:func:`init_factors`); parity tests patch it to hand in JAX's
  draws, or pass ``W_init``/``H_init``.
"""

from typing import NamedTuple, Tuple

import numpy as np
import torch

from dance_tpu_torch.utils import resolve_device

EPS = 1e-10


class NMFResult(NamedTuple):
    W: torch.Tensor  # (n, k)
    H: torch.Tensor  # (k, m)
    loss: torch.Tensor  # the Frobenius norm of V - W H


def init_factors(V: torch.Tensor, n_components: int,
                 seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``scale |N(0, 1)|`` starts of W (n, k) and H (k, m), ``scale =
    sqrt(mean(V) / k)``, drawn on the CPU and moved to ``V``'s device."""
    gen = torch.Generator().manual_seed(seed)
    n, m = V.shape
    W = torch.randn((n, n_components), generator=gen).abs()
    H = torch.randn((n_components, m), generator=gen).abs()
    scale = torch.sqrt(V.mean() / n_components)
    return scale * W.to(V.device), scale * H.to(V.device)


def _as_device(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device, torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _nmf_mu(V, W, H, n_iter: int):
    """Counterpart: nmf.py:25."""
    for _ in range(n_iter):
        H = H * ((W.T @ V).div_((W.T @ W) @ H + EPS))
        W = W * ((V @ H.T).div_(W @ (H @ H.T) + EPS))
    return W, H


def _nmf_mu_fixed_w(V, W, H, n_iter: int):
    """Counterpart: nmf.py:68."""
    WtV = W.T @ V
    WtW = W.T @ W
    for _ in range(n_iter):
        H = H * (WtV / (WtW @ H + EPS))
    return H


def nmf(V, n_components: int, *, n_iter: int = 200, seed: int = 0, W_init=None, H_init=None,
        W_fixed: bool = False, device="auto") -> NMFResult:
    """NMF ``V ≈ W H``; with ``W_fixed`` only H is updated, the NNLS mode
    (counterpart: nmf.py:41). Returns tensors on ``device``."""
    dev = resolve_device(device)
    V = _as_device(V, dev)
    if W_init is None or H_init is None:
        W0, H0 = init_factors(V, n_components, seed)
    W = _as_device(W_init, dev) if W_init is not None else W0
    H = _as_device(H_init, dev) if H_init is not None else H0
    if W_fixed:
        H = _nmf_mu_fixed_w(V, W, H, n_iter)
    else:
        W, H = _nmf_mu(V, W, H, n_iter)
    return NMFResult(W, H, torch.linalg.norm(V - W @ H))


def nnls(A, b, n_iter: int = 300, *, x_init=None, device="auto") -> torch.Tensor:
    """``min |A x - b|`` over ``x >= 0`` by multiplicative updates; ``b``
    may hold several right-hand sides as columns (counterpart: nmf.py:80).
    ``x_init`` replaces the random start."""
    b = b if isinstance(b, torch.Tensor) else torch.as_tensor(np.asarray(b, np.float32))
    squeeze = b.dim() == 1
    if squeeze:
        b = b[:, None]
    if x_init is not None and squeeze:
        x_init = np.asarray(x_init, np.float32)[:, None]
    x = nmf(b, A.shape[1], n_iter=n_iter, W_init=A, H_init=x_init, W_fixed=True,
            device=device).H
    return x[:, 0] if squeeze else x


__all__ = ["EPS", "NMFResult", "init_factors", "nmf", "nnls"]
