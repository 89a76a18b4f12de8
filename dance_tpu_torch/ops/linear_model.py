"""One-vs-rest linear classification heads: the squared-hinge SVM, logistic
regression and its minibatch SGD form, and the RBF-kernel SVM (counterpart:
dance_tpu/ops/linear_model.py).

Every objective is one ``(cells, feats) @ (feats, classes)`` product a step
plus the L2 term, trained with Adam (optax's ``adam`` is torch's rule):
``_fit_ovr`` (:29-99), the exact-kernel ``_fit_kernel_ovr`` (:102-127) on
the n x n Gram matrix of ``_rbf_kernel`` (:130), and the random Fourier
features of ``_rff`` (:137-148) beyond ``kernel_cap`` cells. The classes
keep sklearn's surface: ``classes_``, ``coef_`` as (classes, feats),
``intercept_``, ``decision_function``, ``predict`` and the row-normalised
OvR sigmoid ``predict_proba``.

Where this differs from the JAX package:

- Everything runs in IEEE float32 on ``device`` (default the CUDA card; the
  CPU only when named). JAX runs the logistic heads at ``Precision.DEFAULT``
  (:231, :247), one bf16 pass on a TPU; the ``precision`` argument is gone.
- The steps are a Python loop (JAX: one compiled scan). The ``tol`` stop
  runs chunks of ``tol_chunk`` steps and reads one flag a chunk, computed
  in float32 on the device as JAX's ``while_loop`` condition computes it.
- The minibatch rows (:func:`sgd_rows`) and the RFF draws
  (:func:`rff_draws`) come from CPU ``torch.Generator``s seeded with
  ``seed``, not from ``jax.random``; parity tests patch those two functions
  to hand in JAX's draws.
"""

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from dance_tpu_torch.utils import resolve_device


def sgd_rows(n: int, batch_size: int, steps: int, seed: int) -> torch.Tensor:
    """The rows of every minibatch, (steps, batch_size) int64 on the CPU,
    drawn with replacement (counterpart: the ``jax.random.randint`` of
    linear_model.py:66)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, n, (steps, batch_size), generator=gen)


def rff_draws(d: int, n_features: int, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RFF frequencies before their ``sqrt(2 gamma)`` scale, (d,
    n_features) standard normals, and the phases, uniform in [0, 2 pi), on
    the CPU (counterpart: linear_model.py:140-143)."""
    gen = torch.Generator().manual_seed(seed)
    omega = torch.randn((d, n_features), generator=gen)
    beta = torch.rand((n_features,), generator=gen) * (2 * math.pi)
    return omega, beta


def ovr_objective(W: torch.Tensor, b: torch.Tensor, x: torch.Tensor, t: torch.Tensor,
                  l2: float, loss: str) -> torch.Tensor:
    """The per-sample mean of the summed OvR losses on margins ``t * f``
    plus ``l2 / 2 |W|²`` (counterpart: linear_model.py:51-59)."""
    m = t * (x @ W + b)
    if loss == "squared_hinge":
        data = (torch.clamp(1.0 - m, min=0.0) ** 2).sum(1).mean()
    elif loss == "logistic":
        data = torch.logaddexp(torch.zeros_like(m), -m).sum(1).mean()
    else:
        raise ValueError(f"Unknown loss {loss!r}; options: squared_hinge, logistic")
    return data + 0.5 * l2 * (W * W).sum()


def _fit_ovr(x: torch.Tensor, t: torch.Tensor, l2: float, lr: float, epochs: int, loss: str,
             batch_size: int = 0, seed: int = 0, tol: float = 0.0,
             tol_chunk: int = 0) -> Tuple[torch.Tensor, torch.Tensor, int, List[float]]:
    """Train OvR weights on targets ``t`` in {-1, +1}, (n, classes)
    (counterpart: linear_model.py:29). ``batch_size > 0`` draws that many
    rows with replacement every step. ``tol_chunk > 0`` (full batch only)
    runs chunks of ``tol_chunk`` steps and stops once the objective's
    relative gain over a chunk is at most ``tol``, or after
    ``ceil(epochs / tol_chunk)`` chunks; the first chunk always runs.
    Returns ``(W, b, steps run, objectives)``: with ``tol_chunk``, the
    full-batch objective at the start and after every chunk, else []."""
    n, d = x.shape
    W = torch.zeros((d, t.shape[1]), device=x.device, requires_grad=True)
    b = torch.zeros((t.shape[1],), device=x.device, requires_grad=True)
    opt = torch.optim.Adam([W, b], lr=lr)

    def step(xb, tb):
        opt.zero_grad(set_to_none=True)
        ovr_objective(W, b, xb, tb, l2, loss).backward()
        opt.step()

    if tol_chunk and not batch_size:
        n_chunks = -(-epochs // tol_chunk)
        with torch.no_grad():
            cur = ovr_objective(W, b, x, t, l2, loss)
        objectives, steps = [cur], 0
        for i in range(n_chunks):
            for _ in range(tol_chunk):
                step(x, t)
            steps += tol_chunk
            with torch.no_grad():
                prev, cur = cur, ovr_objective(W, b, x, t, l2, loss)
                objectives.append(cur)
                go_on = (prev - cur) > tol * torch.clamp(prev.abs(), min=1e-12)
            if i + 1 < n_chunks and not bool(go_on):  # one read a chunk
                break
        return W.detach(), b.detach(), steps, torch.stack(objectives).tolist()
    if batch_size:
        rows = sgd_rows(n, batch_size, epochs, seed).to(x.device)
        for s in range(epochs):
            step(x[rows[s]], t[rows[s]])
    else:
        for _ in range(epochs):
            step(x, t)
    return W.detach(), b.detach(), epochs, []


def _fit_kernel_ovr(K: torch.Tensor, t: torch.Tensor, lam: float, lr: float,
                    epochs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Primal kernel SVM: squared hinge on ``f = K a + b`` with the RKHS
    term ``lam / 2 aᵀ K a``, ``epochs`` Adam steps (counterpart:
    linear_model.py:102)."""
    a = torch.zeros((K.shape[0], t.shape[1]), device=K.device, requires_grad=True)
    b = torch.zeros((t.shape[1],), device=K.device, requires_grad=True)
    opt = torch.optim.Adam([a, b], lr=lr)
    for _ in range(epochs):
        opt.zero_grad(set_to_none=True)
        Ka = K @ a
        m = t * (Ka + b)
        data = (torch.clamp(1.0 - m, min=0.0) ** 2).sum(1).mean()
        (data + 0.5 * lam * (a * Ka).sum()).backward()
        opt.step()
    return a.detach(), b.detach()


def _rbf_kernel(a: torch.Tensor, b: torch.Tensor, gamma: float) -> torch.Tensor:
    """``exp(-gamma max(|a_i - b_j|², 0))`` (counterpart: linear_model.py:130)."""
    d2 = (a * a).sum(1)[:, None] + (b * b).sum(1)[None] - 2.0 * (a @ b.T)
    return torch.exp(-gamma * torch.clamp(d2, min=0.0))


def _rff(x: torch.Tensor, gamma: float, n_features: int, seed: int) -> torch.Tensor:
    """Random Fourier features of the RBF kernel: ``sqrt(2 / D) cos(x ω + β)``
    with ``ω ~ N(0, 2 gamma I)`` (counterpart: linear_model.py:137)."""
    omega, beta = rff_draws(x.shape[1], n_features, seed)
    omega = omega.to(x.device) * math.sqrt(2.0 * gamma)
    proj = x @ omega + beta.to(x.device)
    return math.sqrt(2.0 / n_features) * torch.cos(proj)


def ovr_targets(y) -> Tuple[np.ndarray, np.ndarray]:
    """``(classes, t)``: the sorted labels and the (n, classes) float32
    targets, +1 at a cell's label and -1 elsewhere."""
    classes, y_idx = np.unique(np.asarray(y), return_inverse=True)
    t = -np.ones((len(y_idx), len(classes)), np.float32)
    t[np.arange(len(y_idx)), y_idx] = 1.0
    return classes, t


class DeviceLinearClassifier:
    """One-vs-rest linear classifier (counterpart: linear_model.py:152):
    logistic by default; ``l2 = 1 / (C n)``, or ``alpha`` when given."""

    loss = "logistic"

    def __init__(self, C: float = 1.0, alpha: Optional[float] = None, epochs: int = 300,
                 lr: float = 0.05, batch_size: int = 0, seed: int = 0, tol: float = 0.0,
                 tol_chunk: int = 25, device="auto"):
        self.C, self.alpha = C, alpha
        self.epochs, self.lr, self.batch_size, self.seed = epochs, lr, batch_size, seed
        self.tol, self.tol_chunk = tol, tol_chunk
        self.device = resolve_device(device)
        self.steps_run = 0
        self.objectives_: List[float] = []  # the tol stop's objective at each chunk

    def _map(self, x: torch.Tensor) -> torch.Tensor:
        """The feature map: the identity here, RFF in :class:`DeviceSVC`."""
        return x

    def _prepare(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return self._map(x.to(self.device, torch.float32))
        return self._map(torch.as_tensor(np.asarray(x, np.float32), device=self.device))

    def fit(self, x, y):
        self.classes_, t = ovr_targets(y)
        xd = self._prepare(x)
        l2 = self.alpha if self.alpha is not None else 1.0 / (self.C * len(t))
        self._W, self._b, self.steps_run, self.objectives_ = _fit_ovr(
            xd, torch.from_numpy(t).to(self.device), float(l2), float(self.lr), self.epochs,
            self.loss, self.batch_size, self.seed, tol=float(self.tol),
            tol_chunk=self.tol_chunk if self.tol else 0)
        return self

    @property
    def coef_(self) -> np.ndarray:
        return self._W.T.cpu().numpy()  # (classes, feats), sklearn's layout

    @property
    def intercept_(self) -> np.ndarray:
        return self._b.cpu().numpy()

    @torch.no_grad()
    def decision_function(self, x) -> np.ndarray:
        f = (self._prepare(x) @ self._W + self._b).cpu().numpy()
        return f.ravel() if f.shape[1] == 1 else f

    def predict(self, x) -> np.ndarray:
        return self.classes_[np.atleast_2d(self.decision_function(x)).argmax(1)]

    def predict_proba(self, x) -> np.ndarray:
        """The OvR sigmoids, each row divided by its sum (celltypist's rule)."""
        p = 1.0 / (1.0 + np.exp(-np.atleast_2d(self.decision_function(x))))
        return p / np.maximum(p.sum(1, keepdims=True), 1e-12)


class DeviceLogisticRegression(DeviceLinearClassifier):
    """OvR logistic regression with the ``tol`` stop (counterpart:
    linear_model.py:219): relative gain 1e-4 a 25-step chunk, ``epochs`` the
    ``max_iter`` cap."""

    loss = "logistic"

    def __init__(self, C: float = 1.0, epochs: int = 1000, lr: float = 0.05, seed: int = 0,
                 tol: float = 1e-4, **kwargs):
        super().__init__(C=C, epochs=epochs, lr=lr, seed=seed, tol=tol, **kwargs)


class DeviceSGDLogistic(DeviceLinearClassifier):
    """Minibatch logistic head, ``alpha`` the L2 weight (counterpart:
    linear_model.py:239); full batch when ``batch_size >= n``."""

    loss = "logistic"

    def __init__(self, alpha: float = 1e-4, epochs: int = 1000, batch_size: int = 1000,
                 lr: float = 0.05, seed: int = 0, device="auto"):
        super().__init__(alpha=alpha, epochs=epochs, lr=lr, batch_size=batch_size, seed=seed,
                         device=device)

    def fit(self, x, y):
        if self.batch_size >= x.shape[0]:
            self.batch_size = 0  # full batch: no gather
        return super().fit(x, y)


class DeviceSVC(DeviceLinearClassifier):
    """RBF-kernel SVM, squared-hinge OvR (counterpart: linear_model.py:259).
    Up to ``kernel_cap`` training cells the kernel is exact (the n x n Gram
    matrix, kept with the training cells); beyond, the features are
    ``n_components`` random Fourier features. ``gamma="scale"`` is
    ``1 / (feats x.var())`` of the float32 training matrix, taken in numpy
    on the host as JAX takes it, and frozen at the first call."""

    loss = "squared_hinge"

    def __init__(self, C: float = 1.0, gamma="scale", kernel: str = "rbf",
                 n_components: int = 4096, kernel_cap: int = 20_000, epochs: int = 300,
                 lr: float = 0.05, seed: int = 0, random_state: Optional[int] = None,
                 device="auto"):
        super().__init__(C=C, epochs=epochs, lr=lr,
                         seed=seed if random_state is None else random_state, device=device)
        self.kernel = kernel
        self.gamma = gamma
        self.n_components = n_components
        self.kernel_cap = kernel_cap
        self._gamma_val: Optional[float] = None
        self._x_fit: Optional[torch.Tensor] = None  # the exact kernel keeps the training set

    def _resolve_gamma(self, x: np.ndarray) -> float:
        if self._gamma_val is None:  # the first call (the fit) freezes it
            if self.gamma == "scale":
                self._gamma_val = float(1.0 / (x.shape[1] * x.var()))
            elif self.gamma == "auto":
                self._gamma_val = float(1.0 / x.shape[1])
            else:
                self._gamma_val = float(self.gamma)
        return self._gamma_val

    @staticmethod
    def _host(x) -> np.ndarray:
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)

    def _prepare(self, x) -> torch.Tensor:
        x = np.asarray(self._host(x), np.float32)
        xd = torch.as_tensor(x, device=self.device)
        if self.kernel == "linear":
            return xd
        return _rff(xd, self._resolve_gamma(x), self.n_components, self.seed)

    def fit(self, x, y):
        x = np.asarray(self._host(x), np.float32)
        if self.kernel != "rbf" or x.shape[0] > self.kernel_cap:
            return super().fit(x, y)
        self.classes_, t = ovr_targets(y)
        self._x_fit = torch.as_tensor(x, device=self.device)
        K = _rbf_kernel(self._x_fit, self._x_fit, self._resolve_gamma(x))
        self._W, self._b = _fit_kernel_ovr(K, torch.from_numpy(t).to(self.device),
                                           1.0 / (self.C * len(t)), float(self.lr),
                                           self.epochs)
        self.steps_run = self.epochs
        return self

    @torch.no_grad()
    def decision_function(self, x) -> np.ndarray:
        if self._x_fit is None:
            return super().decision_function(x)
        xd = torch.as_tensor(np.asarray(self._host(x), np.float32), device=self.device)
        Kx = _rbf_kernel(xd, self._x_fit, self._gamma_val)
        return (Kx @ self._W + self._b).cpu().numpy()


__all__ = ["DeviceLinearClassifier", "DeviceLogisticRegression", "DeviceSGDLogistic",
           "DeviceSVC", "ovr_objective", "ovr_targets", "rff_draws", "sgd_rows"]
