"""CARD: conditional-autoregressive deconvolution of spatial spots.

Counterpart: dance_tpu/modules/spatial/cell_type_deconvo/card.py
(``_cardref`` :28-91, ``Card`` :94, ``obj_func`` :167, ``CARDref`` :181).
The spots' (spots x types) portions V follow multiplicative updates under a
CAR prior over a Gaussian kernel W of the spot coordinates: each iteration
takes every type's precision Λ and mean b from V, then updates every type
at once from the previous V (Jacobi, as JAX does; the reference's
``CARDref`` updates type by type). The run stops after iteration 5 once the
root mean square change of V falls below ``epsilon``. ``Card.fit`` sweeps
the CAR weight φ over seven values and keeps the best final objective.
CARD runs no TPU kernel: two (spots x spots) x (spots x types) cuBLAS GEMMs
an iteration and small elementwise passes.

Where this differs from the JAX package:

- The iterations are a Python loop (JAX: a ``while_loop``). Past iteration 5
  the stop is evaluated on the device every iteration; a converged run
  keeps its V while the loop runs to the end of its chunk of
  :data:`STOP_CHUNK` iterations, and the flag is read once a chunk. The
  same iterations count as in JAX.
- ``D V`` is ``colsum(W) * V``, ``b`` is ``Vᵀ L 1 / sum(L)`` and the
  quadratic form's diagonal ``diag((V - 1bᵀ)ᵀ L (V - 1bᵀ))`` is a column sum
  of ``(V - 1bᵀ) * L (V - 1bᵀ)``: the same values as JAX's dense products, in
  float32 sums of another order.
- ``Card`` takes the basis as a (genes x types) array, not a DataFrame.
  :func:`card_preprocess` is the array front of ``preprocessing_pipeline``:
  it runs the pipeline on a container of reference cells and spots.
- ``obj_func`` and ``CARDref`` are the JAX package's host numpy.
"""

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from dance_tpu_torch.modules.base import BaseRegressionMethod, resolve_score_func
from dance_tpu_torch.modules.spatial.cell_type_deconvo.dstg import deconvo_container
from dance_tpu_torch.settings import logger
from dance_tpu_torch.transforms.filter import (FilterGenesCommon, FilterGenesMarker,
                                               FilterGenesMatch, FilterGenesPercentile)
from dance_tpu_torch.transforms.misc import Compose, SetConfig
from dance_tpu_torch.transforms.pseudobulk import CellTopicProfile
from dance_tpu_torch.utils import as_numpy, resolve_device
from dance_tpu_torch.utils.matrix import normalize

PHIS = (0.01, 0.1, 0.3, 0.5, 0.7, 0.9, 0.99)
STOP_CHUNK = 10  # iterations between reads of the stop flag


class CardRun(NamedTuple):
    pred: torch.Tensor  # (spots, types) row-normalised V
    obj: torch.Tensor  # the final log-likelihood of X given V
    iterations: int


@torch.no_grad()
def _cardref(X: torch.Tensor, U: torch.Tensor, W: Optional[torch.Tensor], phi: float,
             V0: torch.Tensor, max_iter: int, epsilon: float = 0.0) -> CardRun:
    """CARD's V updates; ``X`` is (genes x spots), ``U`` the (genes x types)
    basis, ``W`` the (spots x spots) kernel or None (counterpart: card.py:28)."""
    n_sample = X.shape[1]
    k = U.shape[1]
    dev = X.device
    UtX = U.T @ X
    XtU = UtX.T
    UtU = U.T @ U
    alpha, beta = 1.0, n_sample / 2.0
    sigma_e2 = 0.1
    V = V0
    Lambda = torch.full((k,), 10.0, device=dev)
    b = torch.zeros((k,), device=dev)
    if W is not None:
        colsum = W.sum(1)[:, None]
        phiW = phi * W
        L = torch.diag(colsum[:, 0]) - phiW
        L1 = L.sum(1)
        accu_L = L.sum()
    done = torch.zeros((), dtype=torch.bool, device=dev)
    run = torch.zeros((), dtype=torch.int64, device=dev)
    V_old = None
    for i in range(max_iter):
        if epsilon > 0 and i > 5:
            rms = torch.sqrt(((V - V_old) ** 2).sum() / (n_sample * k))
            done = done | (rms < epsilon)
        if W is not None:
            Vc = V - b[None, :]
            Lambda = ((Vc * (L @ Vc)).sum(0) / 2.0 + beta) / (n_sample / 2.0 + alpha + 1.0)
            b = (V.T @ L1) / accu_L
            part1 = sigma_e2 * (colsum * V + phi * colsum * b[None, :])
            part2 = sigma_e2 * (phiW @ V + colsum * b[None, :])
            den = Lambda[None, :] * (V @ UtU) + part1
            num = Lambda[None, :] * XtU + part2
        else:
            Lambda = torch.full((k,), beta / (n_sample / 2.0 + alpha + 1.0), device=dev)
            den = Lambda[None, :] * (V @ UtU)
            num = Lambda[None, :] * XtU
        V_new = V * num / torch.clamp(den, min=1e-12)
        V_old, V = V, torch.where(done, V, V_new)
        run += ~done
        if (i + 1) % STOP_CHUNK == 0 and epsilon > 0 and i > 5 and bool(done):
            break
    # the final objective, which picks phi
    normNMF = (X * X).sum() - 2.0 * (UtX * V.T).sum() + (UtU * (V.T @ V)).sum()
    m, n = X.shape
    sig = torch.clamp(normNMF / (m * n), min=1e-12)
    logX = -(m * n) * 0.5 * torch.log(sig) - 0.5 * (normNMF / sig)
    pred = V / torch.clamp(V.sum(1, keepdim=True), min=1e-12)
    return CardRun(pred, logX, int(run))


def gaussian_kernel(spatial, sigma: float, device) -> torch.Tensor:
    """The spots' Gaussian kernel ``exp(-d² / (2 sigma²))`` of their
    Euclidean distances in coordinates shifted to 0 and scaled by their
    largest value, zero on the diagonal, float32 (counterpart: card.py:126-132)."""
    coords = np.asarray(spatial) - np.asarray(spatial).min(0)
    coords = coords / max(coords.max(), 1e-12)
    c = torch.as_tensor(coords.astype(np.float32), device=device)
    sq = (c ** 2).sum(1)
    d = torch.sqrt(torch.clamp(sq[:, None] + sq[None, :] - 2 * (c @ c.T), min=0.0))
    kernel = torch.exp(-d ** 2 / (2 * sigma ** 2))
    kernel.fill_diagonal_(0.0)
    return kernel


class CardInputs(NamedTuple):
    """:func:`card_preprocess`'s output: the spots' (spots x genes) counts,
    their coordinates, the (genes x types) basis, the kept gene names and
    the type names."""
    x: np.ndarray
    spatial: np.ndarray
    basis: np.ndarray
    genes: np.ndarray
    cell_types: List[str]


def card_preprocess(x_ref, ref_annot, x_spots, spatial, gene_names: Sequence) -> CardInputs:
    """:meth:`Card.preprocessing_pipeline` on the reference cells ``x_ref``
    typed ``ref_annot`` and the spots ``x_spots`` at ``spatial``, both
    (cells x genes) named ``gene_names``, wrapped in one container
    (:func:`deconvo_container`), for a caller that holds the matrices."""
    data = deconvo_container(x_ref, ref_annot, x_spots, spatial, gene_names)
    Card.preprocessing_pipeline(log_level="WARNING")(data)
    x, xy = data.get_x("test")
    profile = data.data.varm["CellTopicProfile"]
    return CardInputs(x, xy, profile.to_numpy(), np.asarray(data.data.var_names),
                      list(profile.columns))


class Card(BaseRegressionMethod):
    """CARD (counterpart: card.py:94). ``basis`` is the (genes x types)
    profile of the reference; ``fit((x, spatial))`` takes the spots (spots x
    genes) and their coordinates. The arithmetic runs on ``device`` (default
    the CUDA card; the CPU only when named)."""

    def __init__(self, basis, random_state: Optional[int] = 42, device="auto"):
        self.basis = as_numpy(basis)
        self.best_phi = None
        self.best_obj = -np.inf
        self.random_state = random_state
        self.device = resolve_device(device)
        self.history: List[dict] = []

    @staticmethod
    def preprocessing_pipeline(log_level: str = "INFO") -> Compose:
        """The mean profile of each type over split ``"ref"``, then the genes
        not starting with ``"mt-"`` (any case), those expressed in both the
        reference and the spots (sorted by name), the types' marker genes
        (log fold change above 1.25) and the genes between the 1st and 99th
        percentile of their variance over mean on every cell (sorted by
        name); the spots' features are ``X`` and ``obsm["spatial"]``
        (counterpart: card.py:104-116)."""
        return Compose(
            CellTopicProfile(ct_select="auto", batch_key=None, split_name="ref", method="mean"),
            FilterGenesMatch(prefixes=["mt-"], case_sensitive=False),
            FilterGenesCommon(split_keys=["ref", "test"]),
            FilterGenesMarker(threshold=1.25),
            FilterGenesPercentile(min_val=1, max_val=99, mode="rv"),
            SetConfig({"feature_channel": [None, "spatial"],
                       "feature_channel_type": ["X", "obsm"],
                       "label_channel": "cell_type_portion"}),
            log_level=log_level,
        )

    def fit(self, inputs: Tuple[np.ndarray, np.ndarray], y: Optional[Any] = None,
            max_iter: int = 100, epsilon: float = 1e-4, sigma: float = 0.1,
            location_free: bool = False):
        """Normalise the spots and the basis, draw V0 from
        ``default_rng(random_state).dirichlet`` (numpy's, so the JAX package
        starts from the same V0), and run every φ; ``history`` keeps each
        φ's objective and iterations (counterpart: card.py:122)."""
        dev = self.device
        x, spatial = (as_numpy(i) for i in inputs)
        x_norm = normalize(np.asarray(x, np.float64), axis=1, mode="normalize")
        if location_free or (spatial == 0).all():
            kernel = None
        else:
            kernel = gaussian_kernel(spatial, sigma, dev)
        basis = self.basis.copy().astype(np.float64)
        x_norm = x_norm * 0.1 / x_norm.mean()
        b_mat = torch.as_tensor((basis * 0.1 / basis.mean()).astype(np.float32), device=dev)
        rng = np.random.default_rng(self.random_state)
        V0 = torch.as_tensor(rng.dirichlet(np.repeat(10, basis.shape[1]), x_norm.shape[0])
                             .astype(np.float32), device=dev)
        X = torch.as_tensor(np.ascontiguousarray(x_norm.T, np.float32), device=dev)
        self.history = []
        for phi in (PHIS if kernel is not None else (0.0,)):
            run = _cardref(X, b_mat, kernel, phi, V0, max_iter, epsilon)
            obj = float(run.obj)
            self.history.append({"phi": phi, "obj": obj, "iterations": run.iterations})
            if obj > self.best_obj:
                self.best_obj = obj
                self.best_phi = phi
                self.res = run.pred.cpu().numpy()
            logger.info("CARD phi=%.2f obj=%.3e", phi, obj)
        return self

    def predict(self, x: Optional[Any] = None) -> np.ndarray:
        return self.res

    def score(self, x, y, *, score_func=None, return_pred: bool = False, **kwargs):
        y_pred = self.predict(x)
        s = resolve_score_func(score_func or "mse")(as_numpy(y), y_pred)
        return (s, y_pred) if return_pred else s

    def fit_score(self, x, y, *, score_func=None, return_pred: bool = False, **kwargs):
        self.fit(x, **kwargs)
        return self.score(None, y, score_func=score_func, return_pred=return_pred)


def obj_func(trac_xxt, UtXV, UtU, VtV, mGene, nSample, b, Lambda, beta, vecOne, V, L, alpha,
             sigma_e2=None):
    """CARD's log-posterior, higher is better (counterpart: card.py:167)."""
    normNMF = trac_xxt - 2.0 * np.trace(UtXV) + np.trace(UtU @ VtV)
    sigma_e2 = normNMF / (mGene * nSample) or sigma_e2
    logX = -(mGene * nSample) * 0.5 * np.log(sigma_e2) - 0.5 * (normNMF / sigma_e2)
    temp = (V.T - b @ vecOne.T) @ L @ (V - vecOne @ b.T)
    logV = -nSample * 0.5 * np.sum(np.log(Lambda)) - 0.5 * (np.sum(np.diag(temp) / Lambda))
    logSigmaL2 = -(alpha + 1.0) * np.sum(np.log(Lambda)) - np.sum(beta / Lambda)
    return logX + logV + logSigmaL2


def CARDref(Xinput, U, W, phi, max_iter, epsilon, V, b, sigma_e2, Lambda):
    """The reference-signature host solver (counterpart: card.py:181):
    type-by-type multiplicative V updates (Gauss-Seidel) with the objective
    and V-change stops; Λ reads the previous round's quadratic form, as in
    the JAX package. Returns ``(pred, obj)``."""
    V = np.array(V, dtype=np.float64, copy=True)
    b = np.array(b, dtype=np.float64, copy=True)
    Lambda = np.array(Lambda, dtype=np.float64, copy=True)
    nSample = int(Xinput.shape[1])
    mGene = int(Xinput.shape[0])
    k = int(U.shape[1])
    vecOne = np.ones((nSample, 1))
    alpha, beta = 1.0, nSample / 2.0
    trac_xxt = (Xinput * Xinput).sum()
    UtX = U.T @ Xinput
    XtU = UtX.T
    UtXV = UtX @ V
    VtV = V.T @ V
    UtU = U.T @ U
    part1 = np.zeros((nSample, k))
    part2 = np.zeros((nSample, k))
    temp = np.zeros((k, k))
    if W is not None:
        colsum_W = np.sum(W, axis=1)
        D = np.diag(colsum_W)
        L = D - phi * W
        colsum_W = colsum_W.reshape(nSample, 1)
        accu_L = np.sum(L)
    else:
        D = L = np.zeros((nSample, nSample))
        colsum_W = np.zeros((nSample, 1))
        accu_L = 1.0
    obj = obj_func(trac_xxt, UtXV, UtU, VtV, mGene, nSample, b, Lambda, beta, vecOne, V, L,
                   alpha, sigma_e2)
    for i in range(max_iter):
        obj_old = obj
        V_old = V.copy()
        Lambda = (np.diag(temp) / 2.0 + beta) / (nSample / 2.0 + alpha + 1.0)
        if W is not None:
            b = np.sum(V.T @ L, axis=1, keepdims=True) / accu_L
            part1 = sigma_e2 * (D @ V + phi * colsum_W @ b.T)
            part2 = sigma_e2 * (phi * W @ V + colsum_W @ b.T)
        for nCT in range(k):
            den = Lambda[nCT] * (V @ UtU[:, nCT]) + part1[:, nCT]
            V[:, nCT] = V[:, nCT] * ((Lambda[nCT] * XtU[:, nCT] + part2[:, nCT]) / den)
        UtXV = UtX @ V
        VtV = V.T @ V
        temp = (V.T - b @ vecOne.T) @ L @ (V - vecOne @ b.T)
        obj = obj_func(trac_xxt, UtXV, UtU, VtV, mGene, nSample, b, Lambda, beta, vecOne, V, L,
                       alpha)
        rel = abs(obj - obj_old) * 2.0 / abs(obj + obj_old)
        logic1 = (obj > obj_old) and (rel < epsilon)
        logic2 = np.sqrt(np.sum((V - V_old) ** 2) / (nSample * k)) < epsilon
        if (np.isnan(obj) or logic1 or logic2) and i > 5:
            logger.info("CARDref exiting at iteration %d", i)
            break
    pred = V / V.sum(axis=1, keepdims=True)
    return pred, obj


__all__ = ["Card", "CardInputs", "CARDref", "PHIS", "card_preprocess", "gaussian_kernel",
           "obj_func"]
