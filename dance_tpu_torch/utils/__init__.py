"""Seeding, device resolution, the metrics (accuracy, the adjusted Rand
index, NMI, MSE and RMSE, k-means NMI/ARI of an embedding, the OOD
detection measures) and an epoch clock.

Counterparts: ``set_seed`` dance_tpu/utils/__init__.py:99, ``get_device``
dance_tpu/utils/__init__.py:23 (here :func:`resolve_device`, over torch
devices), ``acc`` dance_tpu/utils/metrics.py:36, ``ari`` metrics.py:55,
``nmi``, ``mse``, ``rmse`` and ``mape`` metrics.py:92-112 and
``labeled_clustering_evaluate`` metrics.py:168, ``ood_measures``
metrics.py:197 (with :func:`roc_auc` and :func:`average_precision`, which it
takes from scikit-learn). The JAX package calls
scikit-learn for these; the port computes the same formulas in numpy.
``nmi`` takes sklearn's ``average_method``. The matching evaluator and the
scIB suite are in :mod:`.metrics` and :mod:`.scib_metrics`.
:class:`EpochClock` has no counterpart: the JAX package times whole scans.
``hexdigest``, ``default`` and ``is_numeric`` are JAX's (utils/__init__.py:40-55).
"""

import hashlib
import random
import time
from typing import List, Union

import numpy as np
import torch


def set_seed(seed: int):
    """Seed python, numpy and torch's default generators.

    Port code takes explicit ``torch.Generator``s and ``numpy`` generators;
    this only pins the global ones for scripts that use them."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def hexdigest(x: str, /) -> str:
    """The md5 hex digest of ``x`` (the key of a transform's cached output)."""
    return hashlib.md5(x.encode()).hexdigest()


def default(value, default_value):
    return default_value if value is None else value


def is_numeric(s) -> bool:
    try:
        float(s)
        return True
    except (TypeError, ValueError):
        return False


def as_numpy(x) -> np.ndarray:
    """A tensor copied to the host, anything else through ``np.asarray``
    (counterpart: dance_tpu/utils/wrappers.py, ``as_numpy``)."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def resolve_device(device: Union[str, torch.device] = "auto") -> torch.device:
    """``"auto"`` is the current CUDA device. The CPU is used only when the
    caller names it: with no card, ``"auto"`` and CUDA devices raise instead
    of falling back."""
    if isinstance(device, str) and device == "auto":
        if not torch.cuda.is_available():
            raise RuntimeError("device='auto' is the CUDA card, but torch.cuda.is_available() "
                               "is False; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but torch.cuda.is_available() is False")
    return device


def acc(true, pred) -> float:
    """Accuracy, multi-positive aware (counterpart: metrics.py:36).

    ``true`` is either a (n, k) one/multi-hot matrix, where a prediction counts
    as correct when it hits any positive, or a (n,) integer label vector."""
    true, pred = np.asarray(true), np.asarray(pred).ravel()
    if true.ndim == 2:
        # out-of-range predictions (e.g. -1 for "unsure") count as incorrect
        valid = (pred >= 0) & (pred < true.shape[1])
        hits = np.zeros(pred.shape[0], dtype=float)
        hits[valid] = true[np.nonzero(valid)[0], pred[valid]]
        return float(hits.mean())
    return float((true.ravel() == pred).mean())


def ari(true, pred) -> float:
    """Adjusted Rand index of two labelings (counterpart: metrics.py:55, which
    calls sklearn's ``adjusted_rand_score``; the same pair-counting formula,
    in exact integers, in numpy)."""
    true, pred = np.asarray(true).ravel(), np.asarray(pred).ravel()
    if true.shape != pred.shape:
        raise ValueError(f"ari: labelings of different lengths {true.shape} and {pred.shape}")
    n = true.shape[0]
    if n == 0:
        return 1.0
    _, ti = np.unique(true, return_inverse=True)
    _, pi = np.unique(pred, return_inverse=True)
    n_p = int(pi.max()) + 1
    cont = np.bincount(ti * n_p + pi, minlength=(int(ti.max()) + 1) * n_p)
    cont = cont.reshape(-1, n_p).astype(np.int64)
    sum_squares = int((cont ** 2).sum())
    fp = int((cont @ cont.sum(0)).sum()) - sum_squares  # pairs split by pred only
    fn = int((cont.T @ cont.sum(1)).sum()) - sum_squares  # pairs split by true only
    tp = sum_squares - n
    tn = n * n - fp - fn - sum_squares
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn))


def _entropy(labels: np.ndarray) -> float:
    """sklearn's ``entropy`` of a labeling (natural log; 0 for one cluster)."""
    pi = np.bincount(np.unique(labels, return_inverse=True)[1]).astype(np.float64)
    pi = pi[pi > 0]
    if pi.size <= 1:
        return 0.0
    total = pi.sum()
    return float(-np.sum((pi / total) * (np.log(pi) - np.log(total))))


def nmi(true, pred, average_method: str = "max") -> float:
    """Normalised mutual information (counterpart: metrics.py:92, sklearn's
    ``normalized_mutual_info_score``): MI over the ``average_method`` mean of
    the two entropies, ``"max"`` (the JAX package's ``nmi``) or
    ``"arithmetic"`` (``nmi_opt_louvain``, scib_metrics.py:68); 1 where both
    labelings are one cluster, 0 where MI is 0."""
    if average_method not in _AVERAGES:
        raise ValueError(f"average_method must be one of {sorted(_AVERAGES)}, got "
                         f"{average_method!r}")
    true, pred = np.asarray(true).ravel(), np.asarray(pred).ravel()
    _, ti = np.unique(true, return_inverse=True)
    _, pi = np.unique(pred, return_inverse=True)
    n_t, n_p = int(ti.max(initial=-1)) + 1, int(pi.max(initial=-1)) + 1
    if n_t == n_p and n_t <= 1:
        return 1.0
    cont = np.bincount(ti * n_p + pi, minlength=n_t * n_p).reshape(n_t, n_p)
    if n_t == 1 or n_p == 1:
        return 0.0
    rows, cols = np.nonzero(cont)
    nz = cont[rows, cols].astype(np.float64)
    total = nz.sum()
    a, b = cont.sum(1).astype(np.int64), cont.sum(0).astype(np.int64)
    log_outer = -np.log(a[rows] * b[cols]) + np.log(a.sum()) + np.log(b.sum())
    terms = nz / total * (np.log(nz) - np.log(total)) + nz / total * log_outer
    terms = np.where(np.abs(terms) < np.finfo(np.float64).eps, 0.0, terms)
    mi = max(float(terms.sum()), 0.0)
    if mi == 0.0:
        return 0.0
    return mi / _AVERAGES[average_method](_entropy(true), _entropy(pred))


# sklearn's ``_generalized_average`` of the two entropies, the two the JAX package uses
_AVERAGES = {"max": max, "arithmetic": lambda u, v: (u + v) / 2}


def mse(true, pred) -> float:
    """Mean squared error over every entry (counterpart: metrics.py:98)."""
    true, pred = np.asarray(true), np.asarray(pred)
    err = (true - pred) ** 2
    return float(err.mean(axis=0).mean() if err.ndim == 2 else err.mean())


def rmse(true, pred) -> float:
    """Root of :func:`mse` (counterpart: metrics.py:104)."""
    return float(np.sqrt(mse(true, pred)))


def mape(true, pred) -> float:
    """Mean absolute percentage error, ``|pred - true| / max(|true|, eps)``
    (float64 eps) averaged over each column, then over the columns
    (counterpart: metrics.py:111, scikit-learn's
    ``mean_absolute_percentage_error``)."""
    true, pred = np.asarray(true, np.float64), np.asarray(pred, np.float64)
    err = np.abs(pred - true) / np.maximum(np.abs(true), np.finfo(np.float64).eps)
    return float(err.mean(axis=0).mean() if err.ndim == 2 else err.mean())


def roc_auc(labels, scores) -> float:
    """The area under the ROC curve of binary ``labels`` (1 positive) ranked
    by ``scores`` (scikit-learn's ``roc_auc_score``): the Mann-Whitney
    statistic, tied scores taking the average of their ranks, which is the
    trapezoid area of the ROC curve whose points are the distinct scores."""
    from scipy.stats import rankdata

    labels = np.asarray(labels).ravel() == 1
    n_pos, n_neg = int(labels.sum()), int((~labels).sum())
    if n_pos == 0 or n_neg == 0:
        raise ValueError("roc_auc needs both classes in labels")
    ranks = rankdata(np.asarray(scores, np.float64).ravel())  # ties: the average rank
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def average_precision(labels, scores) -> float:
    """Average precision of binary ``labels`` ranked by ``scores``
    (scikit-learn's ``average_precision_score``): the step sum over the
    distinct scores, highest first, of each step's recall gain times its
    precision, tied scores forming one step."""
    labels = np.asarray(labels).ravel() == 1
    scores = np.asarray(scores, np.float64).ravel()
    if not labels.any():
        raise ValueError("average_precision needs a positive label")
    order = np.argsort(scores, kind="mergesort")[::-1]
    scores, labels = scores[order], labels[order]
    last = np.r_[np.nonzero(np.diff(scores))[0], scores.size - 1]  # end of each tie group
    tps = np.cumsum(labels, dtype=np.float64)[last]
    precision = tps / (last + 1)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def ood_measures(ind_scores, ood_scores):
    """``(auroc, aupr, fpr@95)`` of OOD scores where in-distribution nodes
    score higher (counterpart: metrics.py:197): AUROC and AUPR of telling
    the in-distribution scores (positive) from the OOD ones, and the share
    of OOD scores at or above the 5th percentile of the in-distribution
    ones."""
    ind = np.asarray(ind_scores, dtype=np.float64).ravel()
    ood = np.asarray(ood_scores, dtype=np.float64).ravel()
    if len(ind) == 0 or len(ood) == 0:
        raise ValueError("ood_measures needs non-empty ind and ood score sets "
                         f"(got {len(ind)} ind, {len(ood)} ood)")
    scores = np.concatenate([ind, ood])
    labels = np.concatenate([np.ones_like(ind), np.zeros_like(ood)])
    thresh = np.percentile(ind, 5)  # keep 95 % of ind above the threshold
    return (roc_auc(labels, scores), average_precision(labels, scores),
            float((ood >= thresh).mean()))


def labeled_clustering_evaluate(emb, true_labels, n_clusters: int = 10,
                                random_state: int = 200, device=None) -> dict:
    """k-means (5 restarts) of an embedding scored against known labels:
    ``{"dance_nmi", "dance_ari"}`` rounded to 3 places (counterpart:
    metrics.py:168, which runs sklearn's ``KMeans``; here the port's
    :func:`~dance_tpu_torch.ops.cluster.kmeans`, seeded with
    ``random_state``, on ``device``: the card unless the CPU is named)."""
    from dance_tpu_torch.ops.cluster import kmeans
    from dance_tpu_torch.settings import logger

    true_labels = np.asarray(true_labels).ravel()
    pred = kmeans(np.asarray(emb, np.float32), n_clusters, n_init=5, seed=random_state,
                  device=device).labels.cpu().numpy()
    scores = {"dance_nmi": round(nmi(true_labels, pred), 3),
              "dance_ari": round(ari(true_labels, pred), 3)}
    logger.info("NMI: %s ARI: %s", scores["dance_nmi"], scores["dance_ari"])
    return scores


class EpochClock:
    """Seconds per epoch of a training loop that reads nothing back per epoch.

    ``tick()`` at the start of every epoch and once after the last. On a
    CUDA device each tick records an event on the current stream, and
    :meth:`seconds` waits for the last one and returns the device-timeline
    span between consecutive ticks (host gaps that leave the device idle
    included); on the CPU it is ``time.perf_counter``."""

    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks: list = []

    def tick(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self) -> List[float]:
        if not self.cuda:
            return [b - a for a, b in zip(self.marks[:-1], self.marks[1:])]
        if self.marks:
            self.marks[-1].synchronize()
        return [a.elapsed_time(b) / 1e3 for a, b in zip(self.marks[:-1], self.marks[1:])]


__all__ = ["EpochClock", "acc", "ari", "as_numpy", "average_precision", "default", "hexdigest",
           "is_numeric", "labeled_clustering_evaluate", "mape", "mse", "nmi", "ood_measures",
           "resolve_device", "rmse", "roc_auc", "set_seed"]
