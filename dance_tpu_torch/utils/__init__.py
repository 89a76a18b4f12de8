"""Seeding, device resolution and accuracy.

Counterparts: ``set_seed`` dance_tpu/utils/__init__.py:99, ``get_device``
dance_tpu/utils/__init__.py:23 (here :func:`resolve_device`, over torch
devices), ``acc`` dance_tpu/utils/metrics.py:36.
"""

import random
from typing import Union

import numpy as np
import torch


def set_seed(seed: int):
    """Seed python, numpy and torch's default generators.

    Port code takes explicit ``torch.Generator``s and ``numpy`` generators;
    this only pins the global ones for scripts that use them."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def resolve_device(device: Union[str, torch.device] = "auto") -> torch.device:
    """``"auto"`` picks CUDA when present, else the CPU. Asking for CUDA
    where there is none raises instead of falling back."""
    if isinstance(device, str) and device == "auto":
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
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


__all__ = ["acc", "resolve_device", "set_seed"]
