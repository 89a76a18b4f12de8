"""Optimizer helpers the models share: optax's ``clip_by_global_norm``,
which the JAX models chain before Adam or AdamW (STAGATE stagate.py:146,
stdGCN stdgcn.py:445), and the copy of the weights that best-validation
selection keeps (scMoGNN, stdGCN)."""

from typing import Dict, Iterable

import torch


def clip_by_global_norm_(params: Iterable[torch.nn.Parameter], max_norm: float):
    """optax ``clip_by_global_norm`` in place: every gradient times ``max /
    norm`` when the global norm is at least ``max``, untouched below; no host
    sync. ``torch.nn.utils.clip_grad_norm_`` differs: it divides by ``norm +
    1e-6`` always."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


def best_state(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A copy of the weights, for best-validation selection: ``state_dict()``
    holds the very tensors the optimizer updates in place."""
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


__all__ = ["best_state", "clip_by_global_norm_"]
