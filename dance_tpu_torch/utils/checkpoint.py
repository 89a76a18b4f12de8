"""Checkpoint and resume (counterpart: dance_tpu/utils/checkpoint.py:24-56).

A training state (a nested dict of tensors, ``state_dict``s, numbers and
strings: weights, optimizer state, step) round-trips through ``torch.save``
and ``torch.load(weights_only=True)``, to the path as given. Under a mesh
(the ``mesh`` argument, or the surrounding data-parallel fit's), rank 0
writes and every rank then passes a barrier, so that a load after the save
sees the file on every rank. JAX's orbax branch has no counterpart; its
pickle branch appends ``.pkl``, this one writes ``path`` itself.
"""

import os
from typing import Any, Optional

import torch

from dance_tpu_torch.parallel.mesh import Mesh, active_dp_mesh, barrier, is_writer
from dance_tpu_torch.settings import logger


def _to_cpu(state):
    if isinstance(state, torch.Tensor):
        return state.detach().cpu()
    if isinstance(state, dict):
        return {k: _to_cpu(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_to_cpu(v) for v in state)
    return state


def save_checkpoint(path: str, state: Any, mesh: Optional[Mesh] = None) -> str:
    """Save ``state`` (tensors moved to the host) to ``path``; returns the
    absolute path (counterpart: checkpoint.py:24)."""
    mesh = mesh if mesh is not None else active_dp_mesh()
    path = os.path.abspath(path)
    if is_writer(mesh):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save(_to_cpu(state), tmp)
        os.replace(tmp, path)
        logger.info("Saved checkpoint to %s", path)
    barrier()
    return path


def load_checkpoint(path: str, target: Optional[Any] = None, map_location=None) -> Any:
    """Load a state saved by :func:`save_checkpoint` (counterpart:
    checkpoint.py:43), its tensors on ``map_location`` (the host when None).
    With ``target`` (an ``nn.Module`` or optimizer), the state is also
    loaded into it."""
    state = torch.load(os.path.abspath(path), map_location=map_location or "cpu",
                       weights_only=True)
    if target is not None:
        target.load_state_dict(state)
    logger.info("Loaded checkpoint from %s", path)
    return state


__all__ = ["load_checkpoint", "save_checkpoint"]
