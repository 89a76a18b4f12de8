"""Vmapped multi-trial training: a hyperparameter fan-out as a batch axis
(counterpart: dance_tpu/parallel/trials.py:23-136).

N trials' parameters are stacked on a leading axis and every step advances
all of them at once: ``torch.func.vmap`` over ``torch.func.grad_and_value``
of the loss, and Adam written out on the stacked tensors. Under a mesh the
trial axis splits over the ``dp`` ranks, each training its block with no
collective until the final gather.
"""

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dance_tpu_torch.parallel.mesh import Mesh, all_gather_rows, mesh_device
from dance_tpu_torch.settings import logger

# optax.adam's defaults
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _stack(trees):
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def vmapped_trials(init_fn: Callable[[int], Dict[str, torch.Tensor]], loss_fn: Callable, data,
                   *, seeds: Sequence[int], hyperparams: Optional[Dict[str, Sequence]] = None,
                   lr=1e-3, num_steps: int = 100, mesh: Optional[Mesh] = None,
                   device=None) -> Tuple[Dict[str, torch.Tensor], np.ndarray]:
    """Train N trials at once (counterpart: trials.py:23).

    ``init_fn(seed)`` returns one trial's parameters as a dict of tensors;
    ``loss_fn(params, data, hyper)`` is a scalar function of them (e.g.
    through ``torch.func.functional_call``), ``hyper`` a dict of this
    trial's scalars, one per entry of ``hyperparams`` (each N long). ``lr``
    is a scalar or N per-trial rates: Adam runs as optax's ``adam(1.0)``
    with each trial's update scaled by its rate (trials.py:95-108). Under
    ``mesh`` the trial axis is padded to a multiple of the ``dp`` size by
    repeating the last trial and split over its ranks; the padding
    trials are dropped from the result. ``device`` defaults to the mesh's,
    else to the card: the CPU only when named.

    Returns ``(stacked_params, losses)``: each parameter stacked on axis 0,
    and the (num_steps, N) loss history, on every rank."""
    n = len(seeds)
    seeds = list(seeds)
    hyper = {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in
             (hyperparams or {}).items()}
    for k, v in hyper.items():
        if v.shape[0] != n:
            raise ValueError(f"hyperparams[{k!r}] has {v.shape[0]} entries, need {n}")
    if hasattr(lr, "__len__"):
        lr_arr = torch.as_tensor(np.asarray(lr, np.float32))
        if lr_arr.shape[0] != n:
            raise ValueError(f"lr has {lr_arr.shape[0]} entries, need {n}")
    else:
        lr_arr = torch.full((n,), float(lr), dtype=torch.float32)
    device = mesh_device(mesh, device)
    size = mesh.size("dp") if mesh is not None else 1
    mine = slice(None)
    if size > 1:
        extra = (-n) % size
        seeds = seeds + [seeds[-1]] * extra
        hyper = {k: torch.cat([v, v[-1:].repeat(extra)]) for k, v in hyper.items()}
        lr_arr = torch.cat([lr_arr, lr_arr[-1:].repeat(extra)])
        per = (n + extra) // size
        i = mesh.index("dp")
        mine = slice(i * per, (i + 1) * per)
    params = {k: v.to(device) for k, v in _stack([init_fn(int(s)) for s in seeds[mine]]).items()}
    hyper = {k: v[mine].to(device) for k, v in hyper.items()}
    lr_arr = lr_arr[mine].to(device)
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    step_fn = torch.func.vmap(torch.func.grad_and_value(loss_fn), in_dims=(0, None, 0))
    losses = []
    for t in range(1, num_steps + 1):
        grads, loss = step_fn(params, data, hyper)
        c1 = 1.0 - torch.tensor(_B1, dtype=torch.float32) ** t
        c2 = 1.0 - torch.tensor(_B2, dtype=torch.float32) ** t
        new = {}
        for k, p in params.items():
            g = grads[k]
            mu[k] = (1.0 - _B1) * g + _B1 * mu[k]
            nu[k] = (1.0 - _B2) * g * g + _B2 * nu[k]
            upd = -((mu[k] / c1.to(device)) / (torch.sqrt(nu[k] / c2.to(device)) + _EPS))
            new[k] = p + upd * lr_arr.reshape((-1,) + (1,) * (p.dim() - 1))
        params = new
        losses.append(loss.detach())
    losses = torch.stack(losses)
    if size > 1:
        params = {k: all_gather_rows(v, mesh)[:n] for k, v in params.items()}
        losses = all_gather_rows(losses.T, mesh)[:n].T
    losses = losses.cpu().numpy()
    logger.info("Ran %d trials x %d steps vmapped; final losses: %s", n, num_steps,
                np.round(losses[-1], 4).tolist())
    return params, losses


def select_best_trial(stacked_params: Dict[str, torch.Tensor], scores, maximize: bool = True):
    """The winning trial's parameters and its index (counterpart: trials.py:130)."""
    scores = np.asarray(scores)
    idx = int(np.argmax(scores) if maximize else np.argmin(scores))
    return {k: v[idx] for k, v in stacked_params.items()}, idx


__all__ = ["select_best_trial", "vmapped_trials"]
