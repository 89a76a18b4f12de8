"""Optimizer helpers the models share: optax's ``clip_by_global_norm``,
which the JAX models chain before Adam or AdamW (STAGATE stagate.py:146,
stdGCN stdgcn.py:445), optax's AMSGrad, which scDeepCluster and scDCC
pretrain with (scdeepcluster.py:185), optax's ``adamw`` with its decay on
every weight and its ``eps`` (match-modality scMoGNN, scMoGNN v2, scMVAE), a learning rate set
between epochs, and the copy of the weights that best-validation selection
keeps (scMoGNN, stdGCN, scMVAE's lowest training loss).

Where torch's own optimizer is optax's, the models use it:

- ``torch.optim.Adadelta(params, lr, rho=0.95, eps=1e-6)`` is
  ``optax.adadelta(lr, rho=0.95)`` (eps 1e-6 in both; the same
  ``sqrt(E[dx²] + eps) / sqrt(E[g²] + eps) · g``), the DEC stage of
  scDeepCluster and scDCC;
- ``torch.optim.lr_scheduler.StepLR(opt, 1000, 0.95)``, stepped once after
  every optimizer step, is optax's ``exponential_decay(lr, 1000, 0.95,
  staircase=True)``: optax reads the schedule at the count before the step,
  so step ``t`` (from 1) takes ``lr · 0.95^floor((t - 1) / 1000)``, as StepLR
  gives it (ACTINN).

Both are held against optax over 1,200 steps in ``tests/test_torch_actinn.py``
and ``tests/test_torch_scdeepcluster.py``.
"""

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


def adamw(params, lr: float, weight_decay: float = 1e-4, eps: float = 1e-8) -> torch.optim.AdamW:
    """optax's ``adamw(lr, weight_decay=weight_decay, eps=eps)`` over a
    module's parameters (or an iterable of them): the decay on every weight,
    biases and logits included, ``p -= lr · (m̂ / (sqrt(v̂) + eps) +
    weight_decay · p)``, which is torch's decoupled ``AdamW`` step (both add
    ``eps`` outside the root; optax's ``eps_root`` is 0). optax's default
    decay is 1e-4 (match-modality scMoGNN); scMoGNN v2 passes 1e-5, scMVAE
    1e-6 with eps 0.01. torch's own default decay is 0.01."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    return torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay, eps=eps)


def set_learning_rate(opt: torch.optim.Optimizer, lr: float):
    """Set every parameter group's learning rate, between steps: optax's
    ``inject_hyperparams`` state written before the next update (AdamW's
    decay takes the new rate too, as optax's does)."""
    for group in opt.param_groups:
        group["lr"] = lr


def best_state(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A copy of the weights, for best-validation selection: ``state_dict()``
    holds the very tensors the optimizer updates in place."""
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


class amsgrad(torch.optim.Optimizer):
    """optax's ``amsgrad(lr, b1, b2, eps)`` (``scale_by_amsgrad`` then the
    learning rate), term for term: with ``t`` the step from 1,

        mu = (1 - b1) g + b1 mu;   nu = (1 - b2) g² + b2 nu
        nu_max = max(nu_max, nu / (1 - b2^t))
        p -= lr · (mu / (1 - b1^t)) / (sqrt(nu_max) + eps)

    ``torch.optim.Adam(amsgrad=True)`` differs from step 2 on: it keeps the
    running max of the raw ``nu`` and divides that by the current step's
    correction. A parameter whose gradient is ``None`` is skipped, as torch's
    optimizers skip it. The name is optax's function's."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p].update(step=0, mu=torch.zeros_like(p), nu=torch.zeros_like(p),
                                         nu_max=torch.zeros_like(p))
            states = [self.state[p] for p in params]
            b1, b2 = group["b1"], group["b2"]
            # one step count for the group, as optax keeps one for the tree
            t = states[0]["step"] + 1
            for s in states:
                s["step"] = t
            grads = [p.grad for p in params]
            mus, nus, nu_max = ([s[k] for s in states] for k in ("mu", "nu", "nu_max"))
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
            torch._foreach_maximum_(nu_max, torch._foreach_div(nus, 1 - b2 ** t))
            denom = torch._foreach_sqrt(nu_max)
            torch._foreach_add_(denom, group["eps"])
            updates = torch._foreach_div(mus, 1 - b1 ** t)
            torch._foreach_div_(updates, denom)
            torch._foreach_mul_(updates, -group["lr"])
            torch._foreach_add_(params, updates)
        return loss


__all__ = ["adamw", "amsgrad", "best_state", "clip_by_global_norm_", "set_learning_rate"]
