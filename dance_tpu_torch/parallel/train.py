"""The dp x tp training step (counterpart: dance_tpu/parallel/train.py:20-50).

The batch rides ``dp`` (each rank a block of its rows, :func:`shard_batch`),
large ``nn.Linear`` layers are column-sharded over ``tp``
(:func:`shard_params_for_tp`, whose layers gather their own outputs), and
the step sums the gradients over ``dp``: XLA's inserted collectives, written
out.
"""

from typing import Callable

import torch
from torch import nn

from dance_tpu_torch.parallel.mesh import Mesh, mesh_device, shard_params_for_tp, sync_grads


def make_sharded_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                            mesh: Mesh) -> Callable:
    """Return ``step(module, batch) -> loss`` (counterpart: train.py:20).

    ``loss_fn(module, batch)`` is the mean over this rank's rows of the batch
    (its ``dp`` block, all blocks of one size as :func:`shard_batch` pads
    them); the step takes ``1 / dp`` of it as this rank's share, sums the
    gradients over ``dp`` and steps ``optimizer``. The returned loss is the
    global mean."""
    dp = mesh.size("dp")

    def step(module: nn.Module, batch) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        share = loss_fn(module, batch) / dp
        share.backward()
        loss = sync_grads(list(module.parameters()), mesh, extra=share.detach())
        optimizer.step()
        return share.detach() if loss is None else loss

    return step


def init_sharded(module_factory: Callable[[], nn.Module],
                 optimizer_factory: Callable, sample_batch, mesh: Mesh, seed: int = 0,
                 tp_min_size: int = 2048, device=None):
    """The module built under ``torch.manual_seed(seed)`` (restored after),
    on ``device`` (the mesh's when None; the CPU only when named), its large
    layers column-sharded over ``tp``, and its optimizer (counterpart:
    train.py:34). ``sample_batch`` is taken for JAX's signature: a torch
    module knows its shapes."""
    del sample_batch
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = module_factory()
    module = module.to(mesh_device(mesh, device))
    module = shard_params_for_tp(module, mesh, min_size=tp_min_size)
    return module, optimizer_factory(module.parameters())


__all__ = ["init_sharded", "make_sharded_train_step"]
