"""The multi-rank dry run (counterpart: ``dryrun_multichip`` in the JAX
repository's ``__graft_entry__.py:83-140``, its first two passes).

``dryrun_multichip(n_ranks, backend, device)`` launches ``n_ranks`` ranks
and in each runs (1) ACTINN's distributed fit for one epoch on a pure-dp
mesh and (2) one dp x tp step of a ``VanillaMLP`` whose hidden layers are
column-sharded over ``tp = 2`` where ``n_ranks`` is even (else ``tp = 1``),
asserting finite outputs. :func:`dryrun_rank` is one rank's part, for a
caller whose ranks are already up. Run it as ``python -m
dance_tpu_torch.parallel.dryrun N [gloo|nccl] [cpu]``.
"""

import os
import sys
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

from dance_tpu_torch.parallel.mesh import get_mesh, launch, shard_batch
from dance_tpu_torch.parallel.train import init_sharded, make_sharded_train_step


def dryrun_rank(rank: int, n_ranks: int, report: str):
    """Both passes on this rank of an ``n_ranks`` process group; rank 0
    writes the summary line to the file ``report``."""
    from dance_tpu_torch.modules.single_modality.cell_type_annotation import ACTINN
    from dance_tpu_torch.nn.mlp import VanillaMLP

    dp_mesh = get_mesh((n_ranks, 1))
    dev = dp_mesh.device
    rng = np.random.default_rng(0)
    n_classes = 4
    x = rng.random((8 * n_ranks, 32), dtype=np.float32)
    y = np.eye(n_classes, dtype=np.float32)[rng.integers(0, n_classes, 8 * n_ranks)]
    model = ACTINN(hidden_dims=(16, 8), random_seed=0, device=dev)
    model.fit_distributed(x, y, mesh=dp_mesh, num_epochs=1, batch_size=4 * n_ranks, seed=0)
    pred = model.predict(x)
    assert pred.shape == (8 * n_ranks,)
    assert np.isfinite(model.history[-1]["loss"])

    tp = 2 if n_ranks % 2 == 0 else 1
    mesh = get_mesh((n_ranks // tp, tp))
    xb = rng.random((4 * n_ranks, 64), dtype=np.float32)
    yb = rng.integers(0, n_classes, 4 * n_ranks)
    net, opt = init_sharded(lambda: VanillaMLP(64, n_classes, (32, 16)),
                            lambda p: torch.optim.Adam(p, lr=1e-3), (xb, yb), mesh, seed=0,
                            tp_min_size=256)

    def loss_fn(module, batch):
        bx, by = batch
        return F.cross_entropy(module(bx), by)

    step = make_sharded_train_step(loss_fn, opt, mesh)
    loss = float(step(net, shard_batch((xb, yb.astype(np.int64)), mesh)))
    assert np.isfinite(loss), f"non-finite loss from sharded step: {loss}"
    if rank == 0:
        with open(report, "w") as f:
            f.write(f"dryrun_multichip({n_ranks}): dp fit OK (epoch loss "
                    f"{model.history[-1]['loss']:.4f}); dp x tp mesh={mesh.shape} "
                    f"loss={loss:.4f} OK\n")


def dryrun_multichip(n_ranks: int, backend: str = "nccl", device="auto",
                     timeout: float = 60.0) -> str:
    """Launch ``n_ranks`` ranks on ``backend`` and run both passes in each;
    returns rank 0's summary line (raises when a rank fails)."""
    with tempfile.TemporaryDirectory(prefix="dtt_dryrun_") as tmp:
        report = os.path.join(tmp, "report.txt")
        launch(dryrun_rank, n_ranks, backend, device, args=(n_ranks, report),
               rendezvous_dir=tmp, timeout=timeout)
        with open(report) as f:
            line = f.read().strip()
    print(line)
    return line


if __name__ == "__main__":
    args = sys.argv[1:]
    dryrun_multichip(int(args[0]) if args else 2, args[1] if len(args) > 1 else "nccl",
                     args[2] if len(args) > 2 else "auto")
