"""Scale-out on ``torch.distributed`` (counterpart: dance_tpu/parallel/): the
rank mesh with ``dp`` and ``tp`` axes, placement and collectives
(:mod:`.mesh`), the block-row-sharded adjacency (:mod:`.sharded_graph`), the
dp x tp training step (:mod:`.train`), vmapped trials (:mod:`.trials`) and
the multi-rank dry run (:mod:`.dryrun`)."""

from dance_tpu_torch.parallel.mesh import (current_mesh, dp_context, get_mesh, launch,
                                           replicate, shard_batch, shard_params_for_tp,
                                           to_device)

__all__ = ["current_mesh", "dp_context", "get_mesh", "launch", "replicate", "shard_batch",
           "shard_params_for_tp", "to_device"]
