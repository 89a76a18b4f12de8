"""Graph construction on arrays (counterpart: dance_tpu/transforms/graph/)."""

from dance_tpu_torch.transforms.graph.spatial_graph import stagate_graph

__all__ = ["stagate_graph"]
