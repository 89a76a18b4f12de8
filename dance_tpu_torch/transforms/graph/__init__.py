"""Graph construction on arrays (counterpart: dance_tpu/transforms/graph/)."""

from dance_tpu_torch.transforms.graph.neighbor_graph import neighbor_graph
from dance_tpu_torch.transforms.graph.spatial_graph import stagate_graph

__all__ = ["neighbor_graph", "stagate_graph"]
