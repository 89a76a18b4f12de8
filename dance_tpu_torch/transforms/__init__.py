"""Preprocessing on arrays (counterpart: dance_tpu/transforms/__init__.py)."""

from dance_tpu_torch.transforms.cell_feature import cell_pca, weighted_feature_pca
from dance_tpu_torch.transforms.graph import neighbor_graph, stagate_graph

__all__ = ["cell_pca", "neighbor_graph", "stagate_graph", "weighted_feature_pca"]
