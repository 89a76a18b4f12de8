"""Preprocessing on arrays (counterpart: dance_tpu/transforms/__init__.py)."""

from dance_tpu_torch.transforms.cell_feature import weighted_feature_pca
from dance_tpu_torch.transforms.graph import stagate_graph

__all__ = ["stagate_graph", "weighted_feature_pca"]
