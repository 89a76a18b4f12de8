"""Preprocessing on arrays (counterpart: dance_tpu/transforms/__init__.py)."""

from dance_tpu_torch.transforms.cell_feature import cell_pca, weighted_feature_pca
from dance_tpu_torch.transforms.filter import FilterGenesMarker, get_count
from dance_tpu_torch.transforms.graph import (dstg_link_graph, feature_feature_graph,
                                              heteronet_graph, neighbor_graph, stagate_graph)
from dance_tpu_torch.transforms.mask import CellwiseMaskData
from dance_tpu_torch.transforms.pseudobulk import CellTopicProfile, PseudoMixture

__all__ = ["CellTopicProfile", "CellwiseMaskData", "FilterGenesMarker", "PseudoMixture",
           "cell_pca", "dstg_link_graph", "feature_feature_graph", "get_count",
           "heteronet_graph", "neighbor_graph", "stagate_graph", "weighted_feature_pca"]
