"""Preprocessing on arrays (counterpart: dance_tpu/transforms/__init__.py)."""

from dance_tpu_torch.transforms.cell_feature import cell_pca, weighted_feature_pca
from dance_tpu_torch.transforms.filter import (FilterGenes, FilterGenesMarker, FilterGenesMatch,
                                               FilterGenesPercentile, FilterGenesTopK, get_count)
from dance_tpu_torch.transforms.gene_holdout import GeneHoldout
from dance_tpu_torch.transforms.graph import (dstg_link_graph, feature_feature_graph,
                                              heteronet_graph, neighbor_graph, sme_graph,
                                              spagcn_graph, spagcn_graph_2d, stagate_graph)
from dance_tpu_torch.transforms.mask import CellwiseMaskData
from dance_tpu_torch.transforms.preprocess import generate_random_pair
from dance_tpu_torch.transforms.pseudobulk import CellTopicProfile, PseudoMixture
from dance_tpu_torch.transforms.spatial_feature import morphology_feature_cnn, sme_feature

__all__ = ["CellTopicProfile", "CellwiseMaskData", "FilterGenes", "FilterGenesMarker",
           "FilterGenesMatch", "FilterGenesPercentile", "FilterGenesTopK", "GeneHoldout",
           "PseudoMixture", "cell_pca", "dstg_link_graph", "feature_feature_graph",
           "generate_random_pair", "get_count", "heteronet_graph", "morphology_feature_cnn",
           "neighbor_graph", "sme_feature", "sme_graph", "spagcn_graph", "spagcn_graph_2d",
           "stagate_graph", "weighted_feature_pca"]
