"""Preprocessing on arrays (counterpart: dance_tpu/transforms/__init__.py)."""

from dance_tpu_torch.transforms.cell_feature import cell_pca, weighted_feature_pca
from dance_tpu_torch.transforms.filter import (FilterGenes, FilterGenesCommon, FilterGenesMarker,
                                               FilterGenesMatch, FilterGenesPercentile,
                                               FilterGenesTopK, get_count)
from dance_tpu_torch.transforms.gene_holdout import GeneHoldout
from dance_tpu_torch.transforms.graph import (dstg_link_graph, feature_feature_graph,
                                              heteronet_graph, neighbor_graph, sme_graph,
                                              spagcn_graph, spagcn_graph_2d, stagate_graph)
from dance_tpu_torch.transforms.mask import CellwiseMaskData
from dance_tpu_torch.transforms.preprocess import generate_random_pair
from dance_tpu_torch.transforms.pseudobulk import (CellGiottoTopicProfile, CellTopicProfile,
                                                   CellTypeNums, PseudoMixture, get_giotto_dt)
from dance_tpu_torch.transforms.scn_feature import SCNFeature
from dance_tpu_torch.transforms.spatial_feature import morphology_feature_cnn, sme_feature
from dance_tpu_torch.transforms.stats import GeneStats

__all__ = ["CellGiottoTopicProfile", "CellTopicProfile", "CellTypeNums", "CellwiseMaskData",
           "FilterGenes", "FilterGenesCommon", "FilterGenesMarker", "FilterGenesMatch",
           "FilterGenesPercentile", "FilterGenesTopK", "GeneHoldout", "GeneStats",
           "PseudoMixture", "SCNFeature", "cell_pca", "dstg_link_graph", "feature_feature_graph",
           "generate_random_pair", "get_count", "get_giotto_dt", "heteronet_graph",
           "morphology_feature_cnn", "neighbor_graph", "sme_feature", "sme_graph",
           "spagcn_graph", "spagcn_graph_2d", "stagate_graph", "weighted_feature_pca"]
