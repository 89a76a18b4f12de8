"""Preprocessing on arrays, and the container transforms (``BaseTransform``,
``Compose``, ``SetConfig``, ``AnnDataTransform``, ...) that the model
pipelines run (counterpart: dance_tpu/transforms/__init__.py)."""

from dance_tpu_torch.transforms.base import AnnDataAdaptor, BaseTransform
from dance_tpu_torch.transforms.cell_feature import (BatchFeature, CellPCA, CellSparsePCA, CellSVD,
                                                     FeatureCellPlaceHolder, GaussRandProjFeature,
                                                     WeightedFeaturePCA, WeightedFeatureSVD,
                                                     cell_pca, weighted_feature_pca)
from dance_tpu_torch.transforms.filter import (FilterCellsCommonMod, FilterCellsPlaceHolder,
                                               FilterCellsScanpy, FilterCellsScanpyOrder,
                                               FilterCellsType, FilterCellTransform, FilterGenes,
                                               FilterGenesCommon, FilterGenesMarker,
                                               FilterGenesMarkerGini, FilterGenesMatch,
                                               FilterGenesNumberPlaceHolder,
                                               FilterGenesPercentile, FilterGenesPlaceHolder,
                                               FilterGenesRegression, FilterGenesScanpy,
                                               FilterGenesScanpyOrder, FilterGenesTopK,
                                               FilterScanpy,
                                               HighlyVariableGenesLogarithmizedByMeanAndDisp,
                                               HighlyVariableGenesLogarithmizedByTopGenes,
                                               HighlyVariableGenesRawCount, ScrubletTransform,
                                               get_count)
from dance_tpu_torch.transforms.gene_holdout import GeneHoldout
from dance_tpu_torch.transforms.graph import (CellFeatureBipartiteGraph, CellFeatureGraph,
                                              DSTGraph, FeatureFeatureGraph, HeteronetGraph,
                                              NeighborGraph, PCACellFeatureGraph, RESEPTGraph,
                                              SMEGraph, SpaGCNGraph, SpaGCNGraph2D,
                                              StagateGraph, dstg_link_graph,
                                              feature_feature_graph, heteronet_graph,
                                              neighbor_graph, sme_graph, spagcn_graph,
                                              spagcn_graph_2d, stagate_graph)
from dance_tpu_torch.transforms.interface import AnnDataTransform
from dance_tpu_torch.transforms.mask import CellwiseMaskData, MaskData
from dance_tpu_torch.transforms.misc import (AlignMod, Compose, RemoveSplit, SaveRaw, SetConfig,
                                             UpdateRaw)
from dance_tpu_torch.transforms.normalize import (ColumnSumNormalize, Log1P, NormalizePlaceHolder,
                                                  NormalizeTotal, NormalizeTotalLog1P,
                                                  ScTransform, ScTransformR, UpdateSizeFactors,
                                                  tfidfTransform)
from dance_tpu_torch.transforms.preprocess import (MaskedArray, SAINTRandomWalkSampler,
                                                   SAINTSampler, SubgraphSampler,
                                                   generate_random_pair, lsiTransformer,
                                                   tfidfTransformer)
from dance_tpu_torch.transforms.pseudobulk import (CellGiottoTopicProfile, CellTopicProfile,
                                                   CellTypeNums, PseudoMixture, get_giotto_dt)
from dance_tpu_torch.transforms.sc3_feature import SC3Feature
from dance_tpu_torch.transforms.scn_feature import SCNFeature
from dance_tpu_torch.transforms.spatial_feature import (MorphologyFeatureCNN, SMEFeature,
                                                        morphology_feature_cnn, sme_feature)
from dance_tpu_torch.transforms.stats import GeneStats

__all__ = ["AlignMod", "AnnDataAdaptor", "AnnDataTransform", "BaseTransform", "BatchFeature",
           "CellFeatureBipartiteGraph", "CellFeatureGraph", "CellGiottoTopicProfile", "CellPCA",
           "CellSVD", "CellSparsePCA", "Compose", "DSTGraph", "FeatureFeatureGraph",
           "HeteronetGraph", "MorphologyFeatureCNN", "NeighborGraph", "PCACellFeatureGraph",
           "RemoveSplit", "SMEFeature", "SMEGraph", "SaveRaw", "SetConfig", "SpaGCNGraph",
           "SpaGCNGraph2D", "StagateGraph", "UpdateRaw",
           "CellTopicProfile", "CellTypeNums", "CellwiseMaskData", "ColumnSumNormalize",
           "FeatureCellPlaceHolder", "FilterCellTransform", "FilterCellsCommonMod",
           "FilterCellsPlaceHolder", "FilterCellsScanpy", "FilterCellsScanpyOrder",
           "FilterCellsType", "FilterGenes", "FilterGenesCommon", "FilterGenesMarker",
           "FilterGenesMarkerGini", "FilterGenesMatch", "FilterGenesNumberPlaceHolder",
           "FilterGenesPercentile", "FilterGenesPlaceHolder", "FilterGenesRegression",
           "FilterGenesScanpy", "FilterGenesScanpyOrder", "FilterGenesTopK", "FilterScanpy",
           "GaussRandProjFeature", "GeneHoldout", "GeneStats",
           "HighlyVariableGenesLogarithmizedByMeanAndDisp",
           "HighlyVariableGenesLogarithmizedByTopGenes", "HighlyVariableGenesRawCount", "Log1P",
           "MaskData", "MaskedArray", "NormalizePlaceHolder", "NormalizeTotal",
           "NormalizeTotalLog1P", "PseudoMixture", "RESEPTGraph", "SAINTRandomWalkSampler",
           "SAINTSampler", "SC3Feature", "SCNFeature", "ScTransform", "ScTransformR",
           "ScrubletTransform", "SubgraphSampler", "UpdateSizeFactors", "WeightedFeaturePCA",
           "WeightedFeatureSVD", "cell_pca", "dstg_link_graph", "feature_feature_graph",
           "generate_random_pair", "get_count", "get_giotto_dt", "heteronet_graph",
           "lsiTransformer", "morphology_feature_cnn", "neighbor_graph", "sme_feature",
           "sme_graph", "spagcn_graph", "spagcn_graph_2d", "stagate_graph", "tfidfTransform",
           "tfidfTransformer", "weighted_feature_pca"]
