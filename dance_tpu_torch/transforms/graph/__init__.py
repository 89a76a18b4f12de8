"""Graph construction on arrays, and the container transforms the model
pipelines run (counterpart: dance_tpu/transforms/graph/)."""

from dance_tpu_torch.transforms.graph.cell_feature_graph import (CellFeatureBipartiteGraph,
                                                                 CellFeatureGraph,
                                                                 PCACellFeatureGraph)
from dance_tpu_torch.transforms.graph.dstg_graph import dstg_link_graph
from dance_tpu_torch.transforms.graph.feature_feature_graph import feature_feature_graph
from dance_tpu_torch.transforms.graph.heteronet_graph import heteronet_graph
from dance_tpu_torch.transforms.graph.neighbor_graph import neighbor_graph
from dance_tpu_torch.transforms.graph.resept_graph import RESEPTGraph
from dance_tpu_torch.transforms.graph.scmogcn_graph import (construct_enhanced_feature_graph,
                                                            create_pathway_graph, read_gmt,
                                                            scmognn_graph)
from dance_tpu_torch.transforms.graph.spatial_graph import (StagateGraph, sme_graph,
                                                            spagcn_graph, spagcn_graph_2d,
                                                            stagate_graph)

__all__ = ["CellFeatureBipartiteGraph", "CellFeatureGraph", "PCACellFeatureGraph", "RESEPTGraph",
           "StagateGraph", "construct_enhanced_feature_graph", "create_pathway_graph",
           "dstg_link_graph", "feature_feature_graph", "heteronet_graph", "neighbor_graph",
           "read_gmt", "scmognn_graph", "sme_graph", "spagcn_graph",
           "spagcn_graph_2d", "stagate_graph"]
