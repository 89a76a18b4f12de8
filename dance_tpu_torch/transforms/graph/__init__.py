"""Graph construction on arrays, and the container transforms the model
pipelines run (counterpart: dance_tpu/transforms/graph/)."""

from dance_tpu_torch.transforms.graph.cell_feature_graph import (CellFeatureBipartiteGraph,
                                                                 CellFeatureGraph,
                                                                 PCACellFeatureGraph)
from dance_tpu_torch.transforms.graph.dstg_graph import DSTGraph, dstg_link_graph
from dance_tpu_torch.transforms.graph.feature_feature_graph import (FeatureFeatureGraph,
                                                                    feature_feature_graph)
from dance_tpu_torch.transforms.graph.heteronet_graph import HeteronetGraph, heteronet_graph
from dance_tpu_torch.transforms.graph.neighbor_graph import NeighborGraph, neighbor_graph
from dance_tpu_torch.transforms.graph.resept_graph import RESEPTGraph
from dance_tpu_torch.transforms.graph.scmogcn_graph import (construct_enhanced_feature_graph,
                                                            create_pathway_graph, read_gmt,
                                                            scmognn_graph)
from dance_tpu_torch.transforms.graph.spatial_graph import (SMEGraph, SpaGCNGraph,
                                                            SpaGCNGraph2D, StagateGraph,
                                                            sme_graph, spagcn_graph,
                                                            spagcn_graph_2d, stagate_graph)

__all__ = ["CellFeatureBipartiteGraph", "CellFeatureGraph", "DSTGraph", "FeatureFeatureGraph",
           "HeteronetGraph", "NeighborGraph", "PCACellFeatureGraph", "RESEPTGraph", "SMEGraph",
           "SpaGCNGraph", "SpaGCNGraph2D", "StagateGraph", "construct_enhanced_feature_graph",
           "create_pathway_graph", "dstg_link_graph", "feature_feature_graph", "heteronet_graph",
           "neighbor_graph", "read_gmt", "scmognn_graph", "sme_graph", "spagcn_graph",
           "spagcn_graph_2d", "stagate_graph"]
