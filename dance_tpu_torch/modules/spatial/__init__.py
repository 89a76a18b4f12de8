"""Spatial methods (counterpart: dance_tpu/modules/spatial/): spatial
domains (STAGATE, Louvain, SpaGCN, stLearn, EfNST) and cell-type
deconvolution (CARD, DSTG, SpatialDecon, SPOTlight, stdGCN)."""

from dance_tpu_torch.modules.spatial.cell_type_deconvo import (DSTG, SPOTlight, Card,
                                                               SpatialDecon, StdGCN,
                                                               card_preprocess, dstg_preprocess,
                                                               spatialdecon_preprocess,
                                                               stdGCNWrapper)
from dance_tpu_torch.modules.spatial.spatial_domain import (EfNsSTRunner, Louvain, SpaGCN,
                                                            StKmeans, StLouvain, Stagate,
                                                            StagateNet, efnst_preprocess,
                                                            louvain_preprocess, sme_preprocess,
                                                            spagcn_preprocess, stagate_preprocess)

__all__ = ["Card", "DSTG", "EfNsSTRunner", "Louvain", "SPOTlight", "SpaGCN", "SpatialDecon",
           "StKmeans", "StLouvain", "StdGCN", "Stagate", "StagateNet", "card_preprocess",
           "dstg_preprocess", "efnst_preprocess", "louvain_preprocess", "sme_preprocess",
           "spagcn_preprocess", "spatialdecon_preprocess", "stagate_preprocess",
           "stdGCNWrapper"]
