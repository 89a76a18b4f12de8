"""Spatial methods (counterpart: dance_tpu/modules/spatial/): spatial
domains (STAGATE, Louvain, SpaGCN, stLearn, EfNST) and cell-type
deconvolution (DSTG, stdGCN)."""

from dance_tpu_torch.modules.spatial.cell_type_deconvo import (DSTG, StdGCN, dstg_preprocess,
                                                               stdGCNWrapper)
from dance_tpu_torch.modules.spatial.spatial_domain import (EfNsSTRunner, Louvain, SpaGCN,
                                                            StKmeans, StLouvain, Stagate,
                                                            StagateNet, efnst_preprocess,
                                                            louvain_preprocess, sme_preprocess,
                                                            spagcn_preprocess, stagate_preprocess)

__all__ = ["DSTG", "EfNsSTRunner", "Louvain", "SpaGCN", "StKmeans", "StLouvain",
           "StdGCN", "Stagate", "StagateNet", "dstg_preprocess", "efnst_preprocess",
           "louvain_preprocess", "sme_preprocess", "spagcn_preprocess", "stagate_preprocess",
           "stdGCNWrapper"]
