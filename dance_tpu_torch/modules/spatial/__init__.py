"""Spatial methods (counterpart: dance_tpu/modules/spatial/): spatial
domains (STAGATE, Louvain) and cell-type deconvolution (DSTG, stdGCN)."""

from dance_tpu_torch.modules.spatial.cell_type_deconvo import (DSTG, StdGCN, dstg_preprocess,
                                                               stdGCNWrapper)
from dance_tpu_torch.modules.spatial.spatial_domain import (Louvain, Stagate, StagateNet,
                                                            louvain_preprocess, stagate_preprocess)

__all__ = ["DSTG", "Louvain", "StdGCN", "Stagate", "StagateNet", "dstg_preprocess",
           "louvain_preprocess", "stagate_preprocess", "stdGCNWrapper"]
