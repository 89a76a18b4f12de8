"""Spatial-domain identification (counterpart:
dance_tpu/modules/spatial/spatial_domain/__init__.py): STAGATE, Louvain,
SpaGCN, stLearn's StKmeans and StLouvain, and EfNST."""

from dance_tpu_torch.modules.spatial.spatial_domain.EfNST import (EfNsSTRunner, Refiner,
                                                                  efnst_preprocess)
from dance_tpu_torch.modules.spatial.spatial_domain.louvain import Louvain, louvain_preprocess
from dance_tpu_torch.modules.spatial.spatial_domain.spagcn import SpaGCN, spagcn_preprocess
from dance_tpu_torch.modules.spatial.spatial_domain.stagate import (Stagate, StagateNet,
                                                                    stagate_preprocess)
from dance_tpu_torch.modules.spatial.spatial_domain.stlearn import (StKmeans, StLouvain,
                                                                    sme_preprocess)

__all__ = ["EfNsSTRunner", "Louvain", "Refiner", "SpaGCN", "StKmeans", "StLouvain", "Stagate",
           "StagateNet", "efnst_preprocess", "louvain_preprocess", "sme_preprocess",
           "spagcn_preprocess", "stagate_preprocess"]
