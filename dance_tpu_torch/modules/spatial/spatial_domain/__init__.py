"""Spatial-domain identification (counterpart:
dance_tpu/modules/spatial/spatial_domain/__init__.py): STAGATE and Louvain."""

from dance_tpu_torch.modules.spatial.spatial_domain.louvain import Louvain, louvain_preprocess
from dance_tpu_torch.modules.spatial.spatial_domain.stagate import (Stagate, StagateNet,
                                                                    stagate_preprocess)

__all__ = ["Louvain", "Stagate", "StagateNet", "louvain_preprocess", "stagate_preprocess"]
