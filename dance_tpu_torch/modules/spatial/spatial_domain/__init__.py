"""Spatial-domain identification (counterpart:
dance_tpu/modules/spatial/spatial_domain/__init__.py); STAGATE only so far."""

from dance_tpu_torch.modules.spatial.spatial_domain.stagate import (Stagate, StagateNet,
                                                                    stagate_preprocess)

__all__ = ["Stagate", "StagateNet", "stagate_preprocess"]
