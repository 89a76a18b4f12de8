"""Cell-type deconvolution of spatial spots (counterpart:
dance_tpu/modules/spatial/cell_type_deconvo/__init__.py); the graph methods
DSTG and stdGCN so far. CARD, SpatialDecon and SPOTlight are not ported yet
(ROADMAP Queue 1)."""

from dance_tpu_torch.modules.spatial.cell_type_deconvo.dstg import DSTG, dstg_preprocess
from dance_tpu_torch.modules.spatial.cell_type_deconvo.stdgcn import StdGCN, stdGCNWrapper

__all__ = ["DSTG", "StdGCN", "dstg_preprocess", "stdGCNWrapper"]
