"""Cell-type deconvolution of spatial spots (counterpart:
dance_tpu/modules/spatial/cell_type_deconvo/__init__.py): CARD, DSTG,
SpatialDecon, SPOTlight and stdGCN, every method of the JAX package."""

from dance_tpu_torch.modules.spatial.cell_type_deconvo.card import Card, card_preprocess
from dance_tpu_torch.modules.spatial.cell_type_deconvo.dstg import (DSTG, deconvo_container,
                                                                    dstg_preprocess)
from dance_tpu_torch.modules.spatial.cell_type_deconvo.spatialdecon import (
    SpatialDecon, spatialdecon_preprocess)
from dance_tpu_torch.modules.spatial.cell_type_deconvo.spotlight import SPOTlight
from dance_tpu_torch.modules.spatial.cell_type_deconvo.stdgcn import (StdGCN, stdGCNMarkGenes,
                                                                      stdGCNWrapper,
                                                                      stdgcn_marker_genes,
                                                                      stdgcn_preprocess)

__all__ = ["Card", "DSTG", "SPOTlight", "SpatialDecon", "StdGCN", "card_preprocess",
           "deconvo_container", "dstg_preprocess", "spatialdecon_preprocess", "stdGCNMarkGenes",
           "stdGCNWrapper", "stdgcn_marker_genes", "stdgcn_preprocess"]
