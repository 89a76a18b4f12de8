"""Clustering methods (counterpart:
dance_tpu/modules/single_modality/clustering/__init__.py). Ported so far:
graph-sc, scTAG and scDSC."""

from dance_tpu_torch.modules.single_modality.clustering.graphsc import (
    GCNAE, GraphSC, InnerProductDecoder, graphsc_preprocess)
from dance_tpu_torch.modules.single_modality.clustering.scdsc import (ScDSC, ScDSCModel,
                                                                      scdsc_preprocess)
from dance_tpu_torch.modules.single_modality.clustering.sctag import ScTAG, sctag_preprocess

__all__ = ["GCNAE", "GraphSC", "InnerProductDecoder", "ScDSC", "ScDSCModel", "ScTAG",
           "graphsc_preprocess", "scdsc_preprocess", "sctag_preprocess"]
