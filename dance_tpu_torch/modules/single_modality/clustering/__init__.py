"""Clustering methods (counterpart:
dance_tpu/modules/single_modality/clustering/__init__.py). Only graph-sc is
ported so far."""

from dance_tpu_torch.modules.single_modality.clustering.graphsc import (
    GCNAE, GraphSC, InnerProductDecoder, graphsc_preprocess)

__all__ = ["GCNAE", "GraphSC", "InnerProductDecoder", "graphsc_preprocess"]
