"""Clustering methods (counterpart:
dance_tpu/modules/single_modality/clustering/__init__.py). Ported so far:
graph-sc, scTAG, scDSC, scDeepCluster and scDCC."""

from dance_tpu_torch.modules.single_modality.clustering.graphsc import (
    GCNAE, GraphSC, InnerProductDecoder, graphsc_preprocess, run_leiden)
from dance_tpu_torch.modules.single_modality.clustering.scdcc import ScDCC, scdcc_preprocess
from dance_tpu_torch.modules.single_modality.clustering.scdeepcluster import (
    ClusteringInputs, ScDeepCluster, scdeepcluster_preprocess)
from dance_tpu_torch.modules.single_modality.clustering.scdsc import (ScDSC, ScDSCModel,
                                                                      scdsc_preprocess)
from dance_tpu_torch.modules.single_modality.clustering.sctag import ScTAG, sctag_preprocess

__all__ = ["ClusteringInputs", "GCNAE", "GraphSC", "InnerProductDecoder", "ScDCC", "ScDSC",
           "ScDSCModel", "ScDeepCluster", "ScTAG", "graphsc_preprocess", "scdcc_preprocess",
           "run_leiden", "scdeepcluster_preprocess", "scdsc_preprocess", "sctag_preprocess"]
