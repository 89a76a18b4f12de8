"""Imputation methods (counterpart:
dance_tpu/modules/single_modality/imputation/__init__.py). Ported so far:
DeepImpute and GraphSCI."""

from dance_tpu_torch.modules.single_modality.imputation.deepimpute import (
    DeepImpute, DeepImputeInputs, NeuralNetworkModel, deepimpute_preprocess)
from dance_tpu_torch.modules.single_modality.imputation.graphsci import (GraphSCI,
                                                                         GraphSCIInputs,
                                                                         graphsci_preprocess)

__all__ = ["DeepImpute", "DeepImputeInputs", "GraphSCI", "GraphSCIInputs", "NeuralNetworkModel",
           "deepimpute_preprocess", "graphsci_preprocess"]
