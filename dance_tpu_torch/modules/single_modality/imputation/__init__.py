"""Imputation methods (counterpart:
dance_tpu/modules/single_modality/imputation/__init__.py): DeepImpute,
GraphSCI, MAGIC and scGNN2, every method of the JAX package."""

from dance_tpu_torch.modules.single_modality.imputation.deepimpute import (
    DeepImpute, DeepImputeInputs, NeuralNetworkModel, deepimpute_preprocess)
from dance_tpu_torch.modules.single_modality.imputation.graphsci import (GraphSCI,
                                                                         GraphSCIInputs,
                                                                         graphsci_preprocess)
from dance_tpu_torch.modules.single_modality.imputation.magic import (MAGIC, MagicInputs,
                                                                      magic_preprocess)
from dance_tpu_torch.modules.single_modality.imputation.scgnn2 import (ScGNN2, ScGNN2Inputs,
                                                                       scgnn2_preprocess)

__all__ = ["DeepImpute", "DeepImputeInputs", "GraphSCI", "GraphSCIInputs", "MAGIC",
           "MagicInputs", "NeuralNetworkModel", "ScGNN2", "ScGNN2Inputs",
           "deepimpute_preprocess", "graphsci_preprocess", "magic_preprocess",
           "scgnn2_preprocess"]
