"""Imputation methods (counterpart:
dance_tpu/modules/single_modality/imputation/__init__.py). Ported so far:
GraphSCI."""

from dance_tpu_torch.modules.single_modality.imputation.graphsci import (GraphSCI,
                                                                         GraphSCIInputs,
                                                                         graphsci_preprocess)

__all__ = ["GraphSCI", "GraphSCIInputs", "graphsci_preprocess"]
