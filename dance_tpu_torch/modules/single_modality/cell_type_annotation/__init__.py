"""Cell-type annotation methods (counterpart:
dance_tpu/modules/single_modality/cell_type_annotation/__init__.py). Ported so
far: ACTINN, scDeepSort and scHeteroNet."""

from dance_tpu_torch.modules.single_modality.cell_type_annotation.actinn import (
    ACTINN, actinn_preprocess)
from dance_tpu_torch.modules.single_modality.cell_type_annotation.scdeepsort import (
    GNN, ScDeepSort)
from dance_tpu_torch.modules.single_modality.cell_type_annotation.scheteronet import (
    HeteroNetInputs, scHeteroNet, scheteronet_preprocess, set_split)

__all__ = ["ACTINN", "GNN", "HeteroNetInputs", "ScDeepSort", "actinn_preprocess", "scHeteroNet",
           "scheteronet_preprocess", "set_split"]
