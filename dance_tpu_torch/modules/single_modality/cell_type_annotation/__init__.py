"""Cell-type annotation methods (counterpart:
dance_tpu/modules/single_modality/cell_type_annotation/__init__.py): ACTINN,
CellTypist, scDeepSort, scHeteroNet, SingleCellNet and SVM, every method of
the JAX package."""

from dance_tpu_torch.modules.single_modality.cell_type_annotation.actinn import (
    ACTINN, actinn_preprocess)
from dance_tpu_torch.modules.single_modality.cell_type_annotation.celltypist import Celltypist
from dance_tpu_torch.modules.single_modality.cell_type_annotation.scdeepsort import (
    GNN, ScDeepSort)
from dance_tpu_torch.modules.single_modality.cell_type_annotation.scheteronet import (
    HeteroNetInputs, scHeteroNet, scheteronet_preprocess, set_split)
from dance_tpu_torch.modules.single_modality.cell_type_annotation.singlecellnet import (
    SingleCellNet, singlecellnet_preprocess)
from dance_tpu_torch.modules.single_modality.cell_type_annotation.svm import SVM, svm_preprocess

__all__ = ["ACTINN", "Celltypist", "GNN", "HeteroNetInputs", "SVM", "ScDeepSort",
           "SingleCellNet", "actinn_preprocess", "scHeteroNet", "scheteronet_preprocess",
           "set_split", "singlecellnet_preprocess", "svm_preprocess"]
