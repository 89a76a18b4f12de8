"""Cell-type annotation methods (counterpart:
dance_tpu/modules/single_modality/cell_type_annotation/__init__.py). Only scDeepSort
is ported so far."""

from dance_tpu_torch.modules.single_modality.cell_type_annotation.scdeepsort import (
    GNN, ScDeepSort)

__all__ = ["GNN", "ScDeepSort"]
