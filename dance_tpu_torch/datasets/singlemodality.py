"""Single-modality dataset helpers (counterpart:
dance_tpu/datasets/singlemodality.py). Only :func:`cell_label_to_df` is
ported: the dataset classes read downloaded benchmark files with pandas and
h5py, which the card's machine lacks (ROADMAP Queue 1)."""

from typing import List

import numpy as np

from dance_tpu_torch.data.container import Frame


def cell_label_to_df(cell_labels, idx_to_label: List[str], index=None) -> Frame:
    """Multi-hot label frame, one float32 column a type: a cell may map to a
    set of admissible types (counterpart: singlemodality.py:29)."""
    mat = np.zeros((len(cell_labels), len(idx_to_label)), dtype=np.float32)
    pos = {label: i for i, label in enumerate(idx_to_label)}
    for i, label in enumerate(cell_labels):
        labels = label if isinstance(label, (set, list, tuple)) else [label]
        for sub in labels or []:
            if sub in pos:
                mat[i, pos[sub]] = 1
    return Frame(mat, index=index, columns=idx_to_label)


__all__ = ["cell_label_to_df"]
