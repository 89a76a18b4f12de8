"""Datasets (counterpart: dance_tpu/datasets/): the synthetic generators and
``cell_label_to_df``. The downloaded benchmark datasets, their catalogs and
``datasets/base.py``'s cache are not ported yet (ROADMAP Queue 1)."""

from dance_tpu_torch.datasets.singlemodality import cell_label_to_df
from dance_tpu_torch.datasets.synthetic import (annotation_data, clustering_data, deconvo_data,
                                                imputation_data, multimodal_data, spatial_data,
                                                synthetic_expression)

__all__ = ["annotation_data", "cell_label_to_df", "clustering_data", "deconvo_data",
           "imputation_data", "multimodal_data", "spatial_data", "synthetic_expression"]
