"""Datasets (counterpart: dance_tpu/datasets/): the synthetic generators,
``cell_label_to_df``, ``BaseDataset`` with its processed-data cache, and
the local-file loaders of the single-modality benchmarks. The downloads,
the multimodal and spatial loaders (h5ad) and ``ClusteringDataset`` (h5)
are not ported (ROADMAP Queue 1 item 11 h)."""

from dance_tpu_torch.datasets.base import BaseDataset
from dance_tpu_torch.datasets.singlemodality import (CellTypeAnnotationDataset, ClusteringDataset,
                                                     ImputationDataset, cell_label_to_df)
from dance_tpu_torch.datasets.synthetic import (annotation_data, clustering_data, deconvo_data,
                                                imputation_data, multimodal_data, spatial_data,
                                                synthetic_expression)

__all__ = ["BaseDataset", "CellTypeAnnotationDataset", "ClusteringDataset", "ImputationDataset",
           "annotation_data", "cell_label_to_df", "clustering_data", "deconvo_data",
           "imputation_data", "multimodal_data", "spatial_data", "synthetic_expression"]
