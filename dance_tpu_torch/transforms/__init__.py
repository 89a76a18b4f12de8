"""Preprocessing on arrays (counterpart: dance_tpu/transforms/__init__.py)."""

from dance_tpu_torch.transforms.cell_feature import weighted_feature_pca

__all__ = ["weighted_feature_pca"]
