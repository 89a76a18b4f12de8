"""Modality prediction (counterpart:
dance_tpu/modules/multi_modality/predict_modality/__init__.py). Ported so
far: scMoGNN."""

from dance_tpu_torch.modules.multi_modality.predict_modality.scmogcn import ScMoGCNWrapper

__all__ = ["ScMoGCNWrapper"]
