"""Modality prediction (counterpart:
dance_tpu/modules/multi_modality/predict_modality/__init__.py). Ported so
far: BABEL, CMAE, scMM and scMoGNN, every method of the family."""

from dance_tpu_torch.modules.multi_modality.predict_modality.babel import BabelWrapper
from dance_tpu_torch.modules.multi_modality.predict_modality.cmae import CMAE
from dance_tpu_torch.modules.multi_modality.predict_modality.scmm import MMVAE
from dance_tpu_torch.modules.multi_modality.predict_modality.scmogcn import ScMoGCNWrapper

__all__ = ["BabelWrapper", "CMAE", "MMVAE", "ScMoGCNWrapper"]
