"""Modality matching (counterpart:
dance_tpu/modules/multi_modality/match_modality/__init__.py). Ported so far:
CMAE, scMM, scMoGNN and the shared matching scores."""

from dance_tpu_torch.modules.multi_modality.match_modality.base import (
    MatchingScoreMixin, nearest_neighbor_matching)
from dance_tpu_torch.modules.multi_modality.match_modality.cmae import CMAE
from dance_tpu_torch.modules.multi_modality.match_modality.scmm import MMVAE
from dance_tpu_torch.modules.multi_modality.match_modality.scmogcn import ScMoGCNWrapper

__all__ = ["CMAE", "MMVAE", "MatchingScoreMixin", "ScMoGCNWrapper", "nearest_neighbor_matching"]
