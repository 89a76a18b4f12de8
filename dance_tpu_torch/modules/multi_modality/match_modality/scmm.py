"""scMM for modality matching (counterpart:
dance_tpu/modules/multi_modality/match_modality/scmm.py): the prediction
model's mean latents, each cell of the second modality matched to its L2
nearest neighbour among the first's."""

import numpy as np

from dance_tpu_torch.modules.multi_modality.match_modality.base import (
    MatchingScoreMixin, nearest_neighbor_matching)
from dance_tpu_torch.modules.multi_modality.predict_modality.scmm import MMVAE as _PredMMVAE


class MMVAE(MatchingScoreMixin, _PredMMVAE):

    _DEFAULT_METRIC = "acc"

    def predict_matching(self, x1, x2, metric: str = "l2") -> np.ndarray:
        """0/1 matching matrix (n2, n1): the nearest neighbour of the mean
        latents, by L2 (counterpart: :13), on the model's device."""
        return nearest_neighbor_matching(self.encode(x1, 1), self.encode(x2, 2), metric=metric,
                                         device=self.device)


__all__ = ["MMVAE"]
