"""Shared scoring of the modality-matching methods (counterpart:
dance_tpu/modules/multi_modality/match_modality/base.py): a 0/1 matching
matrix held against the known cell pairing, and nearest-neighbour matching
of two embeddings."""

import numpy as np
import torch

from dance_tpu_torch.utils import resolve_device


def nearest_neighbor_matching(emb1, emb2, metric: str = "l1", chunk: int = 512,
                              device="auto") -> np.ndarray:
    """0/1 matching matrix (n2, n1), float32: each cell of ``emb2`` pairs
    with its nearest cell of ``emb1`` by L1 (``"l1"``, the reference CMAE's)
    or L2 distance (anything else, scMM's minkowski p = 2) (counterpart:
    base.py:8-36). The distances run on ``device`` (the card unless the CPU
    is named) in chunks of ``chunk`` rows of ``emb2``, so no (n2, n1, d)
    block is made at once; L2 takes the argmin of the expanded square, with
    no root."""
    device = resolve_device(device)
    e1 = torch.as_tensor(np.asarray(emb1, np.float32)).to(device)
    e2 = torch.as_tensor(np.asarray(emb2, np.float32)).to(device)
    n1, n2 = e1.shape[0], e2.shape[0]
    nn_idx = []
    for lo in range(0, n2, chunk):
        block = e2[lo:lo + chunk]
        if metric == "l1":
            d = (block[:, None, :] - e1[None, :, :]).abs().sum(-1)
        else:
            d = ((block ** 2).sum(1)[:, None] - 2.0 * block @ e1.T + (e1 ** 2).sum(1)[None, :])
        nn_idx.append(d.argmin(1))
    nn_idx = torch.cat(nn_idx).cpu().numpy() if nn_idx else np.empty(0, np.int64)
    matching = np.zeros((n2, n1), np.float32)
    matching[np.arange(n2), nn_idx] = 1.0
    return matching


class MatchingScoreMixin:
    """``score_matching`` for the matching wrappers (counterpart: base.py:39)."""

    def score_matching(self, matching: np.ndarray, true_perm=None) -> float:
        """The share of cells matched to their true partner (the identity
        pairing by default)."""
        n = matching.shape[0]
        if true_perm is None:
            true_perm = np.arange(n)
        return float(matching[np.arange(n), true_perm].mean())


__all__ = ["MatchingScoreMixin", "nearest_neighbor_matching"]
