"""Pairwise distances (counterpart: ``pairwise_distance`` and
``_euclidean_pdist``, dance_tpu/utils/matrix.py:64-118).

Euclidean only: the Pearson and Spearman metrics (:75-101) are not ported
yet and raise. Host numpy in, host numpy out, as in the JAX package, and
computed on the CPU in float32 (the JAX package pins ``Precision.HIGHEST``
for the same full-precision product).
"""

import numpy as np
import torch


def pairwise_distance(x, y=None, dist_func="euclidean") -> np.ndarray:
    """(n, m) distances between the rows of ``x`` and of ``y`` (default ``x``),
    as ``sqrt(max(|a|² + |b|² - 2 a·b, 0))``."""
    if dist_func not in ("euclidean", 0):
        raise NotImplementedError(f"dist_func {dist_func!r} is not ported yet; "
                                  f"only 'euclidean' (ROADMAP Queue 1)")
    x = torch.as_tensor(np.asarray(x, np.float32))
    y = x if y is None else torch.as_tensor(np.asarray(y, np.float32))
    d2 = (x ** 2).sum(1)[:, None] + (y ** 2).sum(1)[None, :] - 2 * (x @ y.T)
    return torch.sqrt(d2.clamp(min=0.0)).numpy()


__all__ = ["pairwise_distance"]
