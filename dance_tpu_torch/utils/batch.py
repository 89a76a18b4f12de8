"""Shuffled epoch batches (counterpart: dance_tpu/utils/batch.py:18-45).

The reference trains through torch DataLoaders with ``drop_last=False``:
every epoch visits every cell, a partial last batch included. The JAX
package pads the shuffled order up to ``ceil(n / batch_size) * batch_size``
so that a scan sees equal batches; the port keeps that layout, so that both
packages take the same number of steps on the same cells. CMAE and scMM
drop the partial batch instead (:func:`epoch_batches_dropped`, JAX's
``permutation(key, n)[:nb * batch_size]``). The permutation comes from a
``torch.Generator`` (it is not JAX's draw).
"""

from typing import Optional, Tuple

import torch


def epoch_batches(generator: Optional[torch.Generator], n: int, batch_size: int) -> torch.Tensor:
    """Shuffled indices of one epoch as a (ceil(n / bs), bs) int64 matrix,
    padded by wrapping round the permutation: every cell once, the first
    ``pad`` of the order twice (counterpart: batch.py:18)."""
    batch_size = min(batch_size, n)
    nb = -(-n // batch_size)
    perm = torch.randperm(n, generator=generator)
    pad = nb * batch_size - n
    if pad:
        perm = torch.cat([perm, perm[:pad]])
    return perm.reshape(nb, batch_size)


def epoch_batches_masked(generator: Optional[torch.Generator], n: int,
                         batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`epoch_batches` with index 0 in the padded slots and a float32
    mask that is 0 there, so that a masked loss normalises a partial last
    batch exactly (counterpart: batch.py:33). Returns ``(idx, mask)``."""
    batch_size = min(batch_size, n)
    nb = -(-n // batch_size)
    perm = torch.randperm(n, generator=generator)
    pad = nb * batch_size - n
    mask = torch.ones(nb * batch_size, dtype=torch.float32)
    if pad:
        perm = torch.cat([perm, torch.zeros(pad, dtype=perm.dtype)])
        mask[n:] = 0.0
    return perm.reshape(nb, batch_size), mask.reshape(nb, batch_size)


def epoch_batches_dropped(generator: Optional[torch.Generator], n: int,
                          batch_size: int) -> torch.Tensor:
    """Shuffled indices of one epoch as a (max(n // bs, 1), bs) int64
    matrix: the permutation cut to whole batches, the partial one dropped
    (counterpart: the epochs of predict_modality/cmae.py:139-145 and
    scmm.py:110-113)."""
    batch_size = min(batch_size, n)
    nb = max(n // batch_size, 1)
    return torch.randperm(n, generator=generator)[:nb * batch_size].reshape(nb, batch_size)


__all__ = ["epoch_batches", "epoch_batches_dropped", "epoch_batches_masked"]
