"""Losses (counterpart: dance_tpu/utils/loss.py). Only graph-sc's
``binary_ce_logits`` (:113-126) is ported so far."""

from typing import Optional, Union

import torch


def binary_ce_logits(logits: torch.Tensor, target: torch.Tensor,
                     pos_weight: Optional[Union[float, torch.Tensor]] = None) -> torch.Tensor:
    """Mean sigmoid binary cross entropy from logits, with ``pos_weight``
    scaling the positive term: ``(1 + (w - 1) t) softplus(l) - w t l``
    (counterpart: loss.py:113). ``softplus`` is ``logaddexp(l, 0)``, the
    function ``jax.nn.softplus`` computes; ``F.softplus`` returns ``l`` itself
    above 20."""
    sp = torch.logaddexp(logits, torch.zeros((), dtype=logits.dtype, device=logits.device))
    if pos_weight is None:
        return torch.mean(sp - target * logits)
    return torch.mean((1.0 + (pos_weight - 1.0) * target) * sp - pos_weight * target * logits)


__all__ = ["binary_ce_logits"]
