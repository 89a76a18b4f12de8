"""The ZINB heads' activations shared by the clustering family (counterpart:
dance_tpu/nn/zinb_ae.py:15-22, the reference's MeanAct and DispAct).

The rest of the JAX file (``TorchDense``, the ZINB autoencoder of
scDeepCluster and scDCC) waits for those models (ROADMAP Queue 1, slice 4).
"""

import torch


def mean_act(x: torch.Tensor) -> torch.Tensor:
    """``exp`` clamped to [1e-5, 1e6] (counterpart: zinb_ae.py:15)."""
    return torch.clamp(torch.exp(x), 1e-5, 1e6)


def disp_act(x: torch.Tensor) -> torch.Tensor:
    """softplus clamped to [1e-4, 1e4] (counterpart: zinb_ae.py:20); softplus
    is ``logaddexp(x, 0)`` as ``jax.nn.softplus`` computes it."""
    sp = torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))
    return torch.clamp(sp, 1e-4, 1e4)


__all__ = ["disp_act", "mean_act"]
