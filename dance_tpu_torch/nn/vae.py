"""The variational blocks of the multimodal autoencoders (counterpart:
dance_tpu/nn/vae.py:12-58): a Gaussian encoder, a Gaussian decoder, a
negative-binomial decoder, the reparameterisation and the Gaussian KL.

The hidden layers are :class:`~dance_tpu_torch.nn.zinb_ae.MLPStack`
(``TorchDense`` + ReLU, torch-Linear init); the heads are flax ``Dense``
layers, lecun-normal kernels and zero biases
(:func:`~dance_tpu_torch.nn.gnn.flax_dense_init_`). flax infers the input
width; torch takes it as ``in_dim``. ``reset_parameters(generator)`` draws
every layer from one generator, in module order. The reparameterisation's
normals are handed in as ``noise`` (tests hand in JAX's) or drawn from a
generator on the means' device.
"""

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from dance_tpu_torch.nn.gnn import flax_dense_init_
from dance_tpu_torch.nn.zinb_ae import MLPStack, TorchDense, disp_act, mean_act


def reset_linears(module: nn.Module, generator: Optional[torch.Generator] = None):
    """``TorchDense`` layers with torch's default init, the other Linears with
    flax ``Dense``'s, in module order."""
    for m in module.modules():
        if isinstance(m, TorchDense):
            m.reset_parameters(generator)
        elif isinstance(m, nn.Linear):
            flax_dense_init_(m, generator)


def _width(in_dim: int, hidden: Sequence[int]) -> int:
    return hidden[-1] if len(hidden) else in_dim


class GaussianEncoder(nn.Module):
    """``MLPStack(hidden)`` -> ``(mu, logvar)`` heads (counterpart: vae.py:12;
    flax's ``Dense_0`` is ``mu``, ``Dense_1`` ``logvar``)."""

    def __init__(self, in_dim: int, hidden: Sequence[int], z_dim: int):
        super().__init__()
        self.stack = MLPStack(in_dim, hidden)
        self.mu = nn.Linear(_width(in_dim, hidden), z_dim)
        self.logvar = nn.Linear(_width(in_dim, hidden), z_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_linears(self, generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.stack(x)
        return self.mu(h), self.logvar(h)


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor, noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``mu + exp(logvar / 2) * noise`` (counterpart: vae.py:24), the standard
    normals ``noise`` drawn from ``generator`` on ``mu``'s device when not
    given."""
    if noise is None:
        noise = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
    return mu + torch.exp(0.5 * logvar) * noise


class GaussianDecoder(nn.Module):
    """``MLPStack(hidden)`` -> one ``Dense(out_dim)`` (counterpart: vae.py:28)."""

    def __init__(self, in_dim: int, hidden: Sequence[int], out_dim: int):
        super().__init__()
        self.stack = MLPStack(in_dim, hidden)
        self.out = nn.Linear(_width(in_dim, hidden), out_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_linears(self, generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.out(self.stack(z))


class NBDecoder(nn.Module):
    """Negative-binomial head (counterpart: vae.py:38): the mean is
    ``softmax(Dense_0(h)) * library`` with a library, ``mean_act(Dense_0(h))``
    without one; the dispersion ``disp_act(Dense_1(h))``."""

    def __init__(self, in_dim: int, hidden: Sequence[int], out_dim: int):
        super().__init__()
        self.stack = MLPStack(in_dim, hidden)
        self.mean = nn.Linear(_width(in_dim, hidden), out_dim)
        self.disp = nn.Linear(_width(in_dim, hidden), out_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_linears(self, generator)

    def forward(self, z: torch.Tensor, library: Optional[torch.Tensor] = None):
        h = self.stack(z)
        if library is not None:
            mean = torch.softmax(self.mean(h), dim=-1) * library
        else:
            mean = mean_act(self.mean(h))
        return mean, disp_act(self.disp(h))


def gaussian_kl(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, exp(logvar)) || N(0, 1)) summed over the latent, averaged over
    the rows (counterpart: vae.py:54)."""
    return (-0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar), dim=-1)).mean()


__all__ = ["GaussianDecoder", "GaussianEncoder", "NBDecoder", "gaussian_kl", "reparameterize",
           "reset_linears"]
