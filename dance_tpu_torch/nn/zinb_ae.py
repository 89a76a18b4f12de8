"""The ZINB autoencoder of scDeepCluster and scDCC and the ZINB heads'
activations shared by the clustering family (counterpart:
dance_tpu/nn/zinb_ae.py:15-123, the reference's buildNetwork, MeanAct and
DispAct).

:class:`ZINBAutoencoder` is an encoder stack, a latent layer ``enc_mu``, a
decoder stack and three heads (mean, dispersion, dropout probability). Its
forward adds ``sigma`` times Gaussian noise to the input of the ZINB path
and returns the embedding of the clean input beside the heads; both passes
carry gradients. The noise is drawn from ``generator`` on the input's
device, or handed in as ``noise`` (tests hand in JAX's normals). Every
layer is a :class:`TorchDense`: ``torch.nn.Linear`` with its default init,
drawn from an explicit generator.
"""

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn


def mean_act(x: torch.Tensor) -> torch.Tensor:
    """``exp`` clamped to [1e-5, 1e6] (counterpart: zinb_ae.py:15)."""
    return torch.clamp(torch.exp(x), 1e-5, 1e6)


def disp_act(x: torch.Tensor) -> torch.Tensor:
    """softplus clamped to [1e-4, 1e4] (counterpart: zinb_ae.py:20); softplus
    is ``logaddexp(x, 0)`` as ``jax.nn.softplus`` computes it."""
    sp = torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))
    return torch.clamp(sp, 1e-4, 1e4)


class TorchDense(nn.Linear):
    """``nn.Linear`` whose default init (kernel and bias U(±1/sqrt(fan_in)))
    is drawn from a generator (counterpart: zinb_ae.py:25, which writes that
    init out in flax)."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5), generator=generator)
        if self.bias is not None:
            bound = 1.0 / math.sqrt(self.in_features)
            nn.init.uniform_(self.bias, -bound, bound, generator=generator)


class MLPStack(nn.Module):
    """:class:`TorchDense` + ReLU layers of the widths ``dims`` (counterpart:
    zinb_ae.py:49; flax infers the input width, torch takes it as ``in_dim``)."""

    def __init__(self, in_dim: int, dims: Sequence[int]):
        super().__init__()
        widths = [in_dim, *dims]
        self.layers = nn.ModuleList(TorchDense(a, b) for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = torch.relu(layer(x))
        return x


class ZINBAutoencoder(nn.Module):
    """Encoder -> z -> decoder with ZINB (mean, disp, pi) heads (counterpart:
    zinb_ae.py:61). ReLU between layers, as in JAX, whose ``activation``
    field every model leaves at relu."""

    def __init__(self, input_dim: int, z_dim: int, encode_layers: Sequence[int] = (256, 64),
                 decode_layers: Sequence[int] = (64, 256), sigma: float = 1.0):
        super().__init__()
        self.sigma = sigma
        self.encoder = MLPStack(input_dim, encode_layers)
        self.enc_mu = TorchDense(encode_layers[-1] if encode_layers else input_dim, z_dim)
        self.decoder = MLPStack(z_dim, decode_layers)
        width = decode_layers[-1] if decode_layers else z_dim
        self.dec_mean = TorchDense(width, input_dim)
        self.dec_disp = TorchDense(width, input_dim)
        self.dec_pi = TorchDense(width, input_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Every layer's ``nn.Linear`` default init, drawn in module order."""
        for m in self.modules():
            if isinstance(m, TorchDense):
                m.reset_parameters(generator)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.enc_mu(self.encoder(x))

    def decode_heads(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        h = self.decoder(z)
        return (mean_act(self.dec_mean(h)), disp_act(self.dec_disp(h)),
                torch.sigmoid(self.dec_pi(h)))

    def noisy_heads(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
        """The ZINB heads of ``x + sigma · noise``; ``noise`` is drawn from
        ``generator`` when not given, and left out when neither is."""
        if self.sigma > 0 and (noise is not None or generator is not None):
            if noise is None:
                noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
            x = x + self.sigma * noise
        return self.decode_heads(self.encode(x))

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """Denoising forward: ``(z_clean, mean, disp, pi)``, the heads from the
        noisy input and ``z_clean`` from a second, noise-free encoder pass."""
        mean, disp, pi = self.noisy_heads(x, noise, generator)
        return self.encode(x), mean, disp, pi


class MeanAct(nn.Module):
    """Module form of :func:`mean_act` (the reference's MeanAct)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mean_act(x)


class DispAct(nn.Module):
    """Module form of :func:`disp_act` (the reference's DispAct)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return disp_act(x)


__all__ = ["DispAct", "MLPStack", "MeanAct", "TorchDense", "ZINBAutoencoder", "disp_act",
           "mean_act"]
