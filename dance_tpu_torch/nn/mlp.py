"""The shared MLP, the network builder, the ReLU + dropout stack and the
full-batch norm (counterparts: dance_tpu/nn/mlp.py:13-44; the ``_MLP`` of
dance_tpu/modules/multi_modality/joint_embedding/dcca.py:31 and scmvae.py:85;
the norm blocks of
dance_tpu/modules/single_modality/cell_type_annotation/scheteronet.py:89,
imputation/graphsci.py:29, cell_type_deconvo/stdgcn.py:216 and
multi_modality/joint_embedding/jae.py:30).

:class:`VanillaMLP` is Linear + ReLU layers with flax's Xavier-uniform
kernels and zero biases, then a last Linear. :func:`buildNetwork` stacks
Linear layers with an activation between them and flax ``Dense``'s default
init. :class:`DropoutMLP` is flax ``Dense`` + ReLU + dropout layers, the
dropout JAX's inverted one (:func:`inverted_dropout`) on masks the caller
draws. :class:`FullBatchNorm` normalises with the statistics of the whole
batch at every call and keeps no running statistics, as the JAX blocks do
(full-graph training makes the batch statistics exact).
"""

from typing import Optional, Sequence

import torch
from torch import nn

from dance_tpu_torch.nn.gnn import flax_dense_init_

_ACTIVATIONS = {"relu": nn.ReLU, "sigmoid": nn.Sigmoid, "tanh": nn.Tanh, "elu": nn.ELU,
                # flax's gelu is the tanh approximation
                "gelu": lambda: nn.GELU(approximate="tanh")}


class VanillaMLP(nn.Module):
    """Linear(in, h0) ReLU ... Linear(h_last, out) (counterpart: mlp.py:13).
    flax infers the input width; torch takes it as ``input_dim``. ``layers``
    holds every Linear, flax's ``Dense_{i}`` in order."""

    def __init__(self, input_dim: int, output_dim: int,
                 hidden_dims: Sequence[int] = (100, 50, 25)):
        super().__init__()
        widths = [input_dim, *hidden_dims, output_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's ``xavier_uniform`` kernels and zero biases."""
        for layer in self.layers:
            nn.init.xavier_uniform_(layer.weight, generator=generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)


def buildNetwork(layers: Sequence[int], activation: str = "relu",
                 generator: Optional[torch.Generator] = None) -> nn.Sequential:
    """Linear layers of the widths ``layers`` with ``activation`` between
    them and none after the last (counterpart: mlp.py:31), each with flax
    ``Dense``'s default init drawn from ``generator``."""
    act = _ACTIVATIONS[activation]
    mods = []
    for i in range(1, len(layers)):
        linear = nn.Linear(layers[i - 1], layers[i])
        flax_dense_init_(linear, generator)
        mods.append(linear)
        if i < len(layers) - 1:
            mods.append(act())
    return nn.Sequential(*mods)


def inverted_dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """JAX's (and flax ``Dropout``'s) inverted dropout: the entries where
    ``keep`` is true over ``1 - rate``, the others 0."""
    return torch.where(keep, x / (1 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class DropoutMLP(nn.Module):
    """flax ``Dense`` + ReLU + ``Dropout`` layers of the widths ``dims``, the
    ``_MLP`` of DCCA and scMVAE (counterparts: dcca.py:31, scmvae.py:85).
    ``layers`` holds flax's ``Dense_{i}`` in order. ``drop``, a callable
    that applies dropout to a tensor, runs after each ReLU in training; None
    (evaluation, or a rate of 0) leaves the activations as they are."""

    def __init__(self, in_dim: int, dims: Sequence[int]):
        super().__init__()
        widths = [in_dim, *dims]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, x: torch.Tensor, drop=None) -> torch.Tensor:
        for layer in self.layers:
            x = torch.relu(layer(x))
            if drop is not None:
                x = drop(x)
        return x


class FullBatchNorm(nn.Module):
    """Batch norm on the statistics of the whole batch, every call, with no
    running statistics: biased variance, eps 1e-5. ``scale`` and ``bias``
    are flax's names."""

    def __init__(self, width: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = x.mean(0), x.var(0, unbiased=False)
        return (x - mean) / torch.sqrt(var + 1e-5) * self.scale + self.bias


__all__ = ["DropoutMLP", "FullBatchNorm", "VanillaMLP", "buildNetwork", "inverted_dropout"]
