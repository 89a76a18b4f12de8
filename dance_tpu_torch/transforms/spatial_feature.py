"""Morphology and SME features of spots on arrays (counterparts: the array
cores of ``MorphologyFeatureCNN`` and ``SMEFeature``,
dance_tpu/transforms/spatial_feature.py:14-180).

The morphology features come from a small strided convolutional encoder
trained on the H&E tiles themselves (the JAX package's stand-in for a
pretrained CNN): three 3 x 3 stride-2 convolutions with ReLU, 3 -> 32 -> 64
-> 128 channels, trained by Adam to reconstruct the 8 x 8 mean-pooled tile
from the bottleneck through a linear per-cell decoder; every tile's
bottleneck, mean-pooled, then goes through a PCA. The convolutions are
``torch.nn.functional.conv2d`` (cuDNN on the card; JAX runs
``lax.conv_general_dilated`` outside any Pallas kernel).

Where this differs from the JAX package:

- JAX's ``"SAME"`` padding is written out: at stride 2 it pads
  ``((out - 1) * 2 + 3 - in)`` pixels, the smaller half before, so a 64-wide
  tile is padded (0, 1), not the (1, 1) of ``conv2d(padding=1)``.
- Tiles are NCHW and kernels OIHW here, NHWC and HWIO in JAX.
- The kernels and the decoder are drawn from a CPU ``torch.Generator``
  seeded with ``random_state`` (:func:`morphology_init`), not from
  ``jax.random``; parity tests copy JAX's in
  (:func:`dance_tpu_torch.utils.params.morphology_flax_to_torch`).
- ``morphology_feature_cnn`` returns the features; ``sme_feature`` takes the
  SME graph as an array and returns the features. The transforms
  :class:`MorphologyFeatureCNN` and :class:`SMEFeature` run them on a port
  ``Data`` as JAX's do: the pixels from ``obsm["spatial_pixel"]`` and the
  image from ``uns["image"]``, the expression from ``X`` and the graph from
  ``obsp["SMEGraph"]``, the features into ``obsm[out]``. They are
  registered under JAX's keys in the port's own registry; the channels are
  class constants (no pipeline sets another).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dance_tpu_torch.ops.linalg import pca
from dance_tpu_torch.registry import register_preprocessor
from dance_tpu_torch.settings import logger
from dance_tpu_torch.transforms.base import BaseTransform
from dance_tpu_torch.utils import resolve_device
from dance_tpu_torch.utils.matrix import normalize

MORPHOLOGY_MODELS = ("resnet50", "inception_v3", "xception", "vgg16")
CHANNELS = (3, 32, 64, 128)
_MEAN = np.array([0.406, 0.485, 0.456])
_STD = np.array([0.225, 0.229, 0.224])


def same_pad(x: torch.Tensor, kernel: int = 3, stride: int = 2) -> torch.Tensor:
    """Pad an NCHW tensor as JAX's ``"SAME"`` pads it for a convolution of
    ``kernel`` and ``stride``: the smaller half of the padding before."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class MorphologyEncoder(nn.Module):
    """The tile encoder and its linear decoder (counterpart: ``encode`` and
    ``_train_encoder``'s ``dec``, spatial_feature.py:56-133). ``forward``
    maps NCHW tiles to the (n, 128, h/8, w/8) bottleneck."""

    def __init__(self):
        super().__init__()
        self.kernels = nn.ParameterList(nn.Parameter(torch.empty(o, i, 3, 3))
                                        for i, o in zip(CHANNELS[:-1], CHANNELS[1:]))
        self.dec = nn.Parameter(torch.empty(CHANNELS[-1], 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for w in self.kernels:
            x = torch.relu(F.conv2d(same_pad(x), w, stride=2))
        return x

    def reconstruct(self, x: torch.Tensor) -> torch.Tensor:
        """The decoder's (n, h/8, w/8, 3) image of the tiles."""
        return self(x).permute(0, 2, 3, 1) @ self.dec


def morphology_init(random_state: int) -> MorphologyEncoder:
    """An encoder with He-normal kernels (std ``sqrt(2 / (9 c_in))``) and a
    decoder of normals times 0.05, drawn from a CPU generator."""
    gen = torch.Generator().manual_seed(random_state)
    enc = MorphologyEncoder()
    with torch.no_grad():
        for w in enc.kernels:
            w.copy_(torch.randn(w.shape, generator=gen) * math.sqrt(2.0 / (9 * w.shape[1])))
        enc.dec.copy_(torch.randn(enc.dec.shape, generator=gen) * 0.05)
    return enc


def crop_tile(image: np.ndarray, x, y, crop_size: int, target_size: int) -> np.ndarray:
    """The ``2 crop_size`` square round pixel (x, y), resized to ``target_size``
    by nearest neighbour and normalised by the ImageNet channel statistics,
    float64 HWC (counterpart: ``_crop``, spatial_feature.py:84)."""
    cs = crop_size
    img = image[max(0, int(x - cs)):int(x + cs), max(0, int(y - cs)):int(y + cs), :]
    ts = target_size
    xi = np.clip((np.arange(ts) * img.shape[0] / ts).astype(int), 0, img.shape[0] - 1)
    yi = np.clip((np.arange(ts) * img.shape[1] / ts).astype(int), 0, img.shape[1] - 1)
    return (img[np.ix_(xi, yi)] - _MEAN) / _STD


def train_encoder(enc: MorphologyEncoder, tiles: torch.Tensor, epochs: int, lr: float) -> float:
    """Adam on the reconstruction MSE of the first 1,024 tiles, full batch,
    ``epochs`` steps (counterpart: ``_train_encoder``, spatial_feature.py:
    50-82). Returns the last step's loss."""
    x = tiles[:1024]
    n, _, h, w = x.shape
    target = x.permute(0, 2, 3, 1).reshape(n, h // 8, 8, w // 8, 8, 3).mean((2, 4))
    opt = torch.optim.Adam(enc.parameters(), lr=lr)
    loss = torch.zeros(())
    for _ in range(epochs):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((enc.reconstruct(x) - target) ** 2)
        loss.backward()
        opt.step()
    return float(loss.detach())


def morphology_feature_cnn(xy_pixel, image, *, model_name: str = "resnet50",
                           n_components: int = 50, random_state: int = 0, crop_size: int = 20,
                           target_size: int = 64, train_epochs: int = 30, lr: float = 1e-3,
                           device="auto") -> np.ndarray:
    """The (n, k) float32 morphology features of the spots at ``xy_pixel``
    (row, column) of the HWC ``image`` (counterpart: ``MorphologyFeatureCNN.
    __call__``, spatial_feature.py:93): tiles, ``train_epochs`` Adam steps
    of the encoder (none at 0: the random features), the mean-pooled
    bottleneck of every tile in batches of 256, and its PCA to
    ``min(n_components, min(n, 128) - 1)`` components (none at 0).
    ``model_name`` is checked and otherwise unused, as in JAX."""
    if model_name not in MORPHOLOGY_MODELS:
        raise ValueError(f"Unsupported model {model_name!r}, options: {MORPHOLOGY_MODELS}")
    device = resolve_device(device)
    image = np.asarray(image)
    tiles = np.stack([crop_tile(image, x, y, crop_size, target_size)
                      for x, y in np.asarray(xy_pixel)]).astype(np.float32)
    tiles = torch.from_numpy(tiles).permute(0, 3, 1, 2).contiguous().to(device)
    enc = morphology_init(random_state).to(device)
    if train_epochs > 0:
        loss = train_encoder(enc, tiles, train_epochs, lr)
        logger.info("Morphology encoder trained: recon MSE %.5f", loss)
    with torch.no_grad():
        feat = torch.cat([enc(tiles[s:s + 256]).mean((2, 3)) for s in range(0, len(tiles), 256)])
    if n_components > 0:
        feat = pca(feat, min(n_components, min(feat.shape) - 1)).embedding
    return feat.cpu().numpy()


@register_preprocessor("feature", "spatial")
class MorphologyFeatureCNN(BaseTransform):
    """:func:`morphology_feature_cnn` of the tiles at ``obsm["spatial_pixel"]``
    of ``uns["image"]`` into ``obsm[out]`` (counterpart:
    spatial_feature.py:14). The options no pipeline sets are the function's
    defaults, kept as class constants (those JAX prints, in the digest)."""

    _DISPLAY_ATTRS = ("model_name", "n_components", "crop_size", "target_size")
    model_name, crop_size, target_size = "resnet50", 20, 64

    def __init__(self, *, n_components: int = 50, device="auto", **kwargs):
        super().__init__(**kwargs)
        self.n_components = n_components
        self.device = device

    def __call__(self, data):
        xy_pixel = data.get_feature(return_type="numpy", channel="spatial_pixel",
                                    channel_type="obsm")
        image = data.get_feature(return_type="default", channel="image", channel_type="uns")
        data.data.obsm[self.out] = morphology_feature_cnn(
            xy_pixel, image, n_components=self.n_components, device=self.device)
        return data


def sme_feature(x, adj, *, n_neighbors: int = 3, n_components: int = 50,
                device="auto") -> np.ndarray:
    """stLearn's SME-normalised expression (counterpart: ``SMEFeature.
    __call__``, spatial_feature.py:162): each spot's expression averaged
    with the weighted mean of its ``n_neighbors`` heaviest ``adj``
    neighbours (itself when their weights sum to 0), in float64; then
    standardised over the spots and its PCA to ``min(n_components,
    min(shape) - 1)`` components (none at 0, when the float64 average is
    returned).

    The neighbours are ``torch.topk``'s, where JAX takes the last ``k`` of
    numpy's ``argsort``: the two pick differently only among equal weights,
    and there only a neighbour of weight 0, which adds nothing, or one of a
    positive weight tied with another at the k-th place."""
    device = resolve_device(device)
    x = torch.as_tensor(np.asarray(x, np.float64), device=device)
    adj = torch.as_tensor(np.asarray(adj), device=device)
    nbr_w, nbr_idx = torch.topk(adj, n_neighbors, dim=1)
    nbr_w = nbr_w.to(torch.float64)
    wsum = nbr_w.sum(1, keepdim=True)
    agg = torch.einsum("nk,nkg->ng", nbr_w / wsum.clamp(min=1e-12), x[nbr_idx])
    sme = (x + torch.where(wsum > 0, agg, x)) / 2
    if n_components <= 0:
        return sme.cpu().numpy()
    sme = normalize(sme.to(torch.float32), mode="standardize", axis=0)
    return pca(sme, min(n_components, min(sme.shape) - 1)).embedding.cpu().numpy()


@register_preprocessor("feature", "spatial")
class SMEFeature(BaseTransform):
    """:func:`sme_feature` of ``X`` over ``obsp["SMEGraph"]`` into
    ``obsm[out]`` (counterpart: spatial_feature.py:143), its 3 neighbours the
    function's default: no pipeline sets another."""

    def __init__(self, n_components: int = 50, *, device="auto", **kwargs):
        super().__init__(**kwargs)
        self.n_components = n_components
        self.device = device

    def __call__(self, data):
        x = data.get_feature(return_type="numpy", channel_type="X")
        adj = data.get_feature(return_type="numpy", channel="SMEGraph", channel_type="obsp")
        data.data.obsm[self.out] = sme_feature(x, adj, n_components=self.n_components,
                                               device=self.device)
        return data


__all__ = ["MORPHOLOGY_MODELS", "MorphologyEncoder", "MorphologyFeatureCNN", "SMEFeature",
           "crop_tile", "morphology_feature_cnn", "morphology_init", "same_pad", "sme_feature",
           "train_encoder"]
