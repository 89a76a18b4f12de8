"""Spatial graphs on arrays (counterparts: the array cores of
``SpaGCNGraph``, ``SpaGCNGraph2D``, ``SMEGraph`` and ``StagateGraph``,
dance_tpu/transforms/graph/spatial_graph.py:13-148).

The JAX transforms read coordinates, images and features from a ``Data``
container and write the graph into ``obsp``; the port's functions take the
arrays and return the graph. :class:`StagateGraph`, which STAGATE's
container pipeline runs, is also JAX's transform on a port ``Data``,
registered under JAX's key in the port's own registry.
The dense matrices are returned as numpy; the distances are
:func:`~dance_tpu_torch.utils.matrix.pairwise_distance`'s, computed on
``device`` (the card unless the caller names the CPU).
"""

import numpy as np
import scipy.sparse as sp

from dance_tpu_torch.ops.neighbors import knn_graph, radius_graph
from dance_tpu_torch.registry import register_preprocessor
from dance_tpu_torch.transforms.base import BaseTransform
from dance_tpu_torch.utils import resolve_device
from dance_tpu_torch.utils.matrix import pairwise_distance

_MODELS = ("radius", "knn")


def stagate_graph(xy, model_name: str = "radius", *, radius: float = 1,
                  n_neighbors: int = 5) -> sp.csr_matrix:
    """Spot connectivity: every pair within ``radius`` (no self-loops), or
    each spot's ``n_neighbors`` nearest spots including itself, unsymmetrised."""
    if not isinstance(model_name, str) or model_name.lower() not in _MODELS:
        raise ValueError(f"Unknown model {model_name!r}, options: {_MODELS}")
    xy = np.asarray(xy, np.float32)
    if model_name.lower() == "radius":
        return sp.csr_matrix(radius_graph(xy, radius))
    return sp.csr_matrix(knn_graph(xy, n_neighbors, mode="connectivity", include_self=True,
                                   symmetrize=False))


@register_preprocessor("graph", "spatial")
class StagateGraph(BaseTransform):
    """:func:`stagate_graph` of the coordinates in ``channel`` (of
    ``channel_type``) into ``obsp[out]`` as scipy CSR (counterpart:
    ``StagateGraph``, spatial_graph.py:120)."""

    _DISPLAY_ATTRS = ("model_name", "radius", "n_neighbors")

    def __init__(self, model_name: str = "radius", *, radius: float = 1, n_neighbors: int = 5,
                 channel: str = "spatial_pixel", channel_type: str = "obsm", **kwargs):
        super().__init__(**kwargs)
        if not isinstance(model_name, str) or model_name.lower() not in _MODELS:
            raise ValueError(f"Unknown model {model_name!r}, options: {_MODELS}")
        self.model_name = model_name.lower()
        self.radius = radius
        self.n_neighbors = n_neighbors
        self.channel = channel
        self.channel_type = channel_type

    def __call__(self, data):
        xy = data.get_feature(return_type="numpy", channel=self.channel,
                              channel_type=self.channel_type)
        data.data.obsp[self.out] = stagate_graph(xy, self.model_name, radius=self.radius,
                                                 n_neighbors=self.n_neighbors)
        return data


def spagcn_graph(xy, xy_pixel, image, alpha: float, beta: int, *, device="auto") -> np.ndarray:
    """SpaGCN's histology-aware (n, n) float32 distance matrix (counterpart:
    ``SpaGCNGraph``, spatial_graph.py:13): each spot's colour is the mean of
    the ``beta``-wide window of ``image`` round its pixel; ``z`` is the
    variance-weighted mean of the three channels, standardised and scaled
    by ``alpha`` times the largest standard deviation of ``xy``; then the
    Euclidean distances of ``(x, y, z)``."""
    xy = np.asarray(xy)
    xy_pixel = np.asarray(xy_pixel, dtype=int)
    img = np.asarray(image)
    g = np.zeros((xy.shape[0], 3))
    half = round(beta / 2)
    x_lim, y_lim = img.shape[:2]
    for i, (xp, yp) in enumerate(xy_pixel):
        view = img[max(0, xp - half):min(x_lim, xp + half + 1),
                   max(0, yp - half):min(y_lim, yp + half + 1)]
        g[i] = view.mean(axis=(0, 1))
    g_var = g.var(0)
    z = (g * g_var).sum(1, keepdims=True) / max(g_var.sum(), 1e-12)
    z = (z - z.mean()) / max(z.std(), 1e-12)
    z *= xy.std(0).max() * alpha
    xyz = np.hstack((xy, z)).astype(np.float32)
    return pairwise_distance(xyz, dist_func="euclidean", device=resolve_device(device))


def spagcn_graph_2d(xy_pixel, *, device="auto") -> np.ndarray:
    """The plain (n, n) float32 pixel distance matrix (counterpart:
    ``SpaGCNGraph2D``, spatial_graph.py:58)."""
    return pairwise_distance(np.asarray(xy_pixel, np.float32), dist_func="euclidean",
                             device=resolve_device(device))


def sme_graph(xy, xy_pixel, morph, gene, radius: float = 3, *, device="auto") -> np.ndarray:
    """stLearn's spatial-morphological-expression (n, n) float64 weights
    (counterpart: ``SMEGraph``, spatial_graph.py:74): the pixels per
    coordinate unit by a least-squares slope on each axis; spots closer than
    ``radius`` units (1, else 0), times the clipped cosine similarity of the
    ``morph`` features, times the correlation of the ``gene`` features (the
    diagonal of both similarities exactly 1, where JAX's is 1 to rounding)."""
    device = resolve_device(device)
    xy, xy_pixel, morph, gene = (np.asarray(a, dtype=np.float64)
                                 for a in (xy, xy_pixel, morph, gene))

    def slope(a, b):
        a = a - a.mean()
        b = b - b.mean()
        return (a * b).sum() / max((a * a).sum(), 1e-12)

    unit = np.sqrt(slope(xy[:, 0], xy_pixel[:, 0]) ** 2 + slope(xy[:, 1], xy_pixel[:, 1]) ** 2)
    pdist = pairwise_distance(xy_pixel.astype(np.float32), dist_func="euclidean", device=device)
    adj = (pdist < radius * unit).astype(np.float64)
    adj *= np.clip(1 - pairwise_distance(morph, dist_func="cosine", device=device), 0, None)
    adj *= 1 - pairwise_distance(gene, dist_func="correlation", device=device)
    return adj


__all__ = ["StagateGraph", "sme_graph", "spagcn_graph", "spagcn_graph_2d", "stagate_graph"]
