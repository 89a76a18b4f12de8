"""Cell-gene bipartite graphs on the container (counterpart:
dance_tpu/transforms/graph/cell_feature_graph.py): the weighted cell-gene
graph of the expression matrix and the cell and gene features in
``obsm``/``varm``, kept in ``uns`` as a host :class:`~dance_tpu_torch.graph.Graph`;
the gene PCA followed by that graph; the directed bipartite graph. Each is
registered under JAX's key in the port's own registry.
"""

from typing import Optional

import numpy as np
import scipy.sparse as sp

from dance_tpu_torch.graph import Graph
from dance_tpu_torch.registry import register_preprocessor
from dance_tpu_torch.transforms.base import BaseTransform
from dance_tpu_torch.transforms.cell_feature import WeightedFeaturePCA


@register_preprocessor("graph", "cell")
class CellFeatureGraph(BaseTransform):
    """Undirected weighted cell-gene graph with in-degree-normalized edges
    and self loops, from ``X`` and the features in ``obsm[cell_feature_channel]``
    and ``varm[gene_feature_channel]`` (counterpart: cell_feature_graph.py:18)."""

    def __init__(self, cell_feature_channel: str,
                 gene_feature_channel: Optional[str] = None, *,
                 mod: Optional[str] = None, normalize_edges: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.cell_feature_channel = cell_feature_channel
        self.gene_feature_channel = gene_feature_channel or cell_feature_channel
        self.mod = mod
        self.normalize_edges = normalize_edges

    def __call__(self, data):
        feat = data.get_feature(return_type="default", mod=self.mod)
        gene_feature = data.get_feature(return_type="numpy",
                                        channel=self.gene_feature_channel, mod=self.mod,
                                        channel_type="varm")
        cell_feature = data.get_feature(return_type="numpy",
                                        channel=self.cell_feature_channel, mod=self.mod,
                                        channel_type="obsm")
        g = Graph.from_cell_feature_matrix(feat, cell_feature, gene_feature,
                                           normalize_edges=self.normalize_edges)
        self.logger.info("Built cell-gene graph: %r", g)
        data.data.uns[self.out] = g
        return data


@register_preprocessor("graph", "cell")
class PCACellFeatureGraph(BaseTransform):
    """:class:`WeightedFeaturePCA` (its PCA on ``device``: the card unless
    the CPU is named) then :class:`CellFeatureGraph` into ``uns[out]``
    (counterpart: cell_feature_graph.py:47)."""

    _DISPLAY_ATTRS = ("n_components", "split_name")

    def __init__(self, n_components: int = 400, split_name: Optional[str] = None, *,
                 normalize_edges: bool = True, feat_norm_mode: Optional[str] = None,
                 feat_norm_axis: int = 0, mod: Optional[str] = None,
                 out: Optional[str] = None, log_level: str = "WARNING", device="auto"):
        super().__init__(out=out, log_level=log_level)
        self.n_components = n_components
        self.split_name = split_name
        self.normalize_edges = normalize_edges
        self.feat_norm_mode = feat_norm_mode
        self.feat_norm_axis = feat_norm_axis
        self.mod = mod
        self.device = device

    def __call__(self, data):
        WeightedFeaturePCA(self.n_components, self.split_name,
                           feat_norm_mode=self.feat_norm_mode,
                           feat_norm_axis=self.feat_norm_axis, device=self.device,
                           log_level=self.log_level)(data)
        CellFeatureGraph(cell_feature_channel="WeightedFeaturePCA", mod=self.mod,
                         normalize_edges=self.normalize_edges,
                         log_level=self.log_level, out=self.out)(data)
        return data


@register_preprocessor("graph", "cell")
class CellFeatureBipartiteGraph(BaseTransform):
    """Directed bipartite cell -> feature graph and its reverse, feature
    nodes first, into ``uns["g"]`` of the data (or of modality ``mod``)
    (counterpart: cell_feature_graph.py:76)."""

    def __init__(self, cell_feature_channel: str, *, mod: Optional[str] = None, **kwargs):
        super().__init__(**kwargs)
        self.cell_feature_channel = cell_feature_channel
        self.mod = mod

    def __call__(self, data):
        feat = data.get_feature(channel=self.cell_feature_channel, return_type="sparse",
                                mod=self.mod)
        feat = sp.csr_matrix(feat)
        n_cells, n_feats = feat.shape
        n = n_cells + n_feats
        coo = feat.tocoo()
        src = np.concatenate([coo.row + n_feats, coo.col])
        dst = np.concatenate([coo.col, coo.row + n_feats])
        w = np.concatenate([coo.data, coo.data]).astype(np.float32)
        adj = sp.csr_matrix((w, (dst, src)), shape=(n, n))
        g = Graph(adj, info={"num_cells": n_cells, "num_genes": n_feats})
        g.ndata["id"] = np.concatenate([np.arange(n_feats), np.arange(n_cells)])
        target = data.data.mod[self.mod] if self.mod is not None else data.data
        target.uns["g"] = g
        return data


__all__ = ["CellFeatureBipartiteGraph", "CellFeatureGraph", "PCACellFeatureGraph"]
