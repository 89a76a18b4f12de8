"""The gene-gene similarity graph (counterpart:
dance_tpu/transforms/graph/feature_feature_graph.py:15-67,
``FeatureFeatureGraph``).

:func:`feature_feature_graph` takes the cells x genes matrix and returns the
:class:`~dance_tpu_torch.graph.Graph`; the :class:`FeatureFeatureGraph`
transform does the same on an array, and on a port ``Data`` reads the
feature channel and writes the graph into ``uns[out]``, as JAX's does. The
host arithmetic is the JAX package's numpy and scipy, so the edges and
their weights are the same; the ``rbf`` affinity is computed in float32 by
torch where JAX uses XLA.
"""

import numpy as np
import scipy.sparse as sp
from scipy.stats import spearmanr

from dance_tpu_torch.data.base import BaseData
from dance_tpu_torch.graph import Graph
from dance_tpu_torch.registry import register_preprocessor
from dance_tpu_torch.transforms.base import BaseTransform
from dance_tpu_torch.utils.matrix import dist_to_rbf

SCORE_FUNCS = ("pearson", "spearman", "rbf")


def feature_feature_graph(x, threshold: float = 0.3, *, positive_only: bool = False,
                          normalize_edges: bool = True, score_func: str = "pearson",
                          score_func_kwargs=None) -> Graph:
    """Genes linked where the similarity of their columns in ``x`` is at
    least ``threshold`` in absolute value (only positive ones with
    ``positive_only``), self-loops included, weight 1, then ``D^-1/2 A
    D^-1/2`` with ``normalize_edges``. ``score_func`` is the Pearson or
    Spearman correlation or the RBF affinity of the genes' Euclidean
    distances (``score_func_kwargs`` go to :func:`dist_to_rbf`). The graph
    carries ``info["num_features"]`` and ``ndata["feat"] = xᵀ`` (genes x
    cells, float32)."""
    feat = np.asarray(x.toarray() if sp.issparse(x) else x, dtype=np.float64)
    if score_func == "pearson":
        adj = np.corrcoef(feat.T)
    elif score_func == "spearman":
        adj = np.atleast_2d(spearmanr(feat, axis=0)[0])
    elif score_func == "rbf":
        norm_vec = np.power(feat, 2).sum(0, keepdims=True)
        dist = np.sqrt((norm_vec + norm_vec.T - 2 * feat.T @ feat).clip(0))
        adj = dist_to_rbf(dist, **(score_func_kwargs or {}))
    else:
        raise ValueError(f"Unknown score function {score_func!r}; options: {SCORE_FUNCS}")
    adj = np.asarray(adj, dtype=np.float32)
    adj[(adj > -threshold) & (adj < threshold)] = 0
    if positive_only:
        adj[adj < 0] = 0
    conn = sp.csr_matrix((np.abs(adj) > 0).astype(np.float32))
    g = Graph(conn, info={"num_features": feat.shape[1]})
    g.ndata["feat"] = feat.T.astype(np.float32)
    if normalize_edges:
        g.normalize_edges_sym()
    return g


@register_preprocessor("graph", "feature")
class FeatureFeatureGraph(BaseTransform):
    """:func:`feature_feature_graph` as a transform (counterpart:
    feature_feature_graph.py:15): ``__call__(x)`` returns the graph,
    ``__call__(data)`` writes the graph of the feature channel (float64)
    into ``uns[out]``. The Pearson score and the normalised edges are class
    constants, printed in the digest: no pipeline sets another (the function
    takes every option)."""

    _DISPLAY_ATTRS = ("threshold", "positive_only", "normalize_edges", "score_func")
    normalize_edges, score_func = True, "pearson"

    def __init__(self, threshold: float = 0.3, *, positive_only: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.threshold = threshold
        self.positive_only = positive_only

    def __call__(self, x):
        if isinstance(x, BaseData):
            x.data.uns[self.out] = self(x.get_feature(return_type="numpy"))
            return x
        return feature_feature_graph(x, self.threshold, positive_only=self.positive_only)


__all__ = ["FeatureFeatureGraph", "SCORE_FUNCS", "feature_feature_graph"]
