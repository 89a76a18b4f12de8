"""The scMoGNN-era graph helpers on arrays (counterpart:
dance_tpu/transforms/graph_construct.py): the gene x pathway membership
(``construct_pathway_graph`` :22), the cell-feature graphs
(``basic_feature_graph`` :37, ``construct_basic_feature_graph`` :96), the
batch statistics (``batch_features`` :53, ``gen_batch_features`` :119,
``generate_cell_features`` :234), residual feature propagation
(``feature_propagation`` :79), the cosine similarities (:131-145),
``extract_color`` (:148), the propagated cell embeddings
(``basic_feature_graph_propagation`` :164, ``basic_feature_propagation``
:179) and scGNN's kNN edge list (``scGNNgenerateAdj`` :199).

Where JAX reads an ``AnnData`` (``X`` and ``obs["batch"]``), the port takes
``(x, batches)`` pairs. ``feature_propagation`` and
``cosine_similarity_gene`` run on ``device`` (the CUDA card unless the CPU
is named); the sparse and statistical steps are host numpy/scipy, as in JAX,
so their results are JAX's bit for bit. ``construct_pathway_graph`` is not
:func:`~dance_tpu_torch.transforms.graph.scmogcn_graph.create_pathway_graph`:
that one links genes to genes through shared pathways, this one is the
membership matrix itself. ``cosine_similarity_gene`` is scikit-learn's
``cosine_similarity`` written out (rows over their L2 norms, a zero row left
zero), in float64. JAX's unread ``parallelLimit`` and ``verbose`` are not
taken.
"""

from typing import Dict, List, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from dance_tpu_torch.graph import Graph
from dance_tpu_torch.ops.sparse import csr_from_scipy, csr_matmat
from dance_tpu_torch.transforms.cell_feature import batch_means, cell_stats
from dance_tpu_torch.utils import resolve_device


def construct_pathway_graph(var_names: Sequence[str], pathways: Dict[str, List[str]]
                            ) -> sp.csr_matrix:
    """The (genes, pathways) 0/1 membership matrix, float32 (counterpart:
    graph_construct.py:22)."""
    name_to_idx = {n: i for i, n in enumerate(var_names)}
    rows, cols = [], []
    for j, genes in enumerate(pathways.values()):
        for g in genes:
            if g in name_to_idx:
                rows.append(name_to_idx[g])
                cols.append(j)
    data = np.ones(len(rows), np.float32)
    return sp.csr_matrix((data, (rows, cols)), shape=(len(var_names), len(pathways)))


def basic_feature_graph(x, *, normalize_row: bool = True) -> Graph:
    """The undirected cell-feature bipartite graph of the nonzero entries,
    features first, each cell's row normalised to sum 1 unless told not to
    (counterpart: graph_construct.py:37)."""
    x = sp.csr_matrix(x)
    if normalize_row:
        sums = np.asarray(x.sum(1)).ravel()
        x = sp.diags(1.0 / np.maximum(sums, 1e-12)) @ x
    n_cells, n_feats = x.shape
    coo = x.tocoo()
    src = np.concatenate([coo.row + n_feats, coo.col])
    dst = np.concatenate([coo.col, coo.row + n_feats])
    w = np.concatenate([coo.data, coo.data]).astype(np.float32)
    adj = sp.csr_matrix((w, (dst, src)), shape=(n_cells + n_feats,) * 2)
    return Graph(adj, info={"num_cells": n_cells, "num_genes": n_feats})


def batch_features(x, batches) -> np.ndarray:
    """The nine cell statistics (:func:`~dance_tpu_torch.transforms.
    cell_feature.cell_stats`, NaN as 0) averaged over each cell's batch,
    float32 (counterpart: graph_construct.py:53; ``BatchFeature`` shares
    the statistics)."""
    x = np.asarray(x.toarray() if sp.issparse(x) else x, np.float64)
    return batch_means(np.nan_to_num(cell_stats(x)), batches).astype(np.float32)


def feature_propagation(adj, feat, *, n_steps: int = 3, alpha: float = 0.5,
                        normalize: bool = True, device="auto") -> np.ndarray:
    """``h <- alpha feat + (1 - alpha) A h`` for ``n_steps`` steps from
    ``h = feat``, ``A`` row-normalised unless told not to (counterpart:
    graph_construct.py:79), each product a CSR SpMM in float32 on
    ``device``."""
    adj = sp.csr_matrix(adj)
    if normalize:
        deg = np.asarray(adj.sum(1)).ravel()
        adj = sp.diags(1.0 / np.maximum(deg, 1e-12)) @ adj
    device = resolve_device(device)
    a = csr_from_scipy(adj).to(device)
    f = torch.from_numpy(np.asarray(feat, np.float32)).to(device)
    h = f
    for _ in range(n_steps):
        h = alpha * f + (1 - alpha) * csr_matmat(a, h)
    return h.cpu().numpy()


def gen_batch_features(inputs: Sequence[Tuple[object, object]]) -> np.ndarray:
    """:func:`batch_features` of each ``(x, batches)`` sub-dataset, stacked
    (counterpart: graph_construct.py:119, over AnnData objects)."""
    if len(inputs) >= 10:
        raise ValueError("gen_batch_features expects a short list of (x, batches) pairs "
                         "(one per sub-dataset)")
    return np.concatenate([batch_features(x, b) for x, b in inputs], axis=0)


def construct_basic_feature_graph(feature_mod1, feature_mod1_test=None,
                                  bf_input=None) -> Graph:
    """The cell-feature graph of the training (and test) cells with the raw
    nonzero weights; ``ndata["bf"]`` holds the batch features of
    ``bf_input`` (``(x, batches)`` pairs) for the cells and zeros for the
    features, or zeros (counterpart: graph_construct.py:96)."""
    x = sp.csr_matrix(feature_mod1)
    if feature_mod1_test is not None:
        xt = sp.csr_matrix(feature_mod1_test)
        if xt.shape[1] != x.shape[1]:
            raise ValueError("train/test feature dims differ")
        x = sp.vstack([x, xt], format="csr")
    g = basic_feature_graph(x, normalize_row=False)
    n_cells, n_feats = x.shape
    if bf_input is not None:
        bf = gen_batch_features(bf_input)
        g.ndata["bf"] = np.concatenate([np.zeros((n_feats, bf.shape[1]), np.float32), bf],
                                       axis=0)
    else:
        g.ndata["bf"] = np.zeros(n_feats + n_cells, np.float32)
    return g


def csr_cosine_similarity(input_csr_matrix) -> np.ndarray:
    """The dense cosine similarities of sparse rows, a zero row 0 (counterpart:
    graph_construct.py:131), host scipy."""
    similarity = input_csr_matrix * input_csr_matrix.T
    square_mag = similarity.diagonal()
    with np.errstate(divide="ignore"):
        inv_square_mag = 1.0 / square_mag
    inv_square_mag[np.isinf(inv_square_mag)] = 0
    inv_mag = np.sqrt(inv_square_mag)
    return np.asarray(similarity.multiply(inv_mag).T.multiply(inv_mag).todense())


def cosine_similarity_gene(input_matrix, *, device="auto") -> np.ndarray:
    """``|cosine similarity|`` between the rows, float64 on ``device``
    (counterpart: graph_construct.py:142, scikit-learn's)."""
    x = input_matrix.toarray() if sp.issparse(input_matrix) else np.asarray(input_matrix)
    xt = torch.from_numpy(np.asarray(x, np.float64)).to(resolve_device(device))
    norm = torch.linalg.vector_norm(xt, dim=1, keepdim=True)
    xn = xt / torch.where(norm == 0, 1.0, norm)
    return (xn @ xn.T).abs().cpu().numpy()


def extract_color(x_pixel=None, y_pixel=None, image=None, beta=49) -> np.ndarray:
    """The variance-weighted grey level of each spot's ``beta``-wide image
    patch (counterpart: graph_construct.py:148), host numpy."""
    beta_half = round(beta / 2)
    max_x, max_y = image.shape[0], image.shape[1]
    g = []
    for xi, yi in zip(x_pixel, y_pixel):
        nbs = image[max(0, xi - beta_half):min(max_x, xi + beta_half + 1),
                    max(0, yi - beta_half):min(max_y, yi + beta_half + 1)]
        g.append(nbs.mean(axis=(0, 1)))
    g = np.asarray(g)
    c0, c1, c2 = g[:, 0], g[:, 1], g[:, 2]
    vs = np.array([np.var(c0), np.var(c1), np.var(c2)])
    return (c0 * vs[0] + c1 * vs[1] + c2 * vs[2]) / vs.sum()


def basic_feature_graph_propagation(g: Graph, layers: int = 3, alpha: float = 0.5,
                                    beta: float = 0.5, cell_init=None, feature_init="id",
                                    device="auto"):
    """The cell embeddings of propagation layers 2 .. ``layers`` over a
    cell-feature graph (counterpart: graph_construct.py:164), scMoGNN's
    :func:`~dance_tpu_torch.modules.multi_modality.joint_embedding.scmogcn.
    cell_feature_propagation` on ``device``."""
    from dance_tpu_torch.modules.multi_modality.joint_embedding.scmogcn import (
        cell_feature_propagation)

    if layers <= 2:
        raise ValueError("Less than two feature graph propagation layers is equivalent to "
                         "original features.")
    return cell_feature_propagation(g, alpha=alpha, beta=beta, cell_init=cell_init,
                                    feature_init=feature_init, device=device, layers=layers)


def basic_feature_propagation(dataset, layers: int, transformed: bool = True, device="auto"):
    """Both modalities' propagated cell embeddings (counterpart:
    graph_construct.py:179), duck-typed on the legacy
    ``dataset.preprocessed_features`` / ``dataset.sparse_features()``
    protocol, as in JAX."""
    if transformed:
        feats = dataset.preprocessed_features
        g1 = construct_basic_feature_graph(feats["mod1_train"], feats["mod1_test"])
        g2 = construct_basic_feature_graph(feats["mod2_train"], feats["mod2_test"])
    else:
        sf = dataset.sparse_features()
        g1 = construct_basic_feature_graph(sf[0], sf[2])
        g2 = construct_basic_feature_graph(sf[1], sf[3])
    return (basic_feature_graph_propagation(g1, layers, device=device),
            basic_feature_graph_propagation(g2, layers, device=device))


def scGNNgenerateAdj(featureMatrix, graphType="KNNgraph", para=None, adjTag=True):
    """scGNN's kNN edge list and its symmetrised 0/1 adjacency (counterpart:
    graph_construct.py:199): ``para`` is ``"<distance>:<k>"`` (``KNNgraph``,
    scipy's ``cdist`` metric) or ``":<k>"`` (``KNNgraphPairwise``, Minkowski),
    each cell's ``k`` nearest by a stable host sort, itself included.
    Returns ``(adj or None, edge_list)``."""
    from scipy.spatial.distance import cdist

    featureMatrix = np.asarray(featureMatrix)
    distance_type, k = "euclidean", 10
    if para is not None:
        words = str(para).split(":")
        if graphType == "KNNgraphPairwise":
            k = int(words[1])
        else:
            distance_type = words[0]
            if len(words) > 1:
                k = int(words[1])
    dist = cdist(featureMatrix, featureMatrix,
                 metric=distance_type if graphType != "KNNgraphPairwise" else "minkowski")
    edge_list = [(i, int(j)) for i in range(dist.shape[0]) for j in dist[i].argsort()[:k]]
    adj = None
    if adjTag:
        rows, cols = zip(*edge_list)
        n = featureMatrix.shape[0]
        adj = sp.csr_matrix((np.ones(len(edge_list)), (rows, cols)), shape=(n, n))
        adj = ((adj + adj.T) > 0).astype(np.float32)
    return adj, edge_list


def generate_cell_features(inputs, batches=None, *, group_batch: bool = False) -> np.ndarray:
    """The nine cell statistics of each cell, NaN as 0, float32, or with
    ``group_batch`` their means over each batch (counterpart:
    graph_construct.py:234). ``inputs`` is one matrix or a list of them, and
    ``batches`` the matching label arrays (JAX's ``obs["batch"]``; without
    them one batch)."""
    xs = inputs if isinstance(inputs, list) else [inputs]
    if batches is None:
        batches = [None] * len(xs)
    elif not isinstance(inputs, list):
        batches = [batches]
    feats = []
    for x, b in zip(xs, batches):
        b = np.zeros(x.shape[0], int) if b is None else np.asarray(b)
        feats.append(batch_features(x, b if group_batch else np.arange(x.shape[0])))
    return np.concatenate(feats, axis=0)


__all__ = ["basic_feature_graph", "basic_feature_graph_propagation",
           "basic_feature_propagation", "batch_features", "construct_basic_feature_graph",
           "construct_pathway_graph", "cosine_similarity_gene", "csr_cosine_similarity",
           "extract_color", "feature_propagation", "gen_batch_features",
           "generate_cell_features", "scGNNgenerateAdj"]
