"""scMoGNN's graphs on arrays (counterpart:
dance_tpu/transforms/graph/scmogcn_graph.py): the cell-feature bipartite
graph with optional pathway nodes (``ScMoGNNGraph`` :29-60, here
:func:`scmognn_graph`), the MSigDB ``.gmt`` parser (:67), the pathway
co-membership edges between genes (:94) and the enhanced cell-feature graph
(:162).

Host numpy and scipy, the JAX package's own code, so the edges come out
identical. Where this differs: the JAX functions read the ``.gmt`` files
(``pathway_path + ".entrez.gmt"`` and ``".symbols.gmt"``) and may cache
the edges in a ``pw_{subtask}_{weight}.pkl`` beside them; the port reads no
file, and :func:`create_pathway_graph` takes the gene sets themselves, as a
dict or as the two files' text. Its ``(uu, vv, ee)`` edges are what
:func:`~dance_tpu_torch.modules.multi_modality.predict_modality.scmogcn.build_hetero_graph`
takes as ``pathway_edges``.
"""

from collections import defaultdict
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import scipy.sparse as sp

from dance_tpu_torch.graph.base import Graph


def scmognn_graph(x, var_names: Optional[Sequence[str]] = None,
                  pathways: Optional[Mapping[str, Sequence[str]]] = None) -> Graph:
    """The undirected cell-feature graph of ``x`` (cells x features), weighted
    by the values, features first and cells after (counterpart: ``ScMoGNNGraph``,
    :29-60). With ``pathways`` (set name -> gene names, matched against
    ``var_names``) every set adds a feature node joined to each cell by the
    sum of the cell's values over the set's genes. ``info`` holds
    ``num_cells``, ``num_genes`` (features and pathway nodes) and
    ``num_pathways``."""
    feat = sp.csr_matrix(x)
    n_cells, n_feats = feat.shape
    adj_blocks = [feat]
    extra = 0
    if pathways:
        name_to_idx = {n: i for i, n in enumerate(var_names)}
        cols = []
        for genes in pathways.values():
            idx = [name_to_idx[g] for g in genes if g in name_to_idx]
            col = np.zeros((n_cells, 1), np.float32)
            if idx:
                col[:, 0] = np.asarray(feat[:, idx].sum(1)).ravel()
            cols.append(col)
        adj_blocks.append(sp.csr_matrix(np.concatenate(cols, axis=1)))
        extra = len(cols)
    full = sp.hstack(adj_blocks).tocsr()
    n_total = n_feats + extra
    n = n_cells + n_total
    coo = full.tocoo()
    src = np.concatenate([coo.row + n_total, coo.col])
    dst = np.concatenate([coo.col, coo.row + n_total])
    w = np.concatenate([coo.data, coo.data]).astype(np.float32)
    adj = sp.csr_matrix((w, (dst, src)), shape=(n, n))
    return Graph(adj, info={"num_cells": n_cells, "num_genes": n_total, "num_pathways": extra})


def read_gmt(entrez_string: str, symbol_string: str) -> Dict[str, List[str]]:
    """{set name: gene symbols} from the text of paired MSigDB ``.gmt`` dumps
    (counterpart: :67): the entrez text fixes which tokens are set names
    (a non-numeric token opens a set, the one after it, its URL, is
    skipped); the symbols text is read against those names, URLs dropped."""
    gene_sets_entrez = defaultdict(list)
    indicator = 0
    gene_set_name = None
    for ele in entrez_string.split():
        if ele.isnumeric():
            gene_sets_entrez[gene_set_name].append(ele)
        elif indicator == 1:
            indicator = 0
        else:
            indicator = 1
            gene_set_name = ele
    gene_sets_symbols = defaultdict(list)
    for ele in symbol_string.split():
        if ele in gene_sets_entrez:
            gene_set_name = ele
        elif not ele.startswith("http://"):
            gene_sets_symbols[gene_set_name].append(ele)
    return gene_sets_symbols


def create_pathway_graph(gex_features, gene_names: Sequence[str], pathway_weight: str,
                         pathway_threshold: float,
                         gene_sets: Union[Mapping[str, Sequence[str]], Tuple[str, str]]):
    """Directed gene -> gene edges between every two genes of a gene set,
    weighted by ``pathway_weight`` (``"one"``, ``"cos"`` of the genes'
    columns of ``gex_features``, ``"pearson"`` or ``"spearman"``: one minus
    the correlation), kept where ``|weight| > pathway_threshold``
    (counterpart: :94-160). ``gene_sets`` is {set name: gene names} or the
    ``(entrez, symbols)`` text that :func:`read_gmt` parses. Returns the
    ``(uu, vv, ee)`` lists: source genes, destination genes, weights."""
    from scipy.stats import rankdata

    if isinstance(gene_sets, tuple):
        gene_sets = read_gmt(*gene_sets)
    name_to_idx = {n: i for i, n in enumerate(gene_names)}
    pathways = [[name_to_idx[g] for g in genes if g in name_to_idx]
                for genes in gene_sets.values()]
    dense = np.asarray(gex_features.todense() if sp.issparse(gex_features) else gex_features,
                       dtype=np.float64)
    if pathway_weight == "pearson":
        sim_all = 1 - np.corrcoef(dense.T)
    elif pathway_weight == "spearman":
        sim_all = 1 - np.corrcoef(rankdata(dense, axis=0).T)
    else:
        sim_all = None
    uu, vv, ee = [], [], []
    norms = np.sqrt((dense ** 2).sum(0))
    for idx in pathways:
        if len(idx) < 2:
            continue
        idx = np.asarray(idx)
        if pathway_weight == "one":
            block = np.ones((len(idx), len(idx)))
        elif pathway_weight == "cos":
            sub = dense[:, idx]
            block = (sub.T @ sub) / np.maximum(np.outer(norms[idx], norms[idx]), 1e-12)
        elif pathway_weight in ("pearson", "spearman"):
            block = sim_all[np.ix_(idx, idx)]
        else:
            raise ValueError(f"unknown pathway_weight {pathway_weight!r}")
        jj, kk = np.nonzero(~np.eye(len(idx), dtype=bool))
        uu.extend(idx[jj].tolist())
        vv.extend(idx[kk].tolist())
        ee.extend(block[jj, kk].tolist())
    keep = [i for i in range(len(uu)) if abs(ee[i]) > pathway_threshold]
    return [uu[i] for i in keep], [vv[i] for i in keep], [ee[i] for i in keep]


def construct_enhanced_feature_graph(u, v, e, train_size: int, feature_size: int,
                                     cell_node_features, inductive: bool = False,
                                     enhance_graph=None, _test_graph: bool = False) -> Graph:
    """The cell-feature bipartite graph of the edges cell ``u`` - feature
    ``v`` of weight ``e``, both ways, plus the gene -> gene edges
    ``enhance_graph = (uu, vv, ee)`` where given (counterpart: :162).
    Features are nodes [0, feature_size), cells come after; ``ndata
    ["cell_id"]`` holds each feature's index and -1 for cells; ``info``
    holds ``num_cells``, ``num_genes`` and ``cell_node_features`` (the first
    ``train_size`` rows when ``inductive`` and not ``_test_graph``)."""
    u = np.asarray(u, np.int64)
    v = np.asarray(v, np.int64)
    e = np.asarray(e, np.float32)
    cell_node_features = np.asarray(cell_node_features)
    if inductive and not _test_graph:
        cell_node_features = cell_node_features[:train_size]
    n_cells = int(u.max()) + 1 if len(u) else len(cell_node_features)
    n_feat = int(feature_size)
    n = n_feat + n_cells
    src = np.concatenate([u + n_feat, v])
    dst = np.concatenate([v, u + n_feat])
    w = np.concatenate([e, e])
    if enhance_graph is not None:
        uu, vv, ee = enhance_graph
        src = np.concatenate([src, np.asarray(uu, np.int64)])
        dst = np.concatenate([dst, np.asarray(vv, np.int64)])
        w = np.concatenate([w, np.asarray(ee, np.float32)])
    adj = sp.csr_matrix((w, (dst, src)), shape=(n, n))
    ndata = {"cell_id": np.concatenate([np.arange(n_feat), -np.ones(n_cells, np.int64)])}
    return Graph(adj, ndata=ndata, info={"num_cells": n_cells, "num_genes": n_feat,
                                         "cell_node_features": cell_node_features})


__all__ = ["construct_enhanced_feature_graph", "create_pathway_graph", "read_gmt",
           "scmognn_graph"]
