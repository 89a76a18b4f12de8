"""DSTG's pseudo/real spot link graph on arrays (counterpart:
dance_tpu/transforms/graph/dstg_graph.py:17-77).

A CCA embedding of the two spot sets (the SVD of their standardised
cross-product), mutual nearest neighbours in it between pseudo-spots and
real spots, at most ``k_filter`` links kept per real spot, then
``D^-1/2 (A + Aᵀ + I) D^-1/2``. The products, the SVD and the kNN run on
``device`` (the CUDA card unless the CPU is named); the pair logic is
vectorised numpy where JAX loops over Python sets, with the same edges.

Where this differs from the JAX package:

- :func:`dstg_link_graph` is the array form of the ``DSTGraph`` transform: it
  takes the two spot sets and returns the graph, ordered [reference;
  inferred]. :class:`DSTGraph` writes it into ``obsp`` in the container's
  cell order (JAX writes the [reference; inferred] graph as it is, whatever
  the container holds); a cell of neither split has no edge.
- The randomized SVD and the kNN are the port's (``ops.linalg``,
  ``ops.neighbors``): an SVD above 1,024 on its short side draws another
  test matrix than JAX's, and a kNN tie at the k-th place may fall the other
  way, so the graphs agree edge for edge only where the embeddings do.
- The reference-named helpers of the JAX file (``query_knn``, ``knn``,
  ``mnn``, ``filter_edge``, ``construct_link_graph``, ``preprocess_adj``,
  dstg_graph.py:119-202), the reference's gene-confirmed edge list, which
  no model calls, take arrays where JAX takes pandas frames: spots are
  index arrays into the embedding (or columns of the genes x spots
  matrix), genes row indices, and the edge list an (m, 2) array of
  positions in the two spot sets. They and :func:`compute_dstg_adj` share
  one kNN between two sets (:func:`query_knn`: a host KD-tree as in JAX, or
  the blocked float32 search on a device), one L2 row normalisation
  (``transforms.preprocess.l2norm``) and one symmetric normalisation
  (:func:`preprocess_adj`).
"""

import numpy as np
import scipy.sparse as sp
import torch

from dance_tpu_torch.ops.linalg import randomized_svd
from dance_tpu_torch.ops.neighbors import _knn_block
from dance_tpu_torch.registry import register_preprocessor
from dance_tpu_torch.transforms.base import BaseTransform
from dance_tpu_torch.transforms.preprocess import ccaEmbed, l2norm, selectTopGenes
from dance_tpu_torch.utils import resolve_device


def _standardize(x: torch.Tensor) -> torch.Tensor:
    return (x - x.mean(0)) / x.std(0, unbiased=False).clamp(min=1e-12)


def cca_embed(x_ref, x_inf, num_cc: int = 30, *, device="auto"):
    """CCA by the SVD of the standardised cross-product (counterpart:
    dstg_graph.py:21): ``(emb_ref, emb_inf)``, float32 (n_ref, k) and (n_inf,
    k), ``k = min(num_cc, min(n_ref, n_inf) - 1)``. The standardisation and
    the product run in the inputs' precision, the SVD in float32."""
    device = resolve_device(device)
    a = _standardize(torch.as_tensor(np.asarray(x_ref)).to(device))
    b = _standardize(torch.as_tensor(np.asarray(x_inf)).to(device))
    cross = a @ b.T  # (n_ref, n_inf)
    k = min(num_cc, min(cross.shape) - 1)
    u, _, vt = randomized_svd(cross.to(torch.float32), k)
    return u.cpu().numpy(), vt.T.cpu().numpy()


def compute_dstg_adj(x_ref, x_inf, k_filter: int = 200, num_cc: int = 30, k_mnn: int = 30,
                     *, device="auto") -> sp.csr_matrix:
    """The MNN link graph of reference and inferred spots, ``D^-1/2 (A + Aᵀ +
    I) D^-1/2``, (n_ref + n_inf) square, float32 CSR (counterpart:
    dstg_graph.py:39). A pair (i, j) links when real spot j is among ref
    spot i's ``k_mnn`` nearest and i among j's; each real spot keeps its
    ``k_filter`` most similar (cosine) links."""
    device = resolve_device(device)
    n_ref, n_inf = len(x_ref), len(x_inf)
    emb_ref, emb_inf = (l2norm(e).astype(np.float32)
                        for e in cca_embed(x_ref, x_inf, num_cc, device=device))

    k = min(k_mnn, n_ref, n_inf)
    nn_ri = query_knn(emb_inf, k, emb_ref, device=device)[1]  # each ref spot: nearest real spots
    nn_ir = query_knn(emb_ref, k, emb_inf, device=device)[1]  # each real spot: nearest ref spots

    # mutual nearest neighbours: (i, j) with j in nn_ri[i] and i in nn_ir[j]
    ref = np.repeat(np.arange(n_ref), nn_ri.shape[1])
    inf = nn_ri.ravel().astype(np.int64)
    back = np.repeat(np.arange(n_inf), nn_ir.shape[1]) * n_ref + nn_ir.ravel()
    mutual = np.isin(inf * n_ref + ref, back)
    ref, inf = ref[mutual], inf[mutual]

    # at most k_filter links per real spot, the strongest (cosine in the embedding)
    sims = np.einsum("ij,ij->i", emb_inf[inf].astype(np.float64), emb_ref[ref])
    order = np.lexsort((-sims, inf))
    ref, inf = ref[order], inf[order]
    starts = np.searchsorted(inf, inf, side="left")
    keep = np.arange(len(inf)) - starts < k_filter
    rows, cols = n_ref + inf[keep], ref[keep]

    n = n_ref + n_inf
    a = sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)), shape=(n, n))
    return preprocess_adj(a + a.T).tocsr().astype(np.float32)


def dstg_link_graph(x_ref, x_inf, k_filter: int = 200, num_cc: int = 30, *,
                    device="auto") -> sp.csr_matrix:
    """The ``DSTGraph`` transform on arrays (counterpart: dstg_graph.py:80-111):
    :func:`compute_dstg_adj` of the two spot sets (spots x genes), read in
    float64 as the transform reads them."""
    return compute_dstg_adj(np.asarray(x_ref, np.float64), np.asarray(x_inf, np.float64),
                            k_filter=k_filter, num_cc=num_cc, device=device)


@register_preprocessor("graph", "reference")
class DSTGraph(BaseTransform):
    """:func:`dstg_link_graph` of the cells of split ``"pseudo"`` and of
    split ``"test"`` (their ``X``) into ``obsp[out]``, over every cell of
    the container in its order (counterpart: dstg_graph.py:80). The splits
    are class constants, printed in the digest as JAX prints the ones its
    DSTG pipeline gives. The CCA and the kNN run on ``device`` (the card
    unless the CPU is named)."""

    _DISPLAY_ATTRS = ("k_filter", "num_cc", "ref_split", "inf_split")
    ref_split, inf_split = "pseudo", "test"

    def __init__(self, k_filter: int = 200, num_cc: int = 30, *, device="auto", **kwargs):
        super().__init__(**kwargs)
        self.k_filter = k_filter
        self.num_cc = num_cc
        self.device = device

    def __call__(self, data):
        splits = (self.ref_split, self.inf_split)
        x_ref, x_inf = (data.get_feature(return_type="numpy", split_name=split, channel_type="X")
                        for split in splits)
        adj = dstg_link_graph(x_ref, x_inf, k_filter=self.k_filter, num_cc=self.num_cc,
                              device=self.device)
        order = np.concatenate([data.get_split_idx(s, error_on_miss=True) for s in splits])
        n = data.shape[0]
        if len(order) != n or (order != np.arange(n)).any():
            place = sp.csr_matrix((np.ones(len(order), np.float32),
                                   (order, np.arange(len(order)))), shape=(n, len(order)))
            adj = (place @ adj @ place.T).tocsr()
        data.data.obsp[self.out] = adj
        return data


# --------------------------------------------------------------------------
# the reference-named surface (counterpart: dstg_graph.py:119-202)
# --------------------------------------------------------------------------

def query_knn(data, k: int, query=None, *, device=None):
    """``(dist, ind)`` of each query row's ``k`` nearest rows of ``data``
    (the rows of ``data`` without ``query``), nearest first, (m, k) each. By
    a host KD-tree in float64 when ``device`` is None (counterpart:
    dstg_graph.py:119), else by the blocked float32 distance search on
    ``device`` (counterpart: dstg_graph.py:31, which returns the indices)."""
    if device is not None:
        q = torch.as_tensor(np.asarray(data if query is None else query, np.float32))
        x = torch.as_tensor(np.asarray(data, np.float32)).to(device)
        dist, ind = _knn_block(q.to(device), x, min(k, x.shape[0]))
        return dist.cpu().numpy(), ind.cpu().numpy()
    from scipy.spatial import cKDTree

    tree = cKDTree(np.asarray(data))
    dist, ind = tree.query(np.asarray(data if query is None else query), k)
    if k == 1:
        dist, ind = dist[:, None], ind[:, None]
    return dist, ind


def knn(cell_embedding, spots1, spots2, k: int):
    """The four kNN queries between two spot sets, the rows ``spots1`` and
    ``spots2`` of ``cell_embedding`` (counterpart: dstg_graph.py:129):
    ``(nnaa, nnab, nnba, nnbb, spots1, spots2)``, each ``nn`` a
    :func:`query_knn` result (within a set ``k + 1`` with the spot itself,
    across ``k``)."""
    emb = np.asarray(cell_embedding)
    emb1, emb2 = emb[np.asarray(spots1)], emb[np.asarray(spots2)]
    return (query_knn(emb1, k=k + 1), query_knn(data=emb2, k=k, query=emb1),
            query_knn(data=emb1, k=k, query=emb2), query_knn(emb2, k=k + 1), spots1, spots2)


def mnn(neighbors, colnames) -> np.ndarray:
    """Mutual nearest-neighbour pairs of a :func:`knn` bundle (counterpart:
    dstg_graph.py:140): ``(c, j)`` with ``j`` among set 1 spot ``c``'s first 5
    cross neighbours and ``c`` among ``j``'s, one row per matching reverse
    slot; spots of set 1 not in ``colnames`` have none. Returns an (m, 2)
    int64 array of positions in the two sets. The reference's ``num`` is not
    taken: it reads 5 neighbours whatever ``num`` says."""
    ab = np.asarray(neighbors[1][1])[:, :5]  # (n1, 5) set 1 -> set 2
    ba = np.asarray(neighbors[2][1])[:, :5]  # (n2, 5) set 2 -> set 1
    present = np.isin(np.asarray(neighbors[4]), np.asarray(colnames))
    cells = np.repeat(np.arange(ab.shape[0]), ab.shape[1])
    cands = ab.ravel()
    counts = (ba[cands] == cells[:, None]).sum(1) * present[cells]
    keep = np.repeat(np.arange(len(cands)), counts)
    return np.column_stack((cells[keep], cands[keep])).astype(np.int64)


def filter_edge(edges, neighbors, mats, features, k_filter: int) -> np.ndarray:
    """The edges ``(i, j)`` whose set 2 spot ``j`` is among set 1 spot
    ``i``'s ``k_filter`` nearest in the L2-normalised expression of the
    ``features`` rows of the genes x spots ``mats`` (counterpart:
    dstg_graph.py:163)."""
    mats, features = np.asarray(mats), np.asarray(features)
    spots1, spots2 = (np.asarray(s) for s in neighbors[4:6])
    cn1 = l2norm(mats[np.ix_(features, spots1)].T)
    cn2 = l2norm(mats[np.ix_(features, spots2)].T)
    nn = query_knn(data=cn2, k=k_filter, query=cn1)
    edges = np.asarray(edges)
    i, j = edges[:, 0].astype(int), edges[:, 1].astype(int)
    return edges[(nn[1][i] == j[:, None]).any(1)]


def construct_link_graph(pseudo_st, real_st, k_filter: int = 200, num_cc: int = 30, *,
                         device="auto") -> np.ndarray:
    """The reference's gene-confirmed link list of two genes x spots sets
    (counterpart: dstg_graph.py:179): ``ccaEmbed`` (on ``device``), its
    embedding L2-normalised, the 30-NN bundle, :func:`mnn`, the top genes of
    the loadings (``selectTopGenes`` over all components, 100 a component,
    at most 200) and :func:`filter_edge`. Returns (m, 2) positions of
    pseudo-spots and real spots."""
    pseudo_st, real_st = np.asarray(pseudo_st), np.asarray(real_st)
    (embeds, _), loading = ccaEmbed(pseudo_st, real_st, num_cc=num_cc, device=device)
    n1, n2 = pseudo_st.shape[1], real_st.shape[1]
    spots1, spots2 = np.arange(n1), n1 + np.arange(n2)
    neighbor = knn(l2norm(embeds), spots1, spots2, k=30)
    edges = mnn(neighbor, colnames=np.arange(n1 + n2))
    genes = selectTopGenes(loading, range(num_cc), DimGenes=100, maxGenes=200)
    mat = np.concatenate((pseudo_st, real_st), axis=1)
    return filter_edge(edges, neighbor, mat, genes, k_filter)


def preprocess_adj(adj) -> sp.coo_matrix:
    """``D^-1/2 (A + I) D^-1/2`` as scipy COO, float64 for a float32 ``A``
    (counterpart: dstg_graph.py:198)."""
    adj = sp.csr_matrix(adj + sp.eye(adj.shape[0]))
    d_inv_sqrt = sp.diags(1.0 / np.sqrt(np.asarray(adj.sum(1)).ravel()))
    return d_inv_sqrt.dot(adj).dot(d_inv_sqrt).tocoo()


__all__ = ["DSTGraph", "cca_embed", "compute_dstg_adj", "construct_link_graph",
           "dstg_link_graph", "filter_edge", "knn", "mnn", "preprocess_adj", "query_knn"]
