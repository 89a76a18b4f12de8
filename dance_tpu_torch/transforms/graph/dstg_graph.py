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
  inferred], where the transform writes it into ``obsp``.
- The randomized SVD and the kNN are the port's (``ops.linalg``,
  ``ops.neighbors``): an SVD above 1,024 on its short side draws another
  test matrix than JAX's, and a kNN tie at the k-th place may fall the other
  way, so the graphs agree edge for edge only where the embeddings do.
- The DataFrame helpers of the JAX file (``query_knn``, ``knn``, ``mnn``,
  ``filter_edge``, ``construct_link_graph``, ``preprocess_adj``,
  dstg_graph.py:119-202) are the reference's gene-confirmed edge list, which
  no model of the port calls; they are not ported (ROADMAP Queue 1).
"""

import numpy as np
import scipy.sparse as sp
import torch

from dance_tpu_torch.ops.linalg import randomized_svd
from dance_tpu_torch.ops.neighbors import _knn_block
from dance_tpu_torch.utils import resolve_device


def _l2norm(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


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


def _knn(emb_query: np.ndarray, emb_base: np.ndarray, k: int, *, device="auto") -> np.ndarray:
    """Indices of each query row's ``k`` nearest base rows, nearest first
    (counterpart: dstg_graph.py:31)."""
    device = resolve_device(device)
    q = torch.as_tensor(np.asarray(emb_query, np.float32)).to(device)
    x = torch.as_tensor(np.asarray(emb_base, np.float32)).to(device)
    return _knn_block(q, x, min(k, x.shape[0]))[1].cpu().numpy()


def compute_dstg_adj(x_ref, x_inf, k_filter: int = 200, num_cc: int = 30, k_mnn: int = 30,
                     *, device="auto") -> sp.csr_matrix:
    """The MNN link graph of reference and inferred spots, ``D^-1/2 (A + Aᵀ +
    I) D^-1/2``, (n_ref + n_inf) square, float32 CSR (counterpart:
    dstg_graph.py:39). A pair (i, j) links when real spot j is among ref
    spot i's ``k_mnn`` nearest and i among j's; each real spot keeps its
    ``k_filter`` most similar (cosine) links."""
    n_ref, n_inf = len(x_ref), len(x_inf)
    emb_ref, emb_inf = cca_embed(x_ref, x_inf, num_cc, device=device)
    emb_ref, emb_inf = _l2norm(emb_ref), _l2norm(emb_inf)

    k = min(k_mnn, n_ref, n_inf)
    nn_ri = _knn(emb_ref, emb_inf, k, device=device)  # each ref spot: nearest real spots
    nn_ir = _knn(emb_inf, emb_ref, k, device=device)  # each real spot: nearest ref spots

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
    a = a + a.T + sp.eye(n, format="csr", dtype=np.float32)
    deg = np.asarray(a.sum(1)).ravel()
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    return (sp.diags(dinv) @ a @ sp.diags(dinv)).tocsr()


def dstg_link_graph(x_ref, x_inf, k_filter: int = 200, num_cc: int = 30, *,
                    device="auto") -> sp.csr_matrix:
    """The ``DSTGraph`` transform on arrays (counterpart: dstg_graph.py:80-111):
    :func:`compute_dstg_adj` of the two spot sets (spots x genes), read in
    float64 as the transform reads them."""
    return compute_dstg_adj(np.asarray(x_ref, np.float64), np.asarray(x_inf, np.float64),
                            k_filter=k_filter, num_cc=num_cc, device=device)


__all__ = ["cca_embed", "compute_dstg_adj", "dstg_link_graph"]
