"""k-means with k-means++ initialisation on a device, and Louvain and Leiden
community detection on the host (counterparts: ``kmeans``, ``louvain`` and
``leiden``, dance_tpu/ops/cluster.py:18-218).

The JAX package runs the ``n_init`` restarts as one vmapped program; here they
run one after another, and only the choice of the best restart waits for the
device. Random picks come from a CPU ``torch.Generator`` seeded with
``seed + restart`` (as JAX keys restart i with ``seed + i``), so a run on the
card and on the CPU draw the same numbers; they are not JAX's numbers.

Louvain runs on the host in C++ (``csrc/host/louvain.cpp``, a copy of the JAX
package's ``native/louvain.cpp``, built at first use by
:func:`~dance_tpu_torch.ops._build.load_louvain` with the JAX package's
flags), so its labels are the JAX package's bit for bit. Its numpy loop stays
beside it as :func:`louvain_plain`, the spec the tests hold the C++ to;
nothing else calls it. Where the JAX package falls back to that loop when the
library does not build, the port raises.
"""

from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from dance_tpu_torch.utils import resolve_device


class KMeansResult(NamedTuple):
    labels: torch.Tensor   # (n,) int64
    centers: torch.Tensor  # (n_clusters, dim)
    inertia: torch.Tensor  # () sum of squared distances to the assigned centers


def _sq_dists(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    xx = (x ** 2).sum(1)[:, None]
    cc = (centers ** 2).sum(1)[None, :]
    return (xx + cc - 2 * (x @ centers.T)).clamp(min=0.0)


def _kmeans_pp_init(x: torch.Tensor, n_clusters: int, generator: torch.Generator):
    """k-means++ (counterpart: cluster.py:25): the first center uniformly,
    each next one with probability proportional to the squared distance to
    the nearest center so far, drawn by inverse CDF from one uniform each."""
    n = x.shape[0]
    first = int(torch.randint(n, (), generator=generator))
    u = torch.rand(n_clusters, generator=generator, dtype=torch.float64).to(x.device)
    centers = x.new_zeros((n_clusters, x.shape[1]))
    centers[0] = x[first]
    for i in range(1, n_clusters):
        dmin = _sq_dists(x, centers[:i]).min(1).values.double()
        cdf = torch.cumsum(dmin, 0)
        idx = torch.searchsorted(cdf, (u[i] * cdf[-1]).reshape(1), right=True)
        centers[i] = x.index_select(0, idx.clamp(max=n - 1))[0]
    return centers


def _lloyd_step(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """One Lloyd update (counterpart: cluster.py:55); an empty cluster keeps
    its center. The sums are a one-hot matmul, as in JAX, not atomics."""
    labels = _sq_dists(x, centers).argmin(1)
    onehot = F.one_hot(labels, centers.shape[0]).to(x.dtype)
    counts = onehot.sum(0)
    new = (onehot.T @ x) / counts.clamp(min=1.0)[:, None]
    return torch.where(counts[:, None] > 0, new, centers)


def _lloyd(x: torch.Tensor, centers: torch.Tensor, n_iter: int, tol: float = 0.0):
    """``n_iter`` Lloyd steps, or with ``tol > 0`` until the squared shift of
    the centers is at most ``tol`` times the mean per-feature variance, as
    sklearn stops (counterpart: cluster.py:67). Returns (labels, centers,
    inertia)."""
    if tol > 0.0:
        tol_ = float(tol * x.var(0, unbiased=False).mean())
        shift2, i = float("inf"), 0
        while i < n_iter and shift2 > tol_:
            new = _lloyd_step(x, centers)
            shift2 = float(((new - centers) ** 2).sum())
            centers, i = new, i + 1
    else:
        for _ in range(n_iter):
            centers = _lloyd_step(x, centers)
    d2 = _sq_dists(x, centers)
    labels = d2.argmin(1)
    return labels, centers, d2.gather(1, labels[:, None]).sum()


def kmeans(x, n_clusters: int, *, n_init: int = 5, n_iter: int = 100, seed: int = 0,
           tol: float = 0.0, device=None) -> KMeansResult:
    """k-means, the best inertia of ``n_init`` k-means++ restarts (counterpart:
    cluster.py:110). ``x`` is a tensor (run where it lies, or on ``device``)
    or an array (run on ``device``, default the CUDA card; the CPU only when
    named); float32."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.float32))
        device = resolve_device("auto" if device is None else device)
    x = x.to(device=device or x.device, dtype=torch.float32)
    runs = [_lloyd(x, _kmeans_pp_init(x, n_clusters, torch.Generator().manual_seed(seed + i)),
                   n_iter, tol) for i in range(n_init)]
    best = int(torch.stack([inertia for _, _, inertia in runs]).argmin())
    return KMeansResult(*runs[best])


def louvain_labels(adj: sp.csr_matrix, *, resolution: float = 1.0, seed: int = 0,
                   max_passes: int = 10, local_iters: int = 10) -> np.ndarray:
    """The C++ Louvain's raw int32 labels (ids not compacted) of a symmetric
    scipy CSR adjacency (counterpart: dance_tpu/native/__init__.py:225)."""
    from dance_tpu_torch.ops._build import load_louvain

    adj = sp.csr_matrix(adj)
    n = adj.shape[0]
    # the buffers live in these names until the call returns
    indptr = np.ascontiguousarray(adj.indptr, np.int64)
    indices = np.ascontiguousarray(adj.indices, np.int32)
    data = np.ascontiguousarray(adj.data, np.float32)
    labels = np.empty(n, np.int32)
    load_louvain().lib.louvain_csr(indptr.ctypes.data, indices.ctypes.data, data.ctypes.data, n,
                                   float(resolution), int(seed) & 0xFFFFFFFFFFFFFFFF,
                                   int(max_passes), int(local_iters), labels.ctypes.data)
    return labels


def louvain(adj, resolution: float = 1.0, seed: int = 0, max_passes: int = 10) -> np.ndarray:
    """Louvain communities of ``adj`` (scipy or numpy, made symmetric as
    ``adj + adjᵀ``), labels 0..k-1 (counterpart: cluster.py:126): the C++
    library, which raises where it does not build."""
    adj = sp.csr_matrix(adj)
    raw = louvain_labels(adj + adj.T, resolution=resolution, seed=seed, max_passes=max_passes)
    return np.unique(raw, return_inverse=True)[1]


def louvain_plain(adj, resolution: float = 1.0, seed: int = 0,
                  max_passes: int = 10) -> np.ndarray:
    """The numpy loop of :func:`louvain` (counterpart: cluster.py:140-196, the
    JAX package's fallback): two-phase modularity optimisation, a seeded node
    order and up to 10 local-move sweeps a pass, then the graph aggregated
    onto its communities. The spec of the C++ library; the main path does
    not call it."""
    adj = sp.csr_matrix(adj)
    adj = adj + adj.T  # symmetrize
    n0 = adj.shape[0]
    node_map = np.arange(n0)  # community of each original node
    rng = np.random.default_rng(seed)

    for _ in range(max_passes):
        n = adj.shape[0]
        m2 = adj.sum()
        if m2 == 0:
            break
        degrees = np.asarray(adj.sum(axis=1)).ravel()
        comm = np.arange(n)
        comm_deg = degrees.copy()
        improved = False
        order = rng.permutation(n)
        for _ in range(10):  # local move iterations
            moved = False
            for u in order:
                cu = comm[u]
                comm_deg[cu] -= degrees[u]
                start, end = adj.indptr[u], adj.indptr[u + 1]
                nbrs, wts = adj.indices[start:end], adj.data[start:end]
                link_w = {}
                for v, w in zip(nbrs, wts):
                    if v != u:
                        link_w[comm[v]] = link_w.get(comm[v], 0.0) + w
                best_c, best_gain = cu, 0.0
                base = link_w.get(cu, 0.0) - resolution * comm_deg[cu] * degrees[u] / m2
                for c, w in link_w.items():
                    gain = (w - resolution * comm_deg[c] * degrees[u] / m2) - base
                    if gain > best_gain + 1e-12:
                        best_c, best_gain = c, gain
                comm[u] = best_c
                comm_deg[best_c] += degrees[u]
                if best_c != cu:
                    moved = improved = True
            if not moved:
                break
        if not improved:
            break
        # phase 2: aggregate graph
        uniq, inv = np.unique(comm, return_inverse=True)
        node_map = inv[node_map]
        proj = sp.csr_matrix((np.ones(n), (np.arange(n), inv)), shape=(n, len(uniq)))
        adj = (proj.T @ adj @ proj).tocsr()
        if len(uniq) == n:
            break
    _, labels = np.unique(node_map, return_inverse=True)
    return labels


def leiden(adj, resolution: float = 1.0, seed: int = 0) -> np.ndarray:
    """Leiden-style communities (counterpart: cluster.py:199, a stand-in with
    Leiden's call surface): :func:`louvain`, then every community whose
    subgraph is disconnected split into its connected components."""
    from scipy.sparse.csgraph import connected_components

    labels = louvain(adj, resolution=resolution, seed=seed)
    adj = sp.csr_matrix(adj)
    out = labels.copy()
    next_label = labels.max() + 1
    for c in np.unique(labels):
        idx = np.nonzero(labels == c)[0]
        if len(idx) <= 1:
            continue
        sub = adj[idx][:, idx]
        ncomp, comp = connected_components(sub, directed=False)
        if ncomp > 1:
            for k in range(1, ncomp):
                out[idx[comp == k]] = next_label
                next_label += 1
    _, out = np.unique(out, return_inverse=True)
    return out


__all__ = ["KMeansResult", "kmeans", "leiden", "louvain", "louvain_labels", "louvain_plain"]
