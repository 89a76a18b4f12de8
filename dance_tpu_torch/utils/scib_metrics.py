"""The scIB joint-embedding metric suite (counterpart:
dance_tpu/utils/scib_metrics.py, itself a first-party rewrite of the scIB
package's formulas):

- ``silhouette_label``: the scaled average silhouette width on cell types,
  (ASW + 1) / 2;
- ``silhouette_batch``: per cell type, the mean over its cells of
  1 - |silhouette by batch|, averaged over the types with two batches or
  more;
- ``nmi_opt_louvain``: the best NMI (arithmetic mean) against the cell types
  of Louvain on the embedding's kNN graph over resolutions 0.1, 0.3 ... 1.9;
- ``graph_connectivity``: per cell type, the share of its cells in the
  largest connected component of its kNN subgraph, averaged;
- ``cell_cycle_conservation``: per batch, 1 - |pcr after - pcr before| /
  pcr before of the S / G2M scores' principal-component regression;
- ``trajectory_conservation``: (|Spearman| + 1) / 2 of the given pseudotime
  against a diffusion pseudotime of the embedding's kNN graph.

The JAX package takes the silhouettes from scikit-learn, which the machine
with the card lacks: :func:`silhouette_samples` computes sklearn's on torch,
the distances in row chunks on the device, rounded as sklearn rounds them
(float32 distances from float64 squares for a float32 input), and a cell of
a one-cell cluster scores 0, as in sklearn. The diffusion pseudotime's power
iteration runs on the device over the dense transition matrix; Louvain runs
on the host (:func:`~dance_tpu_torch.ops.cluster.louvain`), and the PCA of
the regression on the device (:func:`~dance_tpu_torch.ops.linalg.pca`).
"""

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dance_tpu_torch.utils import nmi, resolve_device


def silhouette_samples(x, labels, *, chunk: int = 2048, device="auto") -> np.ndarray:
    """sklearn's ``silhouette_samples`` with the Euclidean metric, float64:
    for each row, (b - a) / max(a, b) with a its mean distance to the rest of
    its cluster and b the least mean distance to another cluster; 0 for a
    row of a one-cell cluster. Needs 2 to n - 1 labels, as sklearn does.
    Runs on ``device`` (the card unless the CPU is named) in chunks of
    ``chunk`` rows."""
    device = resolve_device(device)
    x = np.asarray(x)
    single = x.dtype == np.float32  # sklearn rounds the distances of float32 data to float32
    _, codes = np.unique(np.asarray(labels).ravel(), return_inverse=True)
    n, n_labels = x.shape[0], int(codes.max()) + 1
    if not 2 <= n_labels <= n - 1:
        raise ValueError(f"Number of labels is {n_labels}. Valid values are 2 to n_samples - 1 "
                         f"(inclusive)")
    xd = torch.as_tensor(x, dtype=torch.float64).to(device)
    codes = torch.as_tensor(codes).to(device)
    onehot = F.one_hot(codes, n_labels).to(torch.float64)
    freqs = onehot.sum(0)
    sq = (xd ** 2).sum(1)
    intra, inter = [], []
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        d2 = (-2.0 * xd[lo:hi] @ xd.T + sq[lo:hi, None]) + sq[None, :]
        d = (d2.float().clamp(min=0.0).sqrt().double() if single
             else d2.clamp(min=0.0).sqrt())
        rows = torch.arange(hi - lo, device=device)
        d[rows, rows + lo] = 0.0
        sums = d @ onehot  # (rows, labels) summed distances
        own = codes[lo:hi]
        intra.append(sums[rows, own])
        means = sums / freqs
        means[rows, own] = torch.inf
        inter.append(means.min(1).values)
    intra = torch.cat(intra) / (freqs - 1)[codes]
    inter = torch.cat(inter)
    sil = (inter - intra) / torch.maximum(intra, inter)
    return torch.nan_to_num(sil).cpu().numpy()


def silhouette_score(x, labels, **kwargs) -> float:
    """The mean of :func:`silhouette_samples` (sklearn's ``silhouette_score``)."""
    return float(np.mean(silhouette_samples(x, labels, **kwargs)))


def silhouette_label(emb, labels, device="auto") -> float:
    """(ASW + 1) / 2 on the labels (counterpart: scib_metrics.py:31)."""
    return float((silhouette_score(emb, labels, device=device) + 1) / 2)


def silhouette_batch(emb, batch, group, device="auto") -> float:
    """The mean over the groups with two batches or more and three cells or
    more of the mean 1 - |silhouette by batch| of their cells; NaN without
    such a group (counterpart: scib_metrics.py:36)."""
    emb, batch, group = (np.asarray(a) for a in (emb, batch, group))
    per_group = []
    for g in np.unique(group):
        sel = group == g
        if len(np.unique(batch[sel])) < 2 or sel.sum() < 3:
            continue
        sil = silhouette_samples(emb[sel], batch[sel], device=device)
        per_group.append(float(np.mean(1 - np.abs(sil))))
    return float(np.mean(per_group)) if per_group else float("nan")


def _knn_adj(emb, k: int = 15):
    """The kNN connectivity graph of the embedding, without self-loops,
    symmetric (counterpart: scib_metrics.py:50)."""
    from dance_tpu_torch.ops.neighbors import knn_graph

    emb = np.asarray(emb, np.float32)
    return knn_graph(emb, min(k, emb.shape[0] - 1), mode="connectivity", include_self=False)


def nmi_opt_louvain(emb, labels, k: int = 15, resolutions: Optional[np.ndarray] = None) -> float:
    """The best arithmetic-mean NMI against ``labels`` of Louvain (seed 0) on
    the kNN graph over ``resolutions``, by default 0.1, 0.3 ... 1.9
    (counterpart: scib_metrics.py:57)."""
    from dance_tpu_torch.ops.cluster import louvain

    adj = _knn_adj(emb, k)
    labels = np.asarray(labels)
    best = 0.0
    for res in (resolutions if resolutions is not None else np.arange(0.1, 2.01, 0.2)):
        pred = louvain(adj, resolution=float(res), seed=0)
        best = max(best, nmi(labels, pred, average_method="arithmetic"))
    return best


def graph_connectivity(emb, labels, k: int = 15) -> float:
    """The mean over the labels of the largest connected component's share
    of the label's cells in their kNN subgraph (counterpart:
    scib_metrics.py:72)."""
    import scipy.sparse.csgraph as csgraph

    adj = _knn_adj(emb, k)
    labels = np.asarray(labels)
    fracs = []
    for lab in np.unique(labels):
        idx = np.where(labels == lab)[0]
        if len(idx) < 2:
            fracs.append(1.0)
            continue
        _, comp = csgraph.connected_components(adj[idx][:, idx], directed=False)
        fracs.append(float(np.bincount(comp).max() / len(idx)))
    return float(np.mean(fracs))


def _pcr(emb, covariate, n_comps: int = 50, device="auto") -> float:
    """The variance of the embedding explained by ``covariate`` through
    principal-component regression: each of the first ``n_comps`` PCs'
    least-squares R² on the covariate and an intercept, weighted by the PC's
    share of the variance (counterpart: scib_metrics.py:88). The PCA runs on
    ``device``; the regressions on the host, as in JAX."""
    from dance_tpu_torch.ops.linalg import pca

    emb = np.asarray(emb, np.float32)
    cov = np.asarray(covariate, np.float32)
    if cov.ndim == 1:
        cov = cov[:, None]
    k = min(n_comps, min(emb.shape) - 1)
    res = pca(torch.from_numpy(emb).to(resolve_device(device)), k)
    pcs = res.embedding.cpu().numpy()
    var = res.explained_variance.cpu().numpy()
    x = np.concatenate([cov, np.ones((len(cov), 1), np.float32)], axis=1)
    r2 = []
    for j in range(pcs.shape[1]):
        beta, *_ = np.linalg.lstsq(x, pcs[:, j], rcond=None)
        resid = pcs[:, j] - x @ beta
        tot = np.var(pcs[:, j])
        r2.append(0.0 if tot <= 1e-12 else 1 - np.var(resid) / tot)
    w = var / max(var.sum(), 1e-12)
    return float(np.sum(w * np.asarray(r2)))


def cell_cycle_conservation(emb_pre, emb_post, s_score, g2m_score, batch=None,
                            device="auto") -> float:
    """The mean over batches of five cells or more of max(0, 1 - |pcr after
    - pcr before| / pcr before) of the S and G2M scores; NaN without such a
    batch (counterpart: scib_metrics.py:113)."""
    cc = np.stack([np.asarray(s_score, np.float32), np.asarray(g2m_score, np.float32)], axis=1)
    batch = np.zeros(len(cc)) if batch is None else np.asarray(batch)
    scores = []
    for b in np.unique(batch):
        sel = batch == b
        if sel.sum() < 5:
            continue
        before = _pcr(np.asarray(emb_pre)[sel], cc[sel], device=device)
        after = _pcr(np.asarray(emb_post)[sel], cc[sel], device=device)
        if before <= 1e-12:
            continue
        scores.append(max(1 - abs(after - before) / before, 0.0))
    return float(np.mean(scores)) if scores else float("nan")


def diffusion_pseudotime(emb, root: Optional[int] = None, k: int = 15, n_iter: int = 200,
                         device="auto") -> np.ndarray:
    """Pseudotime of each cell: its distance from the root along the second
    eigenvector of the symmetric transition matrix of the embedding's kNN
    graph (diffusion component 1), scaled to [0, 1]; the root is the cell
    lowest on that vector unless given (counterpart: scib_metrics.py:131).
    ``n_iter`` power iterations, deflated of the first eigenvector, on the
    dense n x n matrix on ``device``."""
    device = resolve_device(device)
    adj = _knn_adj(emb, k)
    adj = (adj + adj.T).tocoo()
    a = torch.zeros(adj.shape, device=device)
    a[torch.as_tensor(adj.row).to(device), torch.as_tensor(adj.col).to(device)] = \
        torch.as_tensor(adj.data, dtype=torch.float32).to(device)
    d = a.sum(1).clamp(min=1e-12)
    t = a / d.sqrt()[:, None] / d.sqrt()[None, :]
    del a
    n = t.shape[0]
    v1 = d.sqrt() / torch.linalg.norm(d.sqrt())
    v = torch.ones(n, device=device) / np.sqrt(n) + 0.01 * torch.arange(n, device=device)
    v = v / torch.linalg.norm(v)
    for _ in range(n_iter):
        v = t @ v
        v = v - (v @ v1) * v1  # deflate the trivial component
        v = v / torch.linalg.norm(v).clamp(min=1e-12)
    dc1 = v.cpu().numpy()
    if root is None:
        root = int(np.argmin(dc1))
    pt = np.abs(dc1 - dc1[root])
    return pt / max(pt.max(), 1e-12)


def trajectory_conservation(emb, pseudotime, labels=None, device="auto") -> float:
    """(|Spearman| + 1) / 2 of the finite entries of ``pseudotime`` against
    the embedding's :func:`diffusion_pseudotime` rooted at the earliest cell;
    NaN under ten finite entries (counterpart: scib_metrics.py:162)."""
    from scipy.stats import spearmanr

    pt_ref = np.asarray(pseudotime, np.float64)
    valid = np.isfinite(pt_ref)
    if valid.sum() < 10:
        return float("nan")
    pt_v = pt_ref[valid]
    dpt = diffusion_pseudotime(np.asarray(emb)[valid], root=int(np.argmin(pt_v)),
                               device=device)
    return float((abs(spearmanr(dpt, pt_v).statistic) + 1) / 2)


def integration_openproblems_suite(emb, cell_type, batch=None, *, emb_pre=None, s_score=None,
                                   g2m_score=None, pseudotime=None, k: int = 15,
                                   device="auto") -> Dict[str, float]:
    """The suite, averaged as the reference averages it (counterpart:
    scib_metrics.py:175): ``final_scores`` is the mean of the finite
    metrics; a metric whose inputs are absent is left out (``asw_batch``
    without two batches, ``cc_cons`` without the scores and ``emb_pre``,
    ``ti_cons`` without a pseudotime)."""
    emb = np.asarray(emb)
    cell_type = np.asarray(cell_type).ravel()
    score: Dict[str, float] = {"asw_label": silhouette_label(emb, cell_type, device=device)}
    if batch is not None and len(np.unique(batch)) > 1:
        score["asw_batch"] = silhouette_batch(emb, batch, cell_type, device=device)
    score["nmi"] = nmi_opt_louvain(emb, cell_type, k=k)
    score["graph_conn"] = graph_connectivity(emb, cell_type, k=k)
    if s_score is not None and g2m_score is not None and emb_pre is not None:
        score["cc_cons"] = cell_cycle_conservation(emb_pre, emb, s_score, g2m_score, batch,
                                                   device=device)
    if pseudotime is not None:
        score["ti_cons"] = trajectory_conservation(emb, pseudotime, cell_type, device=device)
    finite = [v for v in score.values() if np.isfinite(v)]
    score["final_scores"] = float(np.mean(finite)) if finite else float("nan")
    return score


__all__ = ["cell_cycle_conservation", "diffusion_pseudotime", "graph_connectivity",
           "integration_openproblems_suite", "nmi_opt_louvain", "silhouette_batch",
           "silhouette_label", "silhouette_samples", "silhouette_score",
           "trajectory_conservation"]
