"""scanpy-style tools on arrays (counterpart: dance_tpu/sc/tl.py): Louvain
and Leiden over the neighbour graph, PCA, UMAP, marker genes by Wilcoxon
rank sums or Welch's t-test with Benjamini-Hochberg correction, and gene
set scores with cell-cycle phases.

The JAX package reads the connectivities and labels from an ``AnnData`` and
writes ``obs``, ``obsm`` and ``uns``; these take the arrays (the
connectivities of :func:`dance_tpu_torch.sc.pp.neighbors`, label and name
arrays) and return what JAX writes. The statistics and UMAP's epochs run on
``device`` (the CUDA card unless the CPU is named), the statistics in
float64; UMAP's spectral start and its curve fit stay on host scipy, as in
JAX.

Where this differs from the JAX package:

- Genes with equal keys are ordered by gene index. JAX sorts the scores
  (``np.argsort(-score)``) with numpy's default sort, which is not stable,
  so among equal scores (every all-zero gene has a Wilcoxon z of 0) its
  order is numpy's; the port's order is a valid one, and every gene's
  statistics are JAX's.
- UMAP's negative samples come from a torch generator on the device,
  seeded with ``random_state``, where JAX draws them from ``jax.random``;
  ``negatives`` hands in draws of its own (the tests hand in JAX's).
"""

from typing import Dict

import numpy as np
import scipy.sparse as sp
import torch

from dance_tpu_torch.ops.segment import segment_sum_csr
from dance_tpu_torch.ops.sparse import index_order
from dance_tpu_torch.settings import logger
from dance_tpu_torch.utils import resolve_device


def louvain(conn, *, resolution: float = 1.0, random_state: int = 0) -> np.ndarray:
    """Louvain communities of the connectivities (counterpart: tl.py:19),
    labels 0..k-1 (JAX stores them as strings in ``obs``)."""
    from dance_tpu_torch.ops.cluster import louvain as _louvain

    return _louvain(conn, resolution=resolution, seed=random_state)


def leiden(conn, *, resolution: float = 1.0, random_state: int = 0) -> np.ndarray:
    """Leiden-style communities of the connectivities (counterpart: tl.py:27),
    labels 0..k-1."""
    from dance_tpu_torch.ops.cluster import leiden as _leiden

    return _leiden(conn, resolution=resolution, seed=random_state)


def pca(x, *, n_comps: int = 50, random_state: int = 0, device="auto"):
    """:func:`dance_tpu_torch.sc.pp.pca` (counterpart: tl.py:35)."""
    from dance_tpu_torch.sc.pp import pca as _pca

    return _pca(x, n_comps=n_comps, random_state=random_state, device=device)


def _spectral_init(conn, n_components: int) -> np.ndarray:
    """The normalised Laplacian's eigenvectors 1..n_components (host scipy
    ``eigsh``, shift-invert at 0 from a fixed start vector), each scaled to a
    largest magnitude of 10; float32 (counterpart: tl.py:40)."""
    from scipy.sparse.linalg import eigsh

    deg = np.asarray(conn.sum(1)).ravel()
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    lap = sp.eye(conn.shape[0]) - sp.diags(dinv) @ conn @ sp.diags(dinv)
    k = n_components + 1
    v0 = np.full(conn.shape[0], 1.0 / np.sqrt(conn.shape[0]))
    _, vecs = eigsh(lap, k=k, sigma=0, which="LM", v0=v0)
    emb = vecs[:, 1:k]
    return (emb / np.maximum(np.abs(emb).max(0), 1e-12) * 10).astype(np.float32)


def _fit_ab(min_dist: float, spread: float):
    """UMAP's curve ``1 / (1 + a d^2b)`` fitted to ``exp(-(d - min_dist) /
    spread)`` past ``min_dist`` (scipy ``curve_fit``, counterpart:
    tl.py:73-78)."""
    from scipy.optimize import curve_fit

    xv = np.linspace(0, spread * 3, 300)
    yv = np.where(xv < min_dist, 1.0, np.exp(-(xv - min_dist) / spread))
    (a, b), _ = curve_fit(lambda x, a, b: 1.0 / (1.0 + a * x ** (2 * b)), xv, yv, maxfev=10000)
    return float(a), float(b)


def _umap_order(src: torch.Tensor, dst: torch.Tensor, n: int):
    """The update's summation order: each node's terms as a source in edge
    order, then its terms as a destination, the order of JAX's two
    scatter-adds on its CPU (:func:`~dance_tpu_torch.ops.sparse.index_order`
    of ``src`` then ``dst``). The edges stay the same in every epoch, so it
    is built once a layout."""
    return index_order(torch.cat([src, dst]), n)


def _umap_epoch(emb: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                neg: torch.Tensor, alpha: torch.Tensor, a: float, b: float,
                order=None) -> torch.Tensor:
    """One epoch of the layout (counterpart: tl.py:86-105): the attractive
    gradient over every edge and the repulsive one of a negative sample per
    edge, each clipped at ±4, summed into the nodes in the fixed order
    ``order`` (:func:`_umap_order`, built here when None) by one segment
    sum, the same bits on every run, and stepped by ``alpha``. A pair at
    distance 0 with ``b < 1`` gives ``0 ** (b - 1) = inf`` times 0, a NaN,
    as in JAX."""
    d_pos = emb[src] - emb[dst]
    dist2 = (d_pos ** 2).sum(1)
    grad_coef = (-2.0 * a * b * dist2 ** (b - 1.0) / (1.0 + a * dist2 ** b))[:, None] * w[:, None]
    g_pos = torch.clamp(grad_coef * d_pos, -4.0, 4.0)
    d_neg = emb[src] - emb[neg]
    nd2 = (d_neg ** 2).sum(1)
    rep_coef = (2.0 * b / ((0.001 + nd2) * (1.0 + a * nd2 ** b)))[:, None]
    g_neg = torch.clamp(rep_coef * d_neg, -4.0, 4.0) * w[:, None]
    perm, offsets = _umap_order(src, dst, emb.shape[0]) if order is None else order
    terms = torch.cat([alpha * (g_pos + g_neg), -alpha * g_pos])
    return emb + segment_sum_csr(terms.index_select(0, perm), offsets)


def umap(conn, *, n_components: int = 2, random_state: int = 0, n_epochs: int = 200,
         min_dist: float = 0.5, spread: float = 1.0, learning_rate: float = 1.0,
         init: str = "spectral", negatives=None, device="auto") -> np.ndarray:
    """UMAP layout of the connectivities (counterpart: tl.py:54), (n,
    n_components) float32: the spectral start, then ``n_epochs`` epochs of
    :func:`_umap_epoch` on ``device`` over the upper triangle of the
    symmetrised graph (weights over their largest), the step ``alpha``
    falling linearly from ``learning_rate``. The negatives of each epoch are
    uniform node draws from a generator on ``device`` seeded with
    ``random_state``, or ``negatives[epoch]`` where an (n_epochs, edges)
    array is handed in."""
    device = resolve_device(device)
    conn = sp.csr_matrix(conn).astype(np.float64)
    emb0 = _spectral_init(conn, n_components)
    if init == "spectral" and n_epochs == 0:
        return emb0
    a, b = _fit_ab(min_dist, spread)
    coo = sp.coo_matrix(sp.triu(conn.maximum(conn.T), k=1))
    src = torch.as_tensor(coo.row.astype(np.int64)).to(device)
    dst = torch.as_tensor(coo.col.astype(np.int64)).to(device)
    w = torch.as_tensor((coo.data / coo.data.max()).astype(np.float32)).to(device)
    n = conn.shape[0]
    alphas = torch.as_tensor((learning_rate * (1.0 - np.arange(n_epochs) / n_epochs))
                             .astype(np.float32)).to(device)
    if negatives is not None:
        negatives = torch.as_tensor(np.asarray(negatives, np.int64)).to(device)
        if tuple(negatives.shape) != (n_epochs, len(src)):
            raise ValueError(f"negatives {tuple(negatives.shape)}: need (n_epochs, edges) = "
                             f"{(n_epochs, len(src))}")
    gen = torch.Generator(device=device).manual_seed(random_state)
    emb = torch.from_numpy(emb0).to(device)
    order = _umap_order(src, dst, n)
    for epoch in range(n_epochs):
        neg = (negatives[epoch] if negatives is not None
               else torch.randint(0, n, src.shape, generator=gen, device=device))
        emb = _umap_epoch(emb, src, dst, w, neg, alphas[epoch], a, b, order)
    return emb.cpu().numpy()


def _bh_adjust(p) -> torch.Tensor:
    """Benjamini-Hochberg adjusted p-values of a 1-D array, on its device
    (counterpart: tl.py:115). Equal p-values get the same adjusted value
    whatever their order, so the sort's tie order does not matter."""
    p = torch.as_tensor(p, dtype=torch.float64)
    n = len(p)
    sorted_p, order = torch.sort(p, stable=True)
    ranked = sorted_p * n / torch.arange(1, n + 1, dtype=torch.float64, device=p.device)
    ranked = torch.flip(torch.cummin(torch.flip(ranked, (0,)), 0).values, (0,))
    out = torch.empty_like(p)
    out[order] = torch.clamp(ranked, max=1.0)
    return out


def _average_ranks(x: torch.Tensor):
    """Each column's ranks, 1-based with ties averaged (scipy's
    ``rankdata(x, axis=0)``), and each column's tie term Σ(t³ − t) over its
    groups of equal values, as exact float64 integers."""
    n = x.shape[0]
    srt, perm = torch.sort(x, dim=0, stable=True)
    idx = torch.arange(n, device=x.device)[:, None].expand_as(srt)
    new = torch.ones_like(srt, dtype=torch.bool)
    new[1:] = srt[1:] != srt[:-1]
    last = torch.ones_like(new)
    last[:-1] = new[1:]
    start = torch.cummax(torch.where(new, idx, 0), dim=0).values
    end = torch.flip(torch.cummin(torch.flip(torch.where(last, idx, n - 1), (0,)), dim=0).values,
                     (0,))
    ranks = torch.empty_like(x, dtype=torch.float64)
    ranks.scatter_(0, perm, (start + end).to(torch.float64) / 2.0 + 1.0)
    t = (end - start + 1).to(torch.float64)
    tie_term = torch.where(last, t ** 3 - t, 0.0).sum(0)
    return ranks, tie_term


def _ndtr_sf2(z: torch.Tensor) -> torch.Tensor:
    """Two-sided normal p-values ``2 Φ(-|z|)`` in float64, Φ as scipy's
    ``ndtr`` computes it: ``0.5 + 0.5 erf(t)`` for ``|t| < √½``, else ``0.5
    erfc(|t|)``, at ``t = -|z| √½`` (torch's ``ndtr`` loses the tail)."""
    t = -torch.abs(z) * 0.7071067811865476
    y = torch.where(torch.abs(t) < 0.7071067811865476, 0.5 + 0.5 * torch.special.erf(t),
                    0.5 * torch.special.erfc(torch.abs(t)))
    return 2.0 * y


def rank_genes_groups(x, groups, *, method: str = "t-test", n_genes: int = 100,
                      pts: bool = False, corr_method: str = "benjamini-hochberg",
                      gene_names=None, device="auto") -> Dict[str, dict]:
    """Marker genes of each group against the rest (counterpart: tl.py:126),
    in float64 on ``device``. Returns JAX's ``uns`` entry: ``names``,
    ``scores``, ``pvals``, ``pvals_adj`` and ``logfoldchanges`` (with
    ``pts``, ``pts`` and ``pts_rest``, the nonzero shares), each a dict from
    the group's name (``str``) to an array over the genes ordered by
    decreasing score, ties by gene index; ``params`` names the method.

    - ``"wilcoxon"``: rank sums with average ranks over all cells, z-scores
      with the tie correction ``(n + 1) - Σ(t³ − t) / (n (n − 1))`` (an
      all-equal gene's variance is exactly 0 and its z 0), every gene kept
      (``max(n_genes, genes)``, as JAX).
    - ``"t-test"``: Welch's t of the means (``ddof=1`` variances), 0 where
      both variances are 0; the first ``n_genes`` kept.

    The p-values are two-sided normal ``2 Φ(-|score|)``, adjusted by
    Benjamini-Hochberg over all genes (or not, with any other
    ``corr_method``); the log fold change is ``log2((expm1(m1) + 1e-9) /
    (expm1(m0) + 1e-9))`` of the groups' means."""
    if method not in ("wilcoxon", "t-test"):
        raise ValueError(f"unknown method {method!r}")
    device = resolve_device(device)
    xd = x.toarray() if sp.issparse(x) else np.asarray(x)
    xt = torch.as_tensor(np.asarray(xd, np.float64)).to(device)
    groups = np.asarray(groups)
    n, n_g = xt.shape
    names = np.asarray(gene_names) if gene_names is not None else np.arange(n_g).astype(str)
    if method == "wilcoxon":
        ranks, tie_term = _average_ranks(xt)
    out = {k: {} for k in ("names", "scores", "pvals", "pvals_adj", "logfoldchanges")}
    if pts:
        out["pts"], out["pts_rest"] = {}, {}
    keep = max(n_genes, n_g) if method == "wilcoxon" else n_genes
    for g in np.unique(groups):
        m = torch.as_tensor(groups == g).to(device)
        x1, x0 = xt[m], xt[~m]
        n1, n0 = len(x1), len(x0)
        if method == "wilcoxon":
            r1 = ranks[m].sum(0)
            mu = n1 * (n + 1) / 2.0
            sigma2 = (n1 * n0 / 12.0) * ((n + 1) - tie_term / (n * (n - 1)))
            stat = (r1 - mu) / torch.sqrt(torch.clamp(sigma2, min=1e-12))
        else:
            v1 = x1.var(0, correction=1) if n1 > 1 else torch.zeros(n_g, dtype=xt.dtype,
                                                                    device=device)
            v0 = x0.var(0, correction=1) if n0 > 1 else torch.zeros(n_g, dtype=xt.dtype,
                                                                    device=device)
            denom = torch.sqrt(v1 / max(n1, 1) + v0 / max(n0, 1))
            diff = x1.mean(0) - x0.mean(0)
            stat = torch.where(denom > 0, diff / torch.where(denom > 0, denom, 1.0), 0.0)
        p = _ndtr_sf2(stat)
        padj = _bh_adjust(p) if corr_method == "benjamini-hochberg" else p
        # decreasing score, ties by gene index (a stable sort of -score)
        order = torch.sort(-stat, stable=True).indices[:keep]
        lfc = torch.log2((torch.expm1(x1.mean(0)[order]) + 1e-9)
                         / (torch.expm1(x0.mean(0)[order]) + 1e-9))
        key = str(g)
        order_np = order.cpu().numpy()
        out["names"][key] = names[order_np]
        out["scores"][key] = stat[order].cpu().numpy()
        out["pvals"][key] = p[order].cpu().numpy()
        out["pvals_adj"][key] = padj[order].cpu().numpy()
        out["logfoldchanges"][key] = lfc.cpu().numpy()
        if pts:
            out["pts"][key] = (x1 > 0).to(torch.float64).mean(0)[order].cpu().numpy()
            out["pts_rest"][key] = (x0 > 0).to(torch.float64).mean(0)[order].cpu().numpy()
    out["params"] = {"method": method}
    return out


def control_genes(n_genes: int, ctrl_size: int = 50, random_state: int = 0) -> np.ndarray:
    """The control genes of :func:`score_genes`: numpy's draw without
    replacement from ``random_state``, as JAX makes it (tl.py:196, 204)."""
    rng = np.random.default_rng(random_state)
    return rng.choice(n_genes, size=min(ctrl_size, n_genes), replace=False)


def score_genes(x, gene_list, gene_names, *, ctrl_size: int = 50, random_state: int = 0,
                device="auto") -> np.ndarray:
    """Each cell's mean over the genes of ``gene_list`` found in
    ``gene_names`` less its mean over :func:`control_genes` (counterpart:
    tl.py:192), in float64 on ``device``; zeros where no gene is found."""
    names = np.asarray(gene_names)
    known = set(names.tolist())
    genes = [g for g in gene_list if g in known]
    if not genes:
        logger.warning("score_genes: no genes from the list found in var_names")
        return np.zeros(x.shape[0])
    position = {name: i for i, name in reversed(list(enumerate(names.tolist())))}
    idx = torch.as_tensor([position[g] for g in genes])
    ctrl = torch.as_tensor(control_genes(len(names), ctrl_size, random_state))
    device = resolve_device(device)
    xd = x.toarray() if sp.issparse(x) else np.asarray(x)
    xt = torch.as_tensor(np.asarray(xd, np.float64)).to(device)
    score = xt[:, idx.to(device)].mean(1) - xt[:, ctrl.to(device)].mean(1)
    return score.cpu().numpy()


def score_genes_cell_cycle(x, s_genes, g2m_genes, gene_names, *, ctrl_size: int = 50,
                           random_state: int = 0, device="auto"):
    """S and G2M scores (:func:`score_genes`, the same control draw for both)
    and each cell's phase: the higher score's, G1 where both are negative
    (counterpart: tl.py:209). Returns ``(S_score, G2M_score, phase)``."""
    s = score_genes(x, s_genes, gene_names, ctrl_size=ctrl_size, random_state=random_state,
                    device=device)
    g2m = score_genes(x, g2m_genes, gene_names, ctrl_size=ctrl_size,
                      random_state=random_state, device=device)
    phase = np.where(g2m > s, "G2M", "S")
    phase = np.where((s < 0) & (g2m < 0), "G1", phase)
    return s, g2m, phase


__all__ = ["control_genes", "leiden", "louvain", "pca", "rank_genes_groups", "score_genes",
           "score_genes_cell_cycle", "umap"]
