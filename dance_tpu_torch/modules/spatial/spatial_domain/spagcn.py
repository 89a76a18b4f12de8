"""SpaGCN: one graph convolution over histology-aware spot affinities, refined
by DEC, for spatial domains.

Counterpart: dance_tpu/modules/spatial/spatial_domain/spagcn.py
(``_soft_assign`` :25, ``search_l``/``calculate_adj_matrix``/``calculate_p``
:35-72, the SVG tools :93-250, ``SpaGCN`` :251-430). The affinities are
``exp(-d² / 2l²)`` of the spot distance matrix, row-normalised into a dense
``A``; ``z = A (x W)`` from the PCA features, and DEC's KL against a target
refreshed every 3 epochs trains ``W`` and the centres, until fewer than
``tol`` of the spots change cluster between refreshes. The dense ``A`` is
one cuBLAS GEMM a pass on the card; SpaGCN runs no TPU kernel.

Where this differs from the JAX package:

- The length-scale search and ``calculate_p`` run in torch (float32, on
  ``device``, the card unless the caller names the CPU), where JAX runs
  numpy on the host in float32; the sums' rounding differs.
- ``Moran_I`` and ``Geary_C`` return numpy arrays, not pandas Series, and
  ``rank_genes_groups`` returns a dict of arrays with the JAX frame's
  columns; ``get_svgs`` takes the arrays (coordinates, domains, expression,
  gene names) in place of an AnnData. The card's machine has no pandas.
- k-means initialisation draws its restarts from torch generators
  (:func:`~dance_tpu_torch.ops.cluster.kmeans`), not JAX's keys.
- ``history`` records each epoch's loss and seconds, ``epochs_run`` the
  epochs taken before the ``tol`` stop.
- :func:`spagcn_preprocess` is the array front of ``preprocessing_pipeline``:
  it runs the pipeline on a matrix wrapped in a ``Data``.
"""

import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from dance_tpu_torch.modules.base import BaseClusteringMethod, row_positions, wrap_matrix
from dance_tpu_torch.ops.cluster import kmeans, louvain
from dance_tpu_torch.ops.neighbors import knn_graph
from dance_tpu_torch.settings import logger
from dance_tpu_torch.transforms.cell_feature import CellPCA
from dance_tpu_torch.transforms.filter import FilterGenesMatch
from dance_tpu_torch.transforms.graph.spatial_graph import SpaGCNGraph, SpaGCNGraph2D
from dance_tpu_torch.transforms.interface import AnnDataTransform
from dance_tpu_torch.transforms.misc import Compose, SetConfig
from dance_tpu_torch.utils import resolve_device
from dance_tpu_torch.utils.loss import cluster_kl_loss, target_distribution
from dance_tpu_torch.utils.optim import adamw


def _soft_assign(z: torch.Tensor, mu: torch.Tensor, alpha: float = 0.2) -> torch.Tensor:
    """SpaGCN's q (counterpart: spagcn.py:25): the Student-t kernel with
    ``alpha`` = 0.2 raised to ``alpha + 1``, not DEC's ``(alpha + 1) / 2``
    (the reference's trailing ``/ 2`` cancels in the row normalisation)."""
    d2 = torch.sum((z[:, None, :] - mu[None, :, :]) ** 2, dim=-1)
    q = (1.0 / (1.0 + d2 / alpha + 1e-8)) ** (alpha + 1.0)
    return q / torch.sum(q, dim=1, keepdim=True)


def _as_tensor(adj, device: torch.device) -> torch.Tensor:
    if isinstance(adj, torch.Tensor):
        return adj.to(device)
    return torch.as_tensor(np.asarray(adj), device=device)


def calculate_p(adj, l, *, device="auto") -> float:
    """Mean off-self affinity mass ``mean_i Σ_j exp(-d_ij² / 2l²) - 1`` at
    length scale ``l`` (counterpart: spagcn.py:69), on ``device``."""
    adj = _as_tensor(adj, resolve_device(device))
    return float(torch.exp(-(adj ** 2) / (2 * l ** 2)).sum(1).mean() - 1)


def search_l(p: float, adj, start: float = 0.01, end: float = 1000, tol: float = 0.01,
             max_run: int = 100, *, device="auto") -> float:
    """Bisection for the length scale whose affinity mass is within ``tol``
    of ``p`` (counterpart: spagcn.py:35), on ``device``."""
    dev = resolve_device(device)
    adj = _as_tensor(adj, dev)
    lo, hi = start, end
    for _ in range(max_run):
        mid = (lo + hi) / 2
        pm = calculate_p(adj, mid, device=dev)
        if abs(pm - p) < tol:
            return mid
        if pm > p:
            hi = mid
        else:
            lo = mid
    logger.warning("search_l did not converge; returning midpoint")
    return (lo + hi) / 2


def calculate_adj_matrix(x, y, histology: bool = False) -> np.ndarray:
    """The (n, n) float64 distance matrix of the spots at (x, y), from the
    coordinate differences (counterpart: spagcn.py:58); the histology-aware
    form is :func:`~dance_tpu_torch.transforms.graph.spatial_graph.spagcn_graph`."""
    if histology:
        raise NotImplementedError("the histology-aware adjacency is "
                                  "transforms.graph.spatial_graph.spagcn_graph")
    xy = torch.from_numpy(np.stack([np.asarray(x, np.float64), np.asarray(y, np.float64)], 1))
    d2 = ((xy[:, None, :] - xy[None, :, :]) ** 2).sum(-1)
    return torch.sqrt(d2.clamp(min=0.0)).numpy()


def _spatial_knn_w(x, y, k: int = 5) -> np.ndarray:
    """Binary kNN weights over the spot coordinates, zero diagonal."""
    adj = calculate_adj_matrix(x, y)
    n = adj.shape[0]
    w = np.zeros((n, n))
    np.put_along_axis(w, np.argsort(adj, axis=1)[:, :k], 1.0, axis=1)
    np.fill_diagonal(w, 0.0)
    return w


def Moran_I(genes_exp, x, y, k: int = 5, knn: bool = True) -> np.ndarray:
    """Moran's I of each gene (column of ``genes_exp``): ``(n / ΣW) ·
    (x_cᵀ W x_c) / (x_cᵀ x_c)`` over the kNN or the distance weights
    (counterpart: spagcn.py:93)."""
    w = _spatial_knn_w(x, y, k) if knn else calculate_adj_matrix(x, y)
    xv = np.asarray(genes_exp, dtype=np.float64)
    xc = xv - xv.mean(0)
    nom = (xc * (w @ xc)).sum(0)
    den = np.maximum((xc ** 2).sum(0), 1e-12)
    return (len(xv) / w.sum()) * nom / den


def Geary_C(genes_exp, x, y, k: int = 5, knn: bool = True) -> np.ndarray:
    """Geary's C of each gene, ``ΣW_ij (x_i - x_j)²`` expanded as ``rᵀx² +
    cᵀx² - 2 xᵀWx`` (counterpart: spagcn.py:107)."""
    w = _spatial_knn_w(x, y, k) if knn else calculate_adj_matrix(x, y)
    xv = np.asarray(genes_exp, dtype=np.float64)
    x2 = xv ** 2
    nom = (w.sum(1) @ x2) + (w.sum(0) @ x2) - 2 * (xv * (w @ xv)).sum(0)
    xc = xv - xv.mean(0)
    den = np.maximum((xc ** 2).sum(0), 1e-12)
    return (len(xv) / (2 * w.sum())) * nom / den


def count_nbr(target_cluster, cell_id, x, y, pred, radius) -> float:
    """Mean number of spots within ``radius`` of each spot of the target
    domain, itself included (counterpart: spagcn.py:123)."""
    adj = calculate_adj_matrix(x, y)
    return float((adj[np.asarray(pred) == target_cluster] <= radius).sum(1).mean())


def search_radius(target_cluster, cell_id, x, y, pred, start, end, num_min: int = 8,
                  num_max: int = 15, max_run: int = 100) -> Optional[float]:
    """Bisection for a radius giving ``num_min``..``num_max`` neighbours on
    average, or None (counterpart: spagcn.py:132)."""
    num_low = count_nbr(target_cluster, cell_id, x, y, pred, start)
    num_high = count_nbr(target_cluster, cell_id, x, y, pred, end)
    if num_min <= num_low <= num_max:
        return start
    if num_min <= num_high <= num_max:
        return end
    if num_low > num_max or num_high < num_min:
        logger.info("search_radius: adjust start/end bounds")
        return None
    for _ in range(max_run):
        mid = (start + end) / 2
        num_mid = count_nbr(target_cluster, cell_id, x, y, pred, mid)
        if num_min <= num_mid <= num_max:
            logger.info("recommended radius = %s (num_nbr=%s)", mid, num_mid)
            return mid
        if num_mid < num_min:
            start = mid
        else:
            end = mid
    logger.info("search_radius: exact radius not found in %d runs", max_run)
    return None


def find_neighbor_clusters(target_cluster, cell_id, x, y, pred, radius,
                           ratio: float = 1 / 2) -> List:
    """Domains with more spots among the target domain's ``radius``
    neighbourhoods (counted with repeats) than ``ratio`` of their own size,
    most first; the most frequent one when none passes (counterpart:
    spagcn.py:163)."""
    pred = np.asarray(pred)
    within = calculate_adj_matrix(x, y)[pred == target_cluster] <= radius
    labels, counts = np.unique(pred, return_counts=True)
    cluster_num = dict(zip(labels.tolist(), counts.tolist()))
    nbr_counts = {lab: int(within[:, pred == lab].sum()) for lab in labels.tolist()
                  if lab != target_cluster}
    kept = sorted(((k, v) for k, v in nbr_counts.items() if v > ratio * cluster_num[k]),
                  key=lambda t: -t[1])
    if not kept:
        back = sorted(nbr_counts.items(), key=lambda t: -t[1])[:1]
        logger.info("No neighbor domain passed the ratio filter; returning the most frequent "
                    "one. Try bigger radius/smaller ratio.")
        return [back[0][0]] if back else []
    return [t[0] for t in kept]


def rank_genes_groups(x, labels, target_cluster, nbr_list, gene_names=None,
                      adj_nbr: bool = True, log: bool = False) -> Dict[str, np.ndarray]:
    """Target domain against its neighbours, per gene: Wilcoxon rank-sum
    p-values (scipy's ``ranksums``) adjusted by Benjamini-Hochberg, the
    detection fractions in and out, their ratio, the mean expressions and
    the fold change (counterpart: spagcn.py:183). Returns a dict of arrays
    keyed as the JAX frame's columns."""
    from scipy.stats import ranksums

    labels = np.asarray(labels)
    keep = (np.isin(labels, np.asarray(list(nbr_list) + [target_cluster])) if adj_nbr
            else np.ones(len(labels), bool))
    x = np.asarray(x.toarray() if hasattr(x, "toarray") else x, np.float64)[keep]
    in_group = labels[keep] == target_cluster
    xi, xo = x[in_group], x[~in_group]
    pvals = np.array([ranksums(xi[:, j], xo[:, j]).pvalue for j in range(x.shape[1])])
    order = np.argsort(pvals)
    m = len(pvals)
    adj = np.minimum.accumulate((pvals[order] * m / np.arange(1, m + 1))[::-1])[::-1]
    pvals_adj = np.empty(m)
    pvals_adj[order] = np.minimum(adj, 1.0)
    mean_in, mean_out = xi.mean(0), xo.mean(0)
    frac_in, frac_out = (xi > 0).mean(0), (xo > 0).mean(0)
    fold = np.exp(mean_in - mean_out) if log else mean_in / (mean_out + 1e-9)
    genes = np.asarray(gene_names if gene_names is not None else np.arange(x.shape[1]))
    return {"genes": genes, "in_group_fraction": frac_in, "out_group_fraction": frac_out,
            "in_out_group_ratio": frac_in / np.maximum(frac_out, 1e-12),
            "in_group_mean_exp": mean_in, "out_group_mean_exp": mean_out,
            "fold_change": fold, "pvals_adj": pvals_adj}


def refine(sample_id, pred, dis, shape: str = "hexagon") -> List:
    """Majority vote over each spot's ``num_nbs + 1`` nearest spots, itself
    included (6 for ``"hexagon"``, 4 for ``"square"``): a spot whose own
    label holds fewer than half of ``num_nbs`` votes takes the leading label
    when that holds more than half (counterpart: spagcn.py:224). The
    neighbours are numpy's ``argsort``'s, as in JAX: grid spacings tie."""
    pred = np.asarray(pred)
    num_nbs = {"hexagon": 6, "square": 4}.get(shape)
    if num_nbs is None:
        logger.info("Shape not recognized: 'hexagon' (Visium) or 'square' (ST)")
        num_nbs = 6
    n = len(pred)
    nbr_labels = pred[np.argsort(np.asarray(dis), axis=1)[:, :num_nbs + 1]]
    votes = np.zeros((n, int(pred.max()) + 1), int)
    for j in range(nbr_labels.shape[1]):
        votes[np.arange(n), nbr_labels[:, j]] += 1
    flip = (votes[np.arange(n), pred] < num_nbs / 2) & (votes.max(1) > num_nbs / 2)
    return np.where(flip, votes.argmax(1), pred).tolist()


class SpaGCN(BaseClusteringMethod):
    """SpaGCN (counterpart: spagcn.py:251). ``fit((embed, adj))`` takes the
    (n, d) PCA features and the (n, n) distance matrix; ``l`` must be set
    first (:meth:`search_l`, :meth:`set_l`). The arithmetic runs on
    ``device`` (default the CUDA card; the CPU only when named)."""

    _DISPLAY_ATTRS = ("l",)

    def __init__(self, l: Optional[float] = None, device="auto", seed: int = 0,
                 alpha: float = 0.2):
        self.l = l
        self.alpha = alpha
        self.res = None
        self.seed = seed
        self.device = resolve_device(device)

    @staticmethod
    def preprocessing_pipeline(alpha: float = 1, beta: int = 49, dim: int = 50,
                               log_level: str = "INFO", device="auto") -> Compose:
        """Drop the ``ERCC`` and ``MT-`` genes, ``normalize_total`` to 1e4,
        ``log1p``, the histology-aware and the pixel distance matrices into
        ``obsp["SpaGCNGraph"]`` and ``obsp["SpaGCNGraph2D"]``, and the
        ``dim``-component cell PCA, on ``device`` (counterpart:
        spagcn.py:264-277)."""
        return Compose(
            FilterGenesMatch(prefixes=["ERCC", "MT-"]),
            AnnDataTransform("sc.pp.normalize_total", target_sum=1e4),
            AnnDataTransform("sc.pp.log1p"),
            SpaGCNGraph(alpha=alpha, beta=beta, device=device),
            SpaGCNGraph2D(device=device),
            CellPCA(n_components=dim, device=device),
            SetConfig({"feature_channel": ["CellPCA", "SpaGCNGraph", "SpaGCNGraph2D"],
                       "feature_channel_type": ["obsm", "obsp", "obsp"],
                       "label_channel": "label", "label_channel_type": "obs"}),
            log_level=log_level,
        )

    def search_l(self, p, adj, start=0.01, end=1000, tol=0.01, max_run=100) -> float:
        return search_l(p, adj, start, end, tol, max_run, device=self.device)

    def set_l(self, l):
        self.l = l

    def search_set_res(self, x, l, target_num, start: float = 0.4, step: float = 0.1,
                       tol: float = 5e-3, lr: float = 0.05, epochs: int = 10,
                       max_run: int = 10) -> float:
        """A Louvain resolution giving ``target_num`` clusters, by fits of
        ``epochs`` epochs at stepped resolutions; sets and returns it
        (counterpart: spagcn.py:283)."""
        def n_clusters(res):
            clf = SpaGCN(l, seed=self.seed, device=self.device)
            y = clf.fit_predict(x, init_spa=True, init="louvain", res=res, tol=tol, lr=lr,
                                epochs=epochs)
            return len(set(np.asarray(y).tolist()))

        res = start
        old_num = n_clusters(res)
        logger.info("Res = %.4f, num clusters = %d", res, old_num)
        for _ in range(max_run):
            if old_num == target_num:
                break
            old_sign = 1 if old_num < target_num else -1
            new_num = n_clusters(res + step * old_sign)
            logger.info("Res = %.4e, num clusters = %d", res + step * old_sign, new_num)
            if new_num == target_num:
                res = res + step * old_sign
                break
            if (1 if new_num < target_num else -1) == old_sign:
                res = res + step * old_sign
                old_num = new_num
            else:
                step /= 2
        logger.info("Recommended res = %.4f", res)
        self.res = res
        return res

    def get_svgs(self, xy, pred, x, gene_names, target) -> List:
        """Spatially variable genes of domain ``target`` (counterpart:
        spagcn.py:319): the radius giving 10-14 neighbours, up to three
        neighbour domains, the rank-sum test against them, and the genes of
        adjusted p < 0.05, in/out ratio > 1, in-fraction > 0.8 and fold
        change > 1.5, by falling in-fraction (stable, as pandas'
        ``sort_values``)."""
        xy, pred = np.asarray(xy), np.asarray(pred)
        x_array, y_array = xy[:, 0], xy[:, 1]
        cell_id = list(range(len(pred)))
        adj_2d = calculate_adj_matrix(x=x_array, y=y_array)
        nz = adj_2d[adj_2d != 0]
        start, end = np.quantile(nz, 0.001), np.quantile(nz, 0.1)
        r = search_radius(target, cell_id, x_array, y_array, pred, start, end, num_min=10,
                          num_max=14)
        if r is None:
            return []
        nbr_domains = find_neighbor_clusters(target, cell_id, x_array, y_array, pred, r,
                                             ratio=1 / 2)[:3]
        info = rank_genes_groups(x, pred, target, nbr_domains, gene_names, adj_nbr=True,
                                 log=True)
        keep = np.nonzero((info["pvals_adj"] < 0.05) & (info["in_out_group_ratio"] > 1)
                          & (info["in_group_fraction"] > 0.8) & (info["fold_change"] > 1.5))[0]
        keep = keep[np.argsort(-info["in_group_fraction"][keep], kind="stable")]
        return info["genes"][keep].tolist()

    def calc_adj_exp(self, adj) -> torch.Tensor:
        """``exp(-d² / 2l²)`` on the model's device, float32."""
        adj = _as_tensor(adj, self.device).to(torch.float32)
        return torch.exp(-(adj ** 2) / (2 * self.l ** 2))

    def _a_norm(self, adj) -> torch.Tensor:
        a = self.calc_adj_exp(adj)
        return a / a.sum(1, keepdim=True)

    def _optimizer(self, params, opt: str, lr: float, weight_decay: float):
        """optax's chain for ``opt`` (counterpart: spagcn.py:403-410):
        ``"sgd"`` is ``add_decayed_weights`` then ``sgd(momentum=0.9)``,
        which is torch's ``SGD(momentum=0.9, weight_decay=wd)`` (the decay
        added to the gradient before the momentum); otherwise Adam, or
        optax's ``adamw`` with a decay."""
        if opt == "sgd":
            return torch.optim.SGD(params, lr=lr, momentum=0.9, weight_decay=weight_decay)
        if weight_decay:
            return adamw(params, lr, weight_decay=weight_decay)
        return torch.optim.Adam(params, lr=lr)

    def _init_labels(self, feats: np.ndarray, init: str, n_neighbors: int,
                     n_clusters: Optional[int], res: float) -> np.ndarray:
        """Louvain on the ``n_neighbors`` graph of ``feats``, or k-means with
        ``n_clusters`` (10 by default)."""
        if init == "louvain":
            g = knn_graph(feats, min(n_neighbors, len(feats) - 1), mode="connectivity",
                          include_self=False)
            return louvain(g, resolution=res, seed=self.seed)
        return kmeans(feats, n_clusters or 10, seed=self.seed,
                      device=self.device).labels.cpu().numpy()

    def fit(self, x, y=None, *, num_pcs: int = 50, lr: float = 0.005, epochs: int = 2000,
            weight_decay: float = 0, opt: str = "admin", init_spa: bool = True,
            init: str = "louvain", n_neighbors: int = 10, n_clusters: Optional[int] = None,
            res: float = 0.4, tol: float = 1e-3):
        """Counterpart: spagcn.py:347. ``init_spa=False`` clusters the
        features themselves, not their propagation, for the initial
        labels."""
        embed, adj = x
        if self.l is None:
            raise ValueError("l must be set before fitting (use search_l/set_l)")
        dev = self.device
        a_norm = self._a_norm(adj)
        xt = torch.as_tensor(np.asarray(embed, np.float32), device=dev)
        w = torch.eye(xt.shape[1], device=dev)
        z0 = a_norm @ (xt @ w)
        z0_np = z0.cpu().numpy()
        y0 = self._init_labels(z0_np if init_spa else xt.cpu().numpy(), init, n_neighbors,
                               n_clusters, res)
        k = int(y0.max()) + 1
        y0_t = torch.as_tensor(y0, device=dev)
        mu = torch.stack([z0[y0_t == c].mean(0) if (y0 == c).any() else z0.mean(0)
                          for c in range(k)])
        self.w = w.requires_grad_()
        self.mu = mu.requires_grad_()
        optim = self._optimizer([self.w, self.mu], opt, lr, weight_decay)
        self.history: List[Dict[str, float]] = []
        y_last = y0_t
        p = None
        self.epochs_run = epochs
        for epoch in range(epochs):
            t0 = time.perf_counter()
            if epoch % 3 == 0:
                with torch.no_grad():
                    q = _soft_assign(a_norm @ (xt @ self.w), self.mu, self.alpha)
                    p = target_distribution(q)
                    y_now = q.argmax(1)
                    delta = float((y_now != y_last).double().mean())
                    y_last = y_now
                if epoch > 0 and delta < tol:
                    self.epochs_run = epoch
                    break
            optim.zero_grad(set_to_none=True)
            loss = cluster_kl_loss(p, _soft_assign(a_norm @ (xt @ self.w), self.mu, self.alpha))
            loss.backward()
            optim.step()
            self.history.append({"loss": loss.detach(), "seconds": time.perf_counter() - t0})
        for h in self.history:
            h["loss"] = float(h["loss"])
        return self

    def predict_proba(self, x) -> np.ndarray:
        embed, adj = x
        xt = torch.as_tensor(np.asarray(embed, np.float32), device=self.device)
        with torch.no_grad():
            z = self._a_norm(adj) @ (xt @ self.w)
            return _soft_assign(z, self.mu, self.alpha).cpu().numpy()

    def predict(self, x) -> np.ndarray:
        return self.predict_proba(x).argmax(1)


class SpaGCNInputs(NamedTuple):
    embed: np.ndarray    # (n, dim) PCA of the log-normalised expression
    adj: np.ndarray      # (n, n) histology-aware distances
    adj_2d: np.ndarray   # (n, n) pixel distances
    genes: np.ndarray    # the kept gene columns


def spagcn_preprocess(counts, gene_names: Sequence, xy, xy_pixel, image, *, alpha: float = 1,
                      beta: int = 49, dim: int = 50, device="auto") -> SpaGCNInputs:
    """:meth:`SpaGCN.preprocessing_pipeline` on raw ``counts`` (spots x genes)
    named ``gene_names``, wrapped in a ``Data`` with the coordinates ``xy``
    in ``obsm["spatial"]``, the pixels ``xy_pixel`` in
    ``obsm["spatial_pixel"]`` and the HWC ``image`` in ``uns["image"]``,
    for a caller that holds the arrays."""
    data = wrap_matrix(counts, gene_names, uns={"image": image}, spatial=np.asarray(xy),
                       spatial_pixel=np.asarray(xy_pixel))
    SpaGCN.preprocessing_pipeline(alpha, beta, dim, log_level="WARNING", device=device)(data)
    adata = data.data
    return SpaGCNInputs(adata.obsm["CellPCA"], adata.obsp["SpaGCNGraph"],
                        adata.obsp["SpaGCNGraph2D"], row_positions(adata.var_names, gene_names))


__all__ = ["Geary_C", "Moran_I", "SpaGCN", "SpaGCNInputs", "calculate_adj_matrix", "calculate_p",
           "count_nbr", "find_neighbor_clusters", "rank_genes_groups", "refine", "search_l",
           "search_radius", "spagcn_preprocess"]
