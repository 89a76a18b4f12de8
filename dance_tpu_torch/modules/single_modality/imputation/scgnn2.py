"""scGNN 2.0: iterative multi-autoencoder EM imputation.

Counterpart: dance_tpu/modules/single_modality/imputation/scgnn2.py
(``_FeatureAE`` :40, ``_GraphAE`` :68, the feature and graph stages
:98-153, the cluster-AE stage :155-216 and :289-321, ``_cluster_labels``
:270, the EM loop ``fit`` :323-400, ``preprocessing_pipeline`` :248-267,
the reference-named helpers :423-544). Each EM round clusters the graph
AE's embedding by Louvain on its kNN graph (trimmed), trains one autoencoder
per cluster, warm-started from the feature AE, on the reference's
"Celltype" objective, and retrains the feature AE on their reconstructions.
scGNN2 runs no TPU kernel: its device work is cuBLAS GEMMs (batched over
the clusters), CSR gathers and segment sums, and elementwise passes.

The cluster AEs train together, as the JAX package's vmap trains them: the
clusters are padded to the largest one (padding rows weigh 0 in the loss),
each weight is stacked over the clusters and every layer is one
``torch.baddbmm``. One Adam over the stacked tensors is one Adam per
cluster, since Adam is elementwise and all clusters take the same steps.

Where this differs from the JAX package:

- The weights are drawn from CPU ``torch.Generator``s seeded with ``seed``
  (the graph AE's from ``seed + 1``); parity tests copy the flax weights in
  (:func:`dance_tpu_torch.utils.params.scgnn2_feature_ae_flax_to_torch` and
  ``scgnn2_graph_ae_flax_to_torch``) by patching :meth:`ScGNN2._make_nets`.
- The reference protocol's VGAE noise comes from a generator on the device
  seeded with ``seed + 1000 + round`` (:meth:`ScGNN2._noise`, which tests
  patch to hand in JAX's); the k-means fallback of the clustering draws its
  restarts from torch generators.
- The stages are Python loops; JAX runs each as one compiled scan.
  ``history`` records each stage's round, loss, epochs and seconds.
- :func:`scgnn2_preprocess` is the array front of ``preprocessing_pipeline``:
  it runs the pipeline on a matrix wrapped in a ``Data``.
"""

import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from dance_tpu_torch.modules.base import BaseRegressionMethod, wrap_matrix
from dance_tpu_torch.modules.single_modality.imputation.magic import imputation_arrays
from dance_tpu_torch.nn.gnn import flax_dense_init_
from dance_tpu_torch.nn.zinb_ae import TorchDense
from dance_tpu_torch.ops.cluster import kmeans, louvain
from dance_tpu_torch.ops.neighbors import knn_graph
from dance_tpu_torch.ops.segment import spmm
from dance_tpu_torch.ops.sparse import csr_from_scipy
from dance_tpu_torch.settings import logger
from dance_tpu_torch.transforms.filter import FilterCellsScanpy, FilterGenesScanpy
from dance_tpu_torch.transforms.interface import AnnDataTransform
from dance_tpu_torch.transforms.mask import CellwiseMaskData
from dance_tpu_torch.transforms.misc import Compose, SaveRaw, SetConfig
from dance_tpu_torch.utils import resolve_device


def _widths(in_dim: int, hidden: Sequence[int]) -> List[Tuple[int, int]]:
    """The (in, out) of the feature AE's layers: the encoder to ``hidden``,
    the decoder back through ``hidden[-2::-1]`` to ``in_dim``."""
    dims = [in_dim, *hidden, *hidden[-2::-1], in_dim]
    return list(zip(dims[:-1], dims[1:]))


def _head(out: torch.Tensor, reference_protocol: bool) -> torch.Tensor:
    """ReLU under the reference protocol, else ``jax.nn.softplus``'s
    ``logaddexp(x, 0)``."""
    if reference_protocol:
        return torch.relu(out)
    return torch.logaddexp(out, torch.zeros((), dtype=out.dtype, device=out.device))


class _FeatureAE(nn.Module):
    """The feature AE, whose architecture the cluster AEs share (counterpart:
    scgnn2.py:40): ReLU layers to ``hidden`` (the last is ``z``), back
    through ``hidden[-2::-1]``, and a softplus head; ``reference_protocol``
    takes torch's ``nn.Linear`` init (:class:`TorchDense`) and a ReLU head.
    ``forward`` returns ``(z, x̂)``."""

    def __init__(self, in_dim: int, hidden: Sequence[int] = (512, 128),
                 reference_protocol: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_enc = len(hidden)
        self.reference_protocol = reference_protocol
        self.layers = nn.ModuleList()
        for a, b in _widths(in_dim, hidden):
            if reference_protocol:
                layer = TorchDense(a, b)
                layer.reset_parameters(generator)
            else:
                layer = nn.Linear(a, b)
                flax_dense_init_(layer, generator)
            self.layers.append(layer)

    def forward(self, x: torch.Tensor):
        h = x
        for i, layer in enumerate(self.layers[:-1]):
            h = torch.relu(layer(h))
            if i == self.n_enc - 1:
                z = h
        return z, _head(self.layers[-1](h), self.reference_protocol)


def stacked_forward(weights: List[torch.Tensor], biases: List[torch.Tensor],
                    x: torch.Tensor, reference_protocol: bool) -> torch.Tensor:
    """:class:`_FeatureAE`'s ``x̂`` for every cluster at once: ``weights[l]``
    (K, in, out), ``biases[l]`` (K, out), ``x`` (K, m, in)."""
    h = x
    for w, b in zip(weights[:-1], biases[:-1]):
        h = torch.relu(torch.baddbmm(b[:, None, :], h, w))
    return _head(torch.baddbmm(biases[-1][:, None, :], h, weights[-1]), reference_protocol)


class _GraphAE(nn.Module):
    """The graph AE (counterpart: scgnn2.py:68): ``h = relu(A Dense_0(z))``,
    ``mu = A Dense_1(h)``; ``variational`` adds ``lv = A Dense_2(h)`` and,
    given ``noise``, returns the sample ``mu + noise · exp(lv)`` (the
    reference's std = exp(logvar), without the ½)."""

    def __init__(self, in_dim: int, z_dim: int = 128, variational: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.variational = variational
        self.denses = nn.ModuleList(nn.Linear(a, z_dim) for a in
                                    (in_dim, z_dim) + ((z_dim,) if variational else ()))
        for d in self.denses:
            flax_dense_init_(d, generator)

    def forward(self, adj, z: torch.Tensor, noise: Optional[torch.Tensor] = None):
        h = torch.relu(spmm(adj, self.denses[0](z)))
        mu = spmm(adj, self.denses[1](h))
        if not self.variational or noise is None:
            return mu
        return mu + noise * torch.exp(spmm(adj, self.denses[2](h)))


def cluster_loss(recon: torch.Tensor, xr: torch.Tensor, xd: torch.Tensor, m: torch.Tensor,
                 gw: torch.Tensor) -> torch.Tensor:
    """The reference's "Celltype" objective of each cluster, summed over the
    clusters (counterpart: ``cluster_loss``, scgnn2.py:172-198): ``0.3`` the
    summed squared error, the norm ``sqrt(max(·, 1e-12))`` of the residual
    on the nonzero entries of ``xd``, ``0.3`` the graph-weighted and ``0.1``
    the cluster-size-weighted row errors. All (K, m, ·), the row mask ``m``
    and the graph weights ``gw`` (K, m)."""
    mse_rows = ((recon - xr) ** 2 * m[..., None]).sum(2)
    bce = mse_rows.sum(1)
    nz = (xd - recon) * (xd != 0) * m[..., None]
    nonzero_regu = torch.sqrt(torch.clamp((nz ** 2).sum((1, 2)), min=1e-12))
    loss = 0.3 * bce + nonzero_regu + 0.3 * (gw * mse_rows).sum(1) + 0.1 * m.sum(1) * bce
    return loss.sum()


def _norm_adjacency(adj: sp.csr_matrix) -> sp.csr_matrix:
    n = adj.shape[0]
    adj_sl = adj + sp.eye(n, format="csr", dtype=np.float32)
    dinv = 1.0 / np.sqrt(np.maximum(np.asarray(adj_sl.sum(1)).ravel(), 1e-12))
    return sp.csr_matrix(sp.diags(dinv) @ adj_sl @ sp.diags(dinv))


class ScGNN2Inputs(NamedTuple):
    x: np.ndarray           # (n, g) float32 log1p of the filtered counts
    x_raw: np.ndarray       # (n, g) float32 filtered counts
    train_mask: np.ndarray  # (n, g) bool
    valid_mask: np.ndarray
    test_mask: np.ndarray
    cells: np.ndarray       # the kept rows of the input
    genes: np.ndarray       # the kept columns


def scgnn2_preprocess(counts, *, min_cells: float = 0.1, mask: bool = True,
                      distr: str = "exp", mask_rate: float = 0.1,
                      seed: Optional[int] = None) -> ScGNN2Inputs:
    """:meth:`ScGNN2.preprocessing_pipeline` on raw ``counts`` (cells x
    genes, numpy or scipy, taken as float32) wrapped in a ``Data``, for a
    caller that holds a matrix. Without ``mask`` the train mask is all ones
    and the others empty."""
    data = wrap_matrix(counts)
    ScGNN2.preprocessing_pipeline(min_cells=min_cells, mask=mask, distr=distr,
                                  mask_rate=mask_rate, seed=seed, log_level="WARNING")(data)
    return ScGNN2Inputs(*imputation_arrays(data))


class ScGNN2(BaseRegressionMethod):
    """scGNN 2.0 (counterpart: scgnn2.py:219). ``fit(x, mask=...)`` takes the
    log-normalised (n, g) matrix and the observed-entry mask; ``predict``
    returns the imputed matrix (observed entries kept when a mask was
    given). ``reference_protocol`` takes the reference's VGAE stage (the
    sampled latent), torch's init, a ReLU head and the unscaled L1 of every
    cluster-AE weight. The arithmetic runs on ``device`` (default the CUDA
    card; the CPU only when named)."""

    _DISPLAY_ATTRS = ("total_epoch", "feature_epoch", "graph_epoch")

    def __init__(self, total_epoch: int = 3, feature_epoch: int = 100, graph_epoch: int = 50,
                 cluster_epoch: int = 50, n_clusters: int = 10, k: int = 10,
                 hidden: Tuple[int, ...] = (512, 128), lr: float = 1e-3,
                 cluster_lr: float = 1e-3, regu_strength: float = 0.9, max_clusters: int = 30,
                 seed: int = 0, reference_protocol: bool = False, device="auto", **kwargs):
        self.reference_protocol = reference_protocol
        self.total_epoch = total_epoch
        self.feature_epoch = feature_epoch
        self.graph_epoch = graph_epoch
        self.cluster_epoch = cluster_epoch
        self.n_clusters = n_clusters
        self.k = k
        self.hidden = tuple(hidden)
        self.lr = lr
        self.cluster_lr = cluster_lr
        self.regu_strength = regu_strength
        self.max_clusters = max_clusters
        self.seed = seed
        self.device = resolve_device(device)

    @staticmethod
    def preprocessing_pipeline(min_cells: float = 0.1, mask: bool = True, distr: str = "exp",
                               mask_rate: float = 0.1, seed: Optional[int] = None,
                               log_level: str = "INFO") -> Compose:
        """Genes expressed in at least ``min_cells`` cells (a float in (0, 1)
        a ratio of the gene count, as JAX resolves it), cells with a count,
        the counts kept (``SaveRaw``), ``log1p`` and the entry masks
        (``CellwiseMaskData``, unless ``mask`` is off) (counterpart:
        scgnn2.py:248-266)."""
        transforms = [
            FilterGenesScanpy(min_cells=min_cells),
            FilterCellsScanpy(min_counts=1),
            SaveRaw(),
            AnnDataTransform("sc.pp.log1p"),
        ]
        if mask:
            transforms.append(CellwiseMaskData(distr=distr, mask_rate=mask_rate, seed=seed))
        transforms.append(SetConfig({
            "feature_channel": [None, "train_mask"] if mask else [None],
            "feature_channel_type": ["X", "layers"] if mask else ["X"],
            "label_channel": [None, None],
            "label_channel_type": ["X", "raw_X"]}))
        return Compose(*transforms, log_level=log_level)

    def _make_nets(self, in_dim: int) -> Tuple[_FeatureAE, _GraphAE]:
        feature = _FeatureAE(in_dim, self.hidden, self.reference_protocol,
                             torch.Generator().manual_seed(self.seed))
        graph = _GraphAE(self.hidden[-1], self.hidden[-1], self.reference_protocol,
                         torch.Generator().manual_seed(self.seed + 1))
        return feature, graph

    def _noise(self, em: int, n_epochs: int, shape) -> List[torch.Tensor]:
        """The reference protocol's standard normals of one graph stage: one
        draw a step and one for the final embedding."""
        gen = torch.Generator(self.device).manual_seed(self.seed + 1000 + em)
        return [torch.randn(shape, generator=gen, device=self.device)
                for _ in range(n_epochs + 1)]

    # -- stages ---------------------------------------------------------------

    def _feature_stage(self, x: torch.Tensor, mask: Optional[torch.Tensor]):
        """``feature_epoch`` full-batch Adam steps of the feature AE on the
        masked MSE (the mean over all entries without a mask), then its
        forward (counterpart: scgnn2.py:98). Returns ``(z, x̂, last loss)``."""
        ae = self.feature_ae
        opt = torch.optim.Adam(ae.parameters(), lr=self.lr)
        denom = mask.sum().clamp(min=1.0) if mask is not None else float(max(x.numel(), 1))
        loss = torch.zeros((), device=x.device)
        for _ in range(self.feature_epoch):
            opt.zero_grad(set_to_none=True)
            se = (x - ae(x)[1]) ** 2
            loss = (se * mask if mask is not None else se).sum() / denom
            loss.backward()
            opt.step()
        with torch.no_grad():
            z, x_hat = ae(x)
        return z, x_hat, loss.detach()

    def _graph_stage(self, z: torch.Tensor, em: int):
        """The embedding's kNN graph, normalised with self-loops, and
        ``graph_epoch`` Adam steps of the graph AE on the MSE of its output
        against ``z`` (counterpart: scgnn2.py:127). Returns ``(z_g, the kNN
        graph, last loss)``."""
        n = z.shape[0]
        adj = knn_graph(z.cpu().numpy(), min(self.k, n - 1), mode="connectivity",
                        include_self=False)
        adj_n = csr_from_scipy(_norm_adjacency(adj)).to(z.device)
        ae = self.graph_ae
        noise = (self._noise(em, self.graph_epoch, z.shape) if self.reference_protocol
                 else [None] * (self.graph_epoch + 1))
        opt = torch.optim.Adam(ae.parameters(), lr=self.lr)
        loss = torch.zeros((), device=z.device)
        for e in range(self.graph_epoch):
            opt.zero_grad(set_to_none=True)
            loss = torch.mean((ae(adj_n, z, noise[e]) - z) ** 2)
            loss.backward()
            opt.step()
        with torch.no_grad():
            z_g = ae(adj_n, z, noise[-1])
        return z_g, adj, loss.detach()

    def _cluster_labels(self, z: torch.Tensor, adj, n: int) -> np.ndarray:
        """Louvain on the kNN graph; k-means (3 restarts) when that gives one
        cluster or more than ``max_clusters``; clusters under ``min(5,
        max(n // 20, 1))`` cells merged into the largest; ids made
        consecutive (counterpart: scgnn2.py:270)."""
        labels = louvain(adj, seed=self.seed)
        uniq = np.unique(labels)
        if len(uniq) < 2 or len(uniq) > self.max_clusters:
            k_cl = min(self.n_clusters, max(n // 10, 2))
            labels = kmeans(z, k_cl, n_init=3, seed=self.seed).labels.cpu().numpy()
        uniq, counts = np.unique(labels, return_counts=True)
        tiny = uniq[counts < min(5, max(n // 20, 1))]
        if len(tiny) and len(uniq) - len(tiny) >= 1:
            labels = np.where(np.isin(labels, tiny), uniq[np.argmax(counts)], labels)
        return np.unique(labels, return_inverse=True)[1]

    def _cluster_ae_stage(self, x_recon: torch.Tensor, x_dropout: torch.Tensor,
                          labels: np.ndarray, adj) -> torch.Tensor:
        """Every cluster's AE from the feature AE's weights, ``cluster_epoch``
        Adam steps on :func:`cluster_loss` (plus the unscaled L1 of its
        weights under the reference protocol), batched over the padded
        clusters; the reconstructions put back in cell order (counterpart:
        scgnn2.py:289)."""
        dev = x_recon.device
        k_cl = int(labels.max()) + 1
        sizes = np.bincount(labels, minlength=k_cl)
        m = int(sizes.max())
        idx = np.zeros((k_cl, m), np.int64)
        row_mask = np.zeros((k_cl, m), np.float32)
        gw = np.zeros((k_cl, m), np.float32)
        adj = sp.csr_matrix(adj)
        for c in range(k_cl):
            members = np.nonzero(labels == c)[0]
            idx[c, :len(members)] = members
            row_mask[c, :len(members)] = 1.0
            gw[c, :len(members)] = np.asarray(adj[members][:, members].sum(0)).ravel()
        idx_t = torch.as_tensor(idx, device=dev)
        mask_t = torch.as_tensor(row_mask, device=dev)
        gw_t = torch.as_tensor(gw, device=dev)
        xr, xd = x_recon[idx_t], x_dropout[idx_t]
        layers = self.feature_ae.layers
        weights = [l.weight.detach().T.expand(k_cl, -1, -1).clone().requires_grad_()
                   for l in layers]
        biases = [l.bias.detach().expand(k_cl, -1).clone().requires_grad_() for l in layers]
        params = weights + biases
        opt = torch.optim.Adam(params, lr=self.cluster_lr)
        ref = self.reference_protocol
        for _ in range(self.cluster_epoch):
            opt.zero_grad(set_to_none=True)
            loss = cluster_loss(stacked_forward(weights, biases, xr, ref), xr, xd, mask_t, gw_t)
            if ref:
                loss = loss + sum(p.abs().sum() for p in params)
            loss.backward()
            opt.step()
        with torch.no_grad():
            recon = stacked_forward(weights, biases, xr, ref)
        keep = mask_t.reshape(-1) > 0
        out = torch.zeros_like(x_recon)
        out[idx_t.reshape(-1)[keep]] = recon.reshape(-1, recon.shape[-1])[keep]
        return out

    # -- EM loop ----------------------------------------------------------------

    def fit(self, x, x_raw=None, mask=None):
        """Counterpart: scgnn2.py:323. ``x_raw`` is accepted for the shared
        imputation signature and not used."""
        dev = self.device
        x_np = np.asarray(x, np.float32)
        n = x_np.shape[0]
        xt = torch.as_tensor(x_np, device=dev)
        mask_t = None if mask is None else torch.as_tensor(np.asarray(mask, np.float32),
                                                           device=dev)
        x_dropout = xt if mask_t is None else xt * mask_t
        self.feature_ae, self.graph_ae = (net.to(dev) for net in self._make_nets(x_np.shape[1]))
        self.history: List[Dict] = []

        def stage(name, em, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            self.history.append({"stage": name, "round": em, "loss": out[-1],
                                 "seconds": time.perf_counter() - t0})
            return out

        z, x_recon, _ = stage("feature", 0, self._feature_stage, x_dropout, mask_t)
        z_g, adj, _ = stage("graph", 0, self._graph_stage, z, 0)
        labels = np.zeros(n, np.int64)
        x_imputed = x_recon
        for em in range(self.total_epoch):
            t0 = time.perf_counter()
            labels = self._cluster_labels(z_g, adj, n)
            x_imputed = self._cluster_ae_stage(x_recon, x_dropout, labels, adj)
            self.history.append({"stage": "cluster", "round": em, "loss": None,
                                 "clusters": int(labels.max()) + 1,
                                 "seconds": time.perf_counter() - t0})
            z, x_recon, f_loss = stage("feature", em + 1, self._feature_stage, x_imputed, None)
            z_g, adj, g_loss = stage("graph", em + 1, self._graph_stage, z, em + 1)
            logger.info("EM round %d: %d clusters, recon %.5f graph %.5f", em,
                        int(labels.max()) + 1, float(f_loss), float(g_loss))
        for h in self.history:
            h["loss"] = None if h["loss"] is None else float(h["loss"])
        imputed = x_imputed.cpu().numpy()
        if mask is None:
            self.imputed = imputed
        else:
            out = x_np.copy()
            missing = np.asarray(mask) == 0
            out[missing] = imputed[missing]
            self.imputed = out
        self.labels = labels
        return self

    def predict(self, x=None, mask=None) -> np.ndarray:
        return self.imputed

    def score(self, true_expr, imputed_expr, mask=None, metric: str = "MSE",
              test_idx=None) -> float:
        """MSE of ``log1p`` (the imputation clipped at 0) or the Pearson
        correlation, over the ``mask`` entries (counterpart: scgnn2.py:406)."""
        true = np.asarray(true_expr, np.float32)
        imp = np.asarray(imputed_expr, np.float32)
        if mask is not None:
            m = np.asarray(mask).astype(bool)
            true, imp = true[m], imp[m]
        if metric == "MSE":
            return float(np.mean((np.log1p(true) - np.log1p(np.maximum(imp, 0))) ** 2))
        if metric == "PCC":
            return float(np.corrcoef(true.ravel(), imp.ravel())[0, 1])
        raise ValueError(f"Unknown metric {metric!r}")


# -- the reference-named graph and cluster helpers (scgnn2.py:423-544) --------

def calculateKNNgraphDistanceMatrixStatsSingleThread(featureMatrix, distanceType="euclidean",
                                                     k=10) -> List[Tuple[int, int, float]]:
    """Each row's ``k`` nearest other rows (by scipy's ``cdist``, the first
    of the argsort dropped) as ``(i, j, 1 / distance)`` edges (counterpart:
    scgnn2.py:423)."""
    from scipy.spatial.distance import cdist

    featureMatrix = np.asarray(featureMatrix)
    dist = cdist(featureMatrix, featureMatrix, distanceType)
    order = dist.argsort(axis=1)
    return [(i, int(j), 1.0 / (dist[i, j] + 1e-16))
            for i in range(featureMatrix.shape[0]) for j in order[i, 1:k + 1]]


def edgeList2edgeDict(edgeList, nodesize) -> Dict[int, List[int]]:
    """Adjacency lists from an edge list (counterpart: scgnn2.py:440)."""
    graphdict = {i: [] for i in range(nodesize)}
    for edge in edgeList:
        graphdict[edge[0]].append(edge[1])
    return graphdict


def generateLouvainCluster(edgeList):
    """Louvain labels of a weighted edge list made symmetric by the larger
    weight, and their count (counterpart: scgnn2.py:448)."""
    n = max(max(e[0], e[1]) for e in edgeList) + 1
    w = [e[2] if len(e) > 2 else 1.0 for e in edgeList]
    adj = sp.csr_matrix((w, ([e[0] for e in edgeList], [e[1] for e in edgeList])), shape=(n, n))
    labels = louvain(adj.maximum(adj.T), seed=0)
    return list(labels), len(set(labels))


def trimClustering(listResult, minMemberinCluster=5, maxClusterNumber=30) -> List[int]:
    """Clusters under ``minMemberinCluster`` members or with an id of
    ``maxClusterNumber`` or more relabelled ``maxClusterNumber``
    (counterpart: scgnn2.py:462)."""
    listResult = list(listResult)
    counts: Dict = {}
    for item in listResult:
        counts[item] = counts.get(item, 0) + 1
    change = {item for item in range(len(set(listResult)))
              if counts.get(item, 0) < minMemberinCluster or item >= maxClusterNumber}
    return [maxClusterNumber if item in change else item for item in listResult]


def feature2adj(X_embed, neighborhood_factor, retain_weights):
    """The kNN adjacency of an embedding (``k`` the factor, or that share
    of the cells), its copy without self-loops and the edge list
    (counterpart: scgnn2.py:475)."""
    n = X_embed.shape[0]
    k = neighborhood_factor if neighborhood_factor > 1 else round(n * neighborhood_factor)
    k = k - 1 if k == n else k
    edge_list = calculateKNNgraphDistanceMatrixStatsSingleThread(X_embed, k=k)
    rows = [e[0] for e in edge_list]
    cols = [e[1] for e in edge_list]
    vals = [e[2] for e in edge_list] if retain_weights else np.ones(len(edge_list))
    adj = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    if not retain_weights:
        adj = ((adj + adj.T) > 0).astype(np.float64)
    adj_train = adj - sp.dia_matrix((adj.diagonal()[np.newaxis, :], [0]), shape=adj.shape)
    adj_train.eliminate_zeros()
    return adj, adj_train, edge_list


def normalize_features_dense(node_features_dense) -> np.ndarray:
    """Rows over their sums, a sum under 1 read as 1 (counterpart:
    scgnn2.py:497)."""
    assert isinstance(node_features_dense, np.ndarray), (
        f"Expected np matrix got {type(node_features_dense)}.")
    return node_features_dense / np.clip(node_features_dense.sum(1, keepdims=True), a_min=1,
                                         a_max=None)


def convert_adj_to_edge_index(adjacency_matrix) -> np.ndarray:
    """The (2, E) nonzero coordinates of a dense adjacency (counterpart:
    scgnn2.py:505)."""
    assert isinstance(adjacency_matrix, np.ndarray), (
        f"Expected NumPy array got {type(adjacency_matrix)}.")
    height, width = adjacency_matrix.shape
    assert height == width, f"Expected square shape got = {adjacency_matrix.shape}."
    return np.stack(np.nonzero(adjacency_matrix))


def edgeList2edgeIndex(edgeList) -> List[List[int]]:
    """``[u, v]`` pairs of a ``(u, v, w)`` edge list (counterpart: scgnn2.py:514)."""
    return [[i[0], i[1]] for i in edgeList]


def normalize_cell_cell_matrix(x) -> np.ndarray:
    """Rows over their sums, zero rows kept 0 (counterpart: scgnn2.py:519)."""
    x = np.asarray(x, dtype=np.float64)
    rowsum = x.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(rowsum != 0, 1.0 / rowsum, 0.0) * x


def generateCelltypeRegu(listResult) -> np.ndarray:
    """The 0/1 same-cluster matrix (counterpart: scgnn2.py:527)."""
    labels = np.asarray(listResult)
    return (labels[:, None] == labels[None, :]).astype(np.float64)


def preprocess_graph(adj, device="auto"):
    """``D^-½ (A + I) D^-½`` as the port's CSR on ``device`` (counterpart:
    scgnn2.py:533)."""
    adj = sp.coo_matrix(adj)
    adj_ = adj + sp.eye(adj.shape[0])
    dis = sp.diags(np.power(np.asarray(adj_.sum(1)).ravel(), -0.5))
    return csr_from_scipy(sp.csr_matrix(adj_.dot(dis).transpose().dot(dis))).to(
        resolve_device(device))


__all__ = ["ScGNN2", "ScGNN2Inputs", "calculateKNNgraphDistanceMatrixStatsSingleThread",
           "cluster_loss", "convert_adj_to_edge_index", "edgeList2edgeDict",
           "edgeList2edgeIndex", "feature2adj", "generateCelltypeRegu", "generateLouvainCluster",
           "normalize_cell_cell_matrix", "normalize_features_dense", "preprocess_graph",
           "scgnn2_preprocess", "stacked_forward", "trimClustering"]
