"""graph-sc: a graph-convolution autoencoder on the cell-gene graph, then
k-means of the cell embeddings.

Counterpart: dance_tpu/modules/single_modality/clustering/graphsc.py
(``GCNAE`` :29-57, ``GraphSC`` :60-263, ``InnerProductDecoder`` :277-282,
``preprocessing_pipeline`` :79-108). Full-graph training: every epoch encodes
all nodes with ``WeightedGraphConv`` layers, reconstructs the whole dense
adjacency as ``emb @ embᵀ`` and takes one Adam step on its pos-weighted
BCE. With ``use_bsr=True`` each layer's sum or mean aggregation is one
block-sparse SpMM (the CUDA kernel on the card, forward and on the
transposed tiles backward). ``use_bsr="auto"`` (the default, as in JAX)
takes the format :func:`~dance_tpu_torch.ops.bsr.choose_adj_format` picks
in the natural order (BSR, dense or CSR; CSR off the card) for a sum or
mean, and the CSR adjacency for a max. Max aggregation trains on the CSR adjacency
(``scatter_reduce`` amax), as in JAX; its BSR form, the forward-only max
kernel, serves a layer run without gradients (:func:`spmm` ``op="max"``).

Where this differs from the JAX package:

- Dropout draws its mask from a ``torch.Generator`` on the model's device
  seeded with ``seed``, not from ``jax.random``; weights are drawn from a
  CPU ``torch.Generator``. Parity tests copy the flax weights in
  (:func:`dance_tpu_torch.utils.params.graphsc_flax_to_torch`) and run with
  ``dropout=0``.
- ``fit`` records each epoch's loss and seconds (and ARI with
  ``eval_epoch``) in ``history``, and defines ``z`` after ``epochs=0`` too.
- :func:`graphsc_preprocess` is the array front of
  ``preprocessing_pipeline``: it runs the pipeline on a matrix wrapped in a
  ``Data``.

Under ``fit_distributed`` with ``dp > 1`` (CSR, as it defaults there) each
rank keeps its block rows of the adjacency as a
:class:`~dance_tpu_torch.parallel.sharded_graph.ShardedCSR` (sum and mean
aggregation, graphsc.py:188-196), its rows of the features and of the
dense reconstruction target; the dropout mask is drawn for all nodes and
cut to the rank's rows; the loss is this rank's rows of the Gram matrix
against the gathered embeddings, over the global element count, with the
global BCE weights, and the gradients are summed over ``dp``.

``cluster_method="leiden"`` clusters the cell embeddings by
:func:`~dance_tpu_torch.ops.cluster.leiden` on their 15-NN connectivity
graph (the host C++ Louvain, then the connected-components split), as JAX
does (graphsc.py:255-259); :func:`run_leiden` is the reference-named helper
(:266).
"""

import time
from typing import Dict, List, Optional

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from dance_tpu_torch.data import AnnData, Data
from dance_tpu_torch.graph import Graph
from dance_tpu_torch.modules.base import BaseClusteringMethod
from dance_tpu_torch.nn.gnn import WeightedGraphConv, flax_dense_init_, flax_dropout
from dance_tpu_torch.ops.bsr import resolve_adj_format
from dance_tpu_torch.ops.cluster import kmeans, leiden
from dance_tpu_torch.ops.neighbors import knn_graph
from dance_tpu_torch.ops.segment import AGGREGATIONS
from dance_tpu_torch.ops.sparse import csr_from_scipy
from dance_tpu_torch.parallel.mesh import RowShard, active_dp_mesh, sync_grads
from dance_tpu_torch.parallel.sharded_graph import shard_csr
from dance_tpu_torch.settings import logger
from dance_tpu_torch.transforms.graph.cell_feature_graph import PCACellFeatureGraph
from dance_tpu_torch.transforms.interface import AnnDataTransform
from dance_tpu_torch.transforms.misc import Compose, SetConfig
from dance_tpu_torch.utils import ari, resolve_device
from dance_tpu_torch.utils.loss import binary_ce_logits


class InnerProductDecoder(nn.Module):
    """``sigmoid(z zᵀ)`` adjacency decoder (counterpart: graphsc.py:277)."""

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(z @ z.T)


class GCNAE(nn.Module):
    """Graph-convolution encoder and inner-product decoder (counterpart:
    graphsc.py:29): dropout on the input features, ``n_layers`` x
    (``WeightedGraphConv(norm="none")`` -> ReLU), then ``Dense(hidden_1)``
    and, with ``hidden_2``, ReLU -> ``Dense(hidden_2)``. flax infers the input
    width; torch takes it as ``in_dim``. ``denses`` holds the dense layers in
    the order flax names them (``Dense_0``, ``Dense_1``)."""

    def __init__(self, in_dim: int, agg: str = "sum", hidden_dim: int = 200,
                 hidden_1: int = 300, hidden_2: int = 0, dropout: float = 0.1,
                 n_layers: int = 1):
        super().__init__()
        if agg not in AGGREGATIONS:
            raise ValueError(f"agg must be one of {AGGREGATIONS}, got {agg!r}")
        self.agg, self.dropout = agg, dropout
        self.hidden_1, self.hidden_2 = hidden_1, hidden_2
        self.convs = nn.ModuleList(
            WeightedGraphConv(in_dim if i == 0 else hidden_dim, hidden_dim, norm="none")
            for i in range(n_layers))
        widths = [hidden_dim] + [w for w in (hidden_1, hidden_2) if w]
        self.denses = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.decoder = InnerProductDecoder()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's init: glorot-uniform conv kernels, lecun-normal (truncated
        at two standard deviations) dense kernels, zero biases."""
        for conv in self.convs:
            conv.reset_parameters(generator)
        for dense in self.denses:
            flax_dense_init_(dense, generator)

    def encode(self, adj, feats: torch.Tensor, degrees: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               shard: Optional[RowShard] = None) -> torch.Tensor:
        """The node embeddings; dropout only in training mode. With a
        :class:`~dance_tpu_torch.parallel.sharded_graph.ShardedCSR`,
        ``feats`` and the result are the rank's rows (``shard``), whose
        dropout uniforms are drawn for all nodes and cut to them."""
        rows = shard.stored(feats.device) if shard is not None else None
        h = flax_dropout(feats, self.dropout, generator, rows) if self.training else feats
        for conv in self.convs:
            h = torch.relu(conv(adj, h, agg=self.agg, degrees=degrees))
        if self.hidden_1:
            h = self.denses[0](h)
        if self.hidden_2:
            h = self.denses[-1](torch.relu(h))
        return h

    def forward(self, adj, feats: torch.Tensor, degrees: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """``(sigmoid(emb embᵀ), emb)``, as the flax module returns them."""
        emb = self.encode(adj, feats, degrees, generator)
        return self.decoder(emb), emb


class GraphSC(BaseClusteringMethod):
    """graph-sc (counterpart: graphsc.py:60). ``fit(g)`` trains on a cell-gene
    :class:`~dance_tpu_torch.graph.Graph` (genes first, then cells);
    ``predict`` clusters the cell embeddings with k-means. ``activation``,
    ``in_feats``, ``n_hidden``, ``hidden_relu``, ``hidden_bn`` and
    ``num_workers`` are kept for the signature and unused, as in JAX."""

    _DISPLAY_ATTRS = ("agg", "hidden_dim", "hidden_1", "hidden_2", "n_layers", "n_clusters")

    def __init__(self, agg: str = "sum", activation: str = "relu", in_feats: int = 50,
                 n_hidden: int = 1, hidden_dim: int = 200, hidden_1: int = 300,
                 hidden_2: int = 0, dropout: float = 0.1, n_layers: int = 1,
                 hidden_relu: bool = False, hidden_bn: bool = False, n_clusters: int = 10,
                 cluster_method: str = "kmeans", num_workers: int = 1, device="auto",
                 seed: int = 0):
        if agg not in AGGREGATIONS:
            raise ValueError(f"agg must be one of {AGGREGATIONS}, got {agg!r}")
        if cluster_method not in ("kmeans", "leiden"):
            raise ValueError(f"Unknown clustering {cluster_method!r}")
        self.agg, self.hidden_dim, self.hidden_1, self.hidden_2 = agg, hidden_dim, hidden_1, hidden_2
        self.dropout, self.n_layers = dropout, n_layers
        self.n_clusters, self.cluster_method, self.seed = n_clusters, cluster_method, seed
        self.device = resolve_device(device)
        self.model: Optional[GCNAE] = None
        self.z: Optional[np.ndarray] = None
        self.history: List[Dict[str, float]] = []  # per epoch: epoch, loss, seconds (ari)

    @staticmethod
    def preprocessing_pipeline(n_top_genes: int = 3000, normalize_weights: str = "log_per_cell",
                               n_components: int = 50, normalize_edges: bool = False,
                               log_level: str = "INFO", device="auto") -> Compose:
        """graph-sc's preprocessing of a ``Data`` (:func:`graphsc_preprocess`
        runs it on a matrix): the filters, normalisation and cell_ranger
        HVGs, the standardized gene PCA (on ``device``: the card unless the
        CPU is named) and the cell-gene graph into ``uns["CellFeatureGraph"]``,
        labels from ``obsm["Group"]`` (counterpart: graphsc.py:80-108)."""
        device = resolve_device(device)
        transforms = [
            AnnDataTransform("sc.pp.filter_genes", min_counts=3),
            AnnDataTransform("sc.pp.filter_cells", min_counts=1),
            AnnDataTransform("sc.pp.normalize_total"),
            AnnDataTransform("sc.pp.log1p"),
            AnnDataTransform("sc.pp.highly_variable_genes", min_mean=0.0125, max_mean=4,
                             flavor="cell_ranger", min_disp=0.5,
                             n_top_genes=n_top_genes, subset=True),
        ]
        if normalize_weights == "log_per_cell":
            transforms.extend([AnnDataTransform("sc.pp.log1p"),
                               AnnDataTransform("sc.pp.normalize_total", target_sum=1)])
        elif normalize_weights == "per_cell":
            transforms.append(AnnDataTransform("sc.pp.normalize_total", target_sum=1))
        elif normalize_weights != "none":
            raise ValueError(f"Unknown normalization option {normalize_weights!r}")
        transforms.extend([
            PCACellFeatureGraph(n_components=n_components, normalize_edges=normalize_edges,
                                feat_norm_mode="standardize", out="CellFeatureGraph",
                                device=device),
            SetConfig({"feature_channel": "CellFeatureGraph",
                       "feature_channel_type": "uns", "label_channel": "Group"}),
        ])
        return Compose(*transforms, log_level=log_level)

    def _fit_inputs(self, g: Graph, fmt: str, bsr_block: int):
        """Adjacency, features, dense reconstruction target, its BCE weights
        and the BSR mean degrees on the device, cached across fits on the same
        graph (counterpart: graphsc.py:167-207)."""
        key = (id(g), g.adj.shape, g.adj.nnz, fmt, bsr_block)
        if getattr(self, "_fit_cache_key", None) == key:
            return self._fit_cache
        dev = self.device
        degrees = None
        if fmt == "bsr":
            adj = g.to_bsr(block=bsr_block, device=dev)
            if self.agg == "mean":
                degrees = torch.from_numpy(np.diff(g.adj.indptr).astype(np.float32)).to(dev)
        elif fmt == "dense":
            adj = g.to_dense_adj(device=dev)
        else:
            adj = csr_from_scipy(g.adj).to(dev)
        feats = g.ndata.get("features")
        if feats is None:
            # adjacency rows against the gene nodes as features (graphsc.py:198-201)
            feats = g.adj[:, :g.info["num_genes"]].toarray()
        feats = torch.from_numpy(np.asarray(feats, np.float32)).to(dev)
        # the whole (n, n) pattern of positive weights, as the reference's
        # sampled block adjacency spans both node types (graphsc.py:204-205)
        coo = g.adj.tocoo()
        pos = coo.data > 0
        n = g.num_nodes
        target = torch.zeros((n, n), dtype=torch.float32, device=dev)
        target[torch.from_numpy(coo.row[pos]).to(dev), torch.from_numpy(coo.col[pos]).to(dev)] = 1.0
        n_pos = target.sum()
        total = float(n * n)
        pos_weight = (total - n_pos) / n_pos.clamp(min=1.0)
        norm = total / ((total - n_pos) * 2).clamp(min=1.0)
        self._fit_cache_key = key
        self._fit_cache = (adj, feats, target, pos_weight, norm, degrees)
        return self._fit_cache

    def fit(self, g: Graph, y=None, *, epochs: int = 100, lr: float = 1e-5,
            batch_size: int = 128, show_epoch_ari: bool = False, eval_epoch: bool = False,
            use_bsr="auto", bsr_block: int = 128):
        """Train from the current weights with a new Adam (counterpart:
        graphsc.py:139-249). ``use_bsr=True`` aggregates sums and means
        through the block-sparse SpMM, ``False`` on the CSR adjacency. With
        ``eval_epoch`` and labels ``y``, every epoch clusters the cell
        embeddings (k-means on the device, or Leiden on the host with
        ``cluster_method="leiden"``) and ``z`` is the embedding of the
        best ARI; otherwise the last one. ``batch_size`` is unused: training
        is full-graph, as in JAX."""
        if not isinstance(g, Graph):
            raise TypeError(f"expected a dance_tpu_torch Graph, got {type(g)}")
        if use_bsr == "auto" and self.agg not in ("sum", "mean"):
            # max-of-products has no matrix-product form: the JAX package
            # sends it to the segment path (graphsc.py:152-160)
            logger.info("agg=%r: using the CSR segment-max path", self.agg)
            use_bsr = False
        fmt = resolve_adj_format(use_bsr, g.adj, bsr_block, device=self.device, reorder=False)
        if fmt == "bsr" and self.agg not in ("sum", "mean"):
            raise ValueError("use_bsr supports agg='sum' or 'mean'")
        n_genes = int(g.info["num_genes"])
        mesh = active_dp_mesh()
        shard = None
        if fmt == "csr" and mesh is not None and mesh.size("dp") > 1:
            adj, feats, target, pos_weight, norm, degrees, shard = self._sharded_inputs(g, mesh)
        else:
            adj, feats, target, pos_weight, norm, degrees = self._fit_inputs(g, fmt, bsr_block)
        if self.model is None:
            self.model = GCNAE(feats.shape[1], agg=self.agg, hidden_dim=self.hidden_dim,
                               hidden_1=self.hidden_1, hidden_2=self.hidden_2,
                               dropout=self.dropout, n_layers=self.n_layers)
            self.model.reset_parameters(torch.Generator().manual_seed(self.seed))
            self.model.to(self.device)
        opt = torch.optim.Adam(self.model.parameters(), lr=lr)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        y_true = None if y is None else np.asarray(y).ravel()
        aris, zs = [], []
        self.history = []
        for epoch in range(epochs):
            t0 = time.perf_counter()
            self.model.train()
            opt.zero_grad(set_to_none=True)
            emb = self.model.encode(adj, feats, degrees, generator=gen, shard=shard)
            if shard is None:
                # the whole graph's Gram matrix: every node is a "cell" of the
                # reconstruction (graphsc.py:120-128, 208)
                loss = norm * binary_ce_logits(emb @ emb.T, target, pos_weight=pos_weight)
                loss.backward()
            else:
                loss = self._sharded_loss(emb, shard, target, pos_weight, norm)
                loss.backward()
                loss = sync_grads(list(self.model.parameters()), mesh, extra=loss.detach())
            opt.step()
            record = {"epoch": epoch, "loss": float(loss.detach())}
            if eval_epoch and y_true is not None:
                z_dev = self._embed(adj, feats, degrees, shard)[n_genes:]
                if self.cluster_method == "kmeans":
                    labels = kmeans(z_dev, self.n_clusters, n_init=10, seed=5).labels
                    record["ari"] = ari(y_true, labels.cpu().numpy())
                else:  # Leiden on the host, as JAX scores it (graphsc.py:241-243)
                    self.z = z_dev.cpu().numpy()
                    record["ari"] = self.score(None, y_true)
                aris.append(record["ari"])
                zs.append(z_dev)
                if show_epoch_ari:
                    logger.info("epoch %4d, ARI %.4f", epoch, record["ari"])
            record["seconds"] = time.perf_counter() - t0
            self.history.append(record)
        z = (zs[int(np.argmax(aris))] if aris
             else self._embed(adj, feats, degrees, shard)[n_genes:])
        self.z = z.cpu().numpy()
        return self

    @torch.no_grad()
    def _embed(self, adj, feats, degrees=None, shard: Optional[RowShard] = None) -> torch.Tensor:
        """All nodes' embeddings (gathered from the ranks with ``shard``)."""
        self.model.eval()
        emb = self.model.encode(adj, feats, degrees)
        return emb if shard is None else shard.gather(emb)

    def _sharded_inputs(self, g: Graph, mesh):
        """A data-parallel fit's inputs: this rank's block rows of the
        adjacency, features and reconstruction target, the BCE weights from
        the global counts, and the rows (counterpart: graphsc.py:188-196)."""
        key = (id(g), g.adj.shape, g.adj.nnz, "sharded", mesh.size("dp"), mesh.index("dp"))
        if getattr(self, "_fit_cache_key", None) == key:
            return self._fit_cache
        dev, n = self.device, g.num_nodes
        adj = shard_csr(g.adj, mesh, device=dev)
        shard = RowShard(n, mesh)
        feats = g.ndata.get("features")
        if feats is None:
            feats = g.adj[:, :g.info["num_genes"]].toarray()
        feats = shard.rows(np.asarray(feats, np.float32), device=dev)
        mine = g.adj[shard.lo:shard.lo + shard.real].tocoo()
        pos = mine.data > 0
        target = torch.zeros((shard.real, n), dtype=torch.float32, device=dev)
        rows, cols = (torch.from_numpy(a[pos]).to(dev) for a in (mine.row, mine.col))
        target[rows, cols] = 1.0
        # the single fit's float32 arithmetic on the global positive count
        n_pos = torch.tensor(float((g.adj.data > 0).sum()), dtype=torch.float32, device=dev)
        total = float(n * n)
        pos_weight = (total - n_pos) / n_pos.clamp(min=1.0)
        norm = total / ((total - n_pos) * 2).clamp(min=1.0)
        self._fit_cache_key = key
        self._fit_cache = (adj, feats, target, pos_weight, norm, None, shard)
        return self._fit_cache

    @staticmethod
    def _sharded_loss(emb: torch.Tensor, shard: RowShard, target, pos_weight, norm):
        """This rank's share of the BCE: its rows of ``emb @ embᵀ`` against all
        nodes' (gathered, gradients summed back), over the global n²."""
        emb_all = shard.gather_grad(emb)
        if shard.real == 0:
            return emb_all.sum() * 0.0  # no rows here; the backward still joins the gathers
        logits = emb[:shard.real] @ emb_all.T
        return norm * binary_ce_logits(logits, target, pos_weight=pos_weight) \
            * (shard.real / shard.n)

    def predict(self, x=None) -> np.ndarray:
        """k-means of the cell embeddings, best of 10 restarts, or Leiden
        (seeded with ``seed``) on their 15-NN connectivity graph (counterpart:
        graphsc.py:251)."""
        if self.cluster_method == "leiden":
            adj = knn_graph(self.z, 15, mode="connectivity", include_self=False)
            return leiden(adj, seed=self.seed)
        return kmeans(self.z, self.n_clusters, n_init=10, seed=5,
                      device=self.device).labels.cpu().numpy()

    def get_latent(self) -> np.ndarray:
        return self.z


def run_leiden(embeddings, n_neighbors: int = 15, resolution: float = 1.0,
               seed: int = 0) -> np.ndarray:
    """Leiden labels of an embedding's kNN connectivity graph (counterpart:
    graphsc.py:266, the reference's ``run_leiden``)."""
    emb = np.asarray(embeddings, np.float32)
    adj = knn_graph(emb, min(n_neighbors, len(emb) - 1))
    return np.asarray(leiden(adj, resolution=resolution, seed=seed))


def graphsc_preprocess(counts, *, n_top_genes: int = 3000,
                       normalize_weights: str = "log_per_cell", n_components: int = 50,
                       normalize_edges: bool = False, device="auto"):
    """:meth:`GraphSC.preprocessing_pipeline` on raw ``counts`` (cells x
    genes, numpy or scipy, taken as float32) wrapped in a ``Data``, for a
    caller that holds a matrix: genes with fewer than 3 counts and cells
    without counts are dropped; ``normalize_total`` and ``log1p``; the
    ``n_top_genes`` cell_ranger HVGs kept; then ``log1p`` and
    ``normalize_total(target_sum=1)`` (``"log_per_cell"``; ``"per_cell"``
    only the latter; ``"none"`` neither); gene PCA of the standardized
    matrix and expression-weighted cell features (on ``device``); the
    cell-gene graph of the result. Returns ``(graph, cells)``, ``cells`` the
    indices of the kept cells (read from their names), so that labels can
    follow them."""
    x = sp.csr_matrix(counts, dtype=np.float32) if sp.issparse(counts) \
        else np.asarray(counts, np.float32)
    data = Data(AnnData(x))
    GraphSC.preprocessing_pipeline(n_top_genes=n_top_genes, normalize_weights=normalize_weights,
                                   n_components=n_components, normalize_edges=normalize_edges,
                                   log_level="WARNING", device=device)(data)
    return data.data.uns["CellFeatureGraph"], np.asarray(data.data.obs_names).astype(np.int64)


__all__ = ["GCNAE", "GraphSC", "InnerProductDecoder", "graphsc_preprocess", "run_leiden"]
