"""scHeteroNet: heterophily-aware GNN annotation with OOD detection.

Counterpart: dance_tpu/modules/single_modality/cell_type_annotation/
scheteronet.py (``_gcn_norm``/``build_hop_adjacencies`` :40-61,
``contrastive_loss`` :64, ``_ZINBDecoder`` :73, ``_FullBatchNorm`` :89,
``_HeteroNet`` :101-150, ``scHeteroNet`` :153-397, the reference-named
helpers :402-558). Each HetConv layer maps ``h`` to ``[A₁h ; A₂h]`` over the
GCN-normalised one-hop and STRICT two-hop cell kNN adjacencies, a full-batch
norm sits between layers, and every stage's output is concatenated (jumping
knowledge) into the classifier head and a ZINB decoder. Training is the
cross-entropy on the train mask plus ``zinb_weight`` x the masked ZINB NLL
of the raw counts (plus an optional masked-view contrastive term), full
graph, Adam. OOD scores are the negative energy of the logits, propagated
over the one-hop (or squared) row-normalised graph.

Every HetConv aggregation goes through
:func:`~dance_tpu_torch.ops.segment.spmm`. The format is JAX's rule
(:259-301): :func:`~dance_tpu_torch.ops.bsr.resolve_use_bsr` on the raw
one-hop graph; under BSR one RCM order for the cells, both hops built from
the permuted graph and tiled (the CUDA kernel #1 on the card, forward and
``Aᵀḡ``); under ``use_bsr="auto"`` each hop goes dense on its own where
:func:`~dance_tpu_torch.ops.bsr.choose_adj_format` (no reorder) says so.
Off the card ``"auto"`` is CSR, as JAX's is off the TPU. The energy
propagation runs on the (permuted) raw graph in CSR, as in JAX, and every
output is put back in the caller's order.

Where this differs from the JAX package:

- The weights are drawn at each ``fit`` from a CPU ``torch.Generator``
  seeded with ``seed``, the dropout masks and the contrastive view from a
  generator on the device; parity tests copy the flax weights in
  (:func:`dance_tpu_torch.utils.params.scheteronet_flax_to_torch`) by
  patching :meth:`scHeteroNet._make_net`. The epochs are a loop; JAX runs
  them as one compiled scan.
- The build cache's key also holds the device and whether ``"auto"`` asked
  for the per-hop dense upgrade (JAX's key holds the resolved BSR flag only,
  so a ``"auto"`` fit after a ``True`` fit reused hops built without it).
- ``history`` records each epoch's loss and seconds; ``fmts`` the two hops'
  formats and ``build_seconds`` the graph build's steps.
- :func:`scheteronet_preprocess` is the array front of
  ``preprocessing_pipeline`` (it runs the pipeline on a matrix wrapped in a
  ``Data``) and :func:`set_split` the array form of ``set_split``.
  ``get_genename`` and ``print_statistics`` take the columns and labels
  they read from an AnnData in JAX.
"""

import hashlib
import time
from collections import Counter
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F
from torch import nn

from dance_tpu_torch.data import AnnData, Data, Frame
from dance_tpu_torch.graph import Graph
from dance_tpu_torch.modules.base import BaseClassificationMethod
from dance_tpu_torch.nn.gnn import flax_dense_init_, flax_dropout
from dance_tpu_torch.nn.mlp import FullBatchNorm as _FullBatchNorm
from dance_tpu_torch.nn.mlp import VanillaMLP as MLP  # the reference name (scheteronet.py:558)
from dance_tpu_torch.nn.zinb_ae import disp_act, mean_act
from dance_tpu_torch.ops.bsr import (bsr_from_scipy, choose_adj_format, rcm_reorder,
                                     resolve_use_bsr, unpermute)
from dance_tpu_torch.ops.segment import spmm
from dance_tpu_torch.ops.sparse import csr_from_scipy, dense_adj_from_scipy
from dance_tpu_torch.settings import logger
from dance_tpu_torch.transforms.filter import (FilterCellsScanpy, FilterCellsType,
                                               HighlyVariableGenesLogarithmizedByTopGenes)
from dance_tpu_torch.transforms.graph.heteronet_graph import HeteronetGraph
from dance_tpu_torch.transforms.interface import AnnDataTransform
from dance_tpu_torch.transforms.misc import Compose, SaveRaw, SetConfig
from dance_tpu_torch.transforms.normalize import Log1P, NormalizeTotal, UpdateSizeFactors
from dance_tpu_torch.utils import EpochClock, ood_measures, resolve_device
from dance_tpu_torch.utils.loss import zinb_nll


# --------------------------------------------------------------------------
# the hop adjacencies (counterpart: scheteronet.py:40-61)
# --------------------------------------------------------------------------

def _gcn_norm(adj: sp.spmatrix) -> sp.csr_matrix:
    """``D^-1/2 A D^-1/2`` without self-loops, a row without edges left at
    zero (counterpart: scheteronet.py:40)."""
    adj = sp.csr_matrix(adj)
    deg = np.asarray(adj.sum(1)).ravel()
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    dinv[deg == 0] = 0.0
    return sp.diags(dinv) @ adj @ sp.diags(dinv)


def build_hop_adjacencies(adj: sp.spmatrix):
    """The normalised one-hop and STRICT two-hop adjacencies, without
    self-loops (counterpart: scheteronet.py:49): the pattern ``A`` of
    ``adj`` and the pattern of ``A² - A`` off the diagonal, each through
    :func:`_gcn_norm`."""
    a = sp.csr_matrix(adj)
    a.data[:] = 1.0
    a.setdiag(0)
    a.eliminate_zeros()
    a2 = a @ a
    a2.setdiag(0)
    a2 = a2 - a
    a2.data = np.where(a2.data > 0, 1.0, 0.0).astype(np.float32)
    a2.eliminate_zeros()
    return _gcn_norm(a), _gcn_norm(a2)


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------

def contrastive_loss(z1: torch.Tensor, z2: torch.Tensor,
                     temperature: float = 0.5) -> torch.Tensor:
    """InfoNCE between matched rows of ``z1`` and ``z2`` (counterpart:
    scheteronet.py:64): the (n, n) cosine logits over ``temperature``, the
    cross-entropy of each row against its own column."""
    z1 = z1 / torch.linalg.norm(z1, dim=-1, keepdim=True).clamp(min=1e-12)
    z2 = z2 / torch.linalg.norm(z2, dim=-1, keepdim=True).clamp(min=1e-12)
    logits = z1 @ z2.T / temperature
    return F.cross_entropy(logits, torch.arange(z1.shape[0], device=z1.device))


class _ZINBDecoder(nn.Module):
    """Dense(32) ReLU Dense(128) ReLU, then the mean, dispersion and dropout
    heads (counterpart: scheteronet.py:73; the middle width of ``dec_dims``
    is unused, as in the reference). ``hidden.{0,1}``, ``mean``, ``disp``
    and ``pi`` are flax's ``Dense_0`` .. ``Dense_4``."""

    def __init__(self, in_dim: int, n_genes: int, dec_dims: Sequence[int] = (32, 64, 128)):
        super().__init__()
        self.hidden = nn.ModuleList([nn.Linear(in_dim, dec_dims[0]),
                                     nn.Linear(dec_dims[0], dec_dims[2])])
        self.mean = nn.Linear(dec_dims[2], n_genes)
        self.disp = nn.Linear(dec_dims[2], n_genes)
        self.pi = nn.Linear(dec_dims[2], n_genes)

    def forward(self, z: torch.Tensor):
        h = z
        for layer in self.hidden:
            h = torch.relu(layer(h))
        return mean_act(self.mean(h)), disp_act(self.disp(h)), torch.sigmoid(self.pi(h))


class HetConv(nn.Module):
    """One aggregation step, ``[A₁x ; A₂x]`` (counterpart: scheteronet.py:462)."""

    def forward(self, x: torch.Tensor, adj_t, adj_t2) -> torch.Tensor:
        return torch.cat([spmm(adj_t, x), spmm(adj_t2, x)], dim=1)


class _HeteroNet(nn.Module):
    """The HetConv stack with jumping-knowledge concatenation, the head and
    the ZINB decoder (counterpart: scheteronet.py:101). Each layer doubles
    the width; the concatenation is ``hidden (2^(L+1) - 1)`` wide. flax
    infers the input width; torch takes it as ``in_dim``."""

    def __init__(self, in_dim: int, n_classes: int, hidden: int = 64, num_layers: int = 2,
                 dropout: float = 0.2, use_bn: bool = True, n_genes: int = 0):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        self.use_bn = use_bn
        self.feature_embed = nn.Linear(in_dim, hidden)
        self.conv = HetConv()
        self.bns = nn.ModuleList(_FullBatchNorm(hidden * 2 ** (i + 1))
                                 for i in range(max(num_layers - 1, 0)))
        last_dim = hidden * (2 ** (num_layers + 1) - 1)
        self.final_project = nn.Linear(last_dim, n_classes)
        self.decoder = _ZINBDecoder(last_dim, n_genes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax ``Dense``'s default init for every layer; norms at scale 1, bias 0."""
        for layer in self.modules():
            if isinstance(layer, nn.Linear):
                flax_dense_init_(layer, generator)
            elif isinstance(layer, _FullBatchNorm):
                nn.init.ones_(layer.scale)
                nn.init.zeros_(layer.bias)

    def embed(self, adj1, adj2, x: torch.Tensor,
              dropout_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """The jumping-knowledge concatenation; dropout only with a generator."""
        def drop(h):
            return flax_dropout(h, self.dropout, dropout_gen)

        h = torch.relu(self.feature_embed(x))
        collected = [h]
        h = drop(h)
        for i in range(self.num_layers):
            h = self.conv(h, adj1, adj2)
            if i != self.num_layers - 1:
                if self.use_bn:
                    h = self.bns[i](h)
                collected.append(h)
                h = drop(h)
            else:
                h = drop(h)
                collected.append(h)
        return torch.cat(collected, dim=1)

    def zinb(self, h: torch.Tensor):
        return self.decoder(h)

    def forward(self, adj1, adj2, x: torch.Tensor,
                dropout_gen: Optional[torch.Generator] = None):
        """``(logits, h)``, ``h`` the concatenation the decoder reads."""
        h = self.embed(adj1, adj2, x, dropout_gen)
        return self.final_project(h), h


class scHeteroNet(BaseClassificationMethod):
    """scHeteroNet (counterpart: scheteronet.py:153). ``fit(graph, y, ...)``
    trains on a :class:`~dance_tpu_torch.graph.Graph` carrying the features
    ``ndata["feat"]`` (the output of :func:`scheteronet_preprocess`);
    ``predict`` is the argmax of ``predict_proba``, ``detect`` the OOD
    score of every cell (higher is in-distribution)."""

    _DISPLAY_ATTRS = ("hidden_channels", "num_layers")

    def __init__(self, d: int = 0, c: int = 0, edge_index=None, num_nodes: int = 0,
                 hidden_channels: int = 64, num_layers: int = 2, dropout: float = 0.2,
                 use_bn: bool = True, device="auto", min_loss: float = np.inf, seed: int = 0):
        # d, c, edge_index, num_nodes and min_loss keep the reference's signature
        self.hidden_channels = hidden_channels
        self.num_layers = num_layers
        self.dropout = dropout
        self.use_bn = use_bn
        self.seed = seed
        self.device = resolve_device(device)
        self.net: Optional[_HeteroNet] = None
        self.history: List[Dict[str, float]] = []  # per epoch: epoch, loss, seconds

    @staticmethod
    def preprocessing_pipeline(log_level: str = "INFO", n_top_genes: int = 4000) -> Compose:
        """scHeteroNet's preprocessing of a ``Data`` whose ``obsm["cell_type"]``
        is the cells' one-hot ``Frame`` (:func:`scheteronet_preprocess` runs
        it on a matrix): the cells of types with at most 10 cells dropped,
        genes under 3 counts and cells without counts dropped, the
        ``n_top_genes`` cell_ranger HVGs of the counts kept (JAX's 4,000),
        ``SaveRaw``, ``normalize_total`` (genes above 5 % of a cell left out
        of the totals), the size factors into ``obs``, ``log1p`` and the
        5-NN graph into ``uns["HeteronetGraph"]`` (counterpart:
        scheteronet.py:170-184). Everything runs on the host."""
        return Compose(
            FilterCellsType(),
            AnnDataTransform("sc.pp.filter_genes", min_counts=3),
            FilterCellsScanpy(min_counts=1),
            HighlyVariableGenesLogarithmizedByTopGenes(n_top_genes=n_top_genes,
                                                       flavor="cell_ranger"),
            SaveRaw(),
            NormalizeTotal(),
            UpdateSizeFactors(),
            Log1P(),
            HeteronetGraph(),
            SetConfig({"label_channel": "cell_type"}),
            log_level=log_level,
        )

    def _make_net(self, in_dim: int, n_classes: int, n_genes: int) -> _HeteroNet:
        """A new network with flax's init drawn from ``seed``, on the device."""
        net = _HeteroNet(in_dim, n_classes, hidden=self.hidden_channels,
                         num_layers=self.num_layers, dropout=self.dropout, use_bn=self.use_bn,
                         n_genes=n_genes)
        net.reset_parameters(torch.Generator().manual_seed(self.seed))
        return net.to(self.device)

    def _build(self, raw_adj: sp.csr_matrix, arrays: Sequence[np.ndarray], use_bsr,
               bsr_block: int):
        """The two hop adjacencies on the device in their formats, the
        propagation graph, the permutation (None unless BSR) and ``arrays``
        in the training order, as tensors (counterpart: scheteronet.py:259-301)."""
        dev, seconds = self.device, {}
        t0 = time.perf_counter()
        auto = use_bsr == "auto"
        bsr = resolve_use_bsr(use_bsr, raw_adj, bsr_block, device=dev)
        perm = None
        if bsr:
            perm, raw_adj = rcm_reorder(raw_adj)
            perm = np.asarray(perm)
            arrays = [a[perm] for a in arrays]
        seconds["format"], t0 = time.perf_counter() - t0, time.perf_counter()
        hops = build_hop_adjacencies(raw_adj)
        seconds["hops"], t0 = time.perf_counter() - t0, time.perf_counter()
        fmts = ["bsr" if bsr else "csr"] * 2
        if auto:  # per hop: the dense upgrade, no reorder (the order is set)
            fmts = ["dense" if choose_adj_format(a, reorder=False, device=dev) == "dense"
                    else f for f, a in zip(fmts, hops)]
        make = {"bsr": lambda a: bsr_from_scipy(a, block=bsr_block), "csr": csr_from_scipy,
                "dense": dense_adj_from_scipy}
        adjs = [make[f](a).to(dev) for f, a in zip(fmts, hops)]
        prop_adj = csr_from_scipy(raw_adj).to(dev)
        tensors = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
        seconds["upload"] = time.perf_counter() - t0
        return adjs, prop_adj, perm, tensors, tuple(fmts), seconds

    def fit(self, graph: Graph, y, x_raw=None, size_factors=None, use_zinb: bool = True,
            zinb_weight: float = 0.1, cl_weight: float = 0.0, mask_ratio: float = 0.2,
            epochs: int = 200, lr: float = 1e-2, train_idx=None, use_bsr="auto",
            bsr_block: int = 128):
        """Train from new weights with Adam for ``epochs`` full-graph steps
        (counterpart: scheteronet.py:232). Without ``x_raw`` the ZINB term
        is off; size factors default to the raw totals over their median.
        The hop build is cached on the graph's identity and the inputs'
        content, as in JAX."""
        x = np.asarray(graph.ndata["feat"], np.float32)
        y = np.asarray(y)
        if y.ndim == 2:
            y = y.argmax(1)
        y = y.astype(np.int64)
        n = x.shape[0]
        self.num_labels = int(y.max()) + 1
        if x_raw is None:
            x_raw, use_zinb = np.zeros_like(x), False
        else:
            x_raw = np.asarray(x_raw.toarray() if sp.issparse(x_raw) else x_raw, np.float32)
        if size_factors is None:
            counts = np.maximum(x_raw.sum(1), 1.0)
            size_factors = counts / np.median(counts)
        size_factors = np.asarray(size_factors, np.float32)
        mask = np.zeros(n, np.float32)
        mask[np.asarray(train_idx if train_idx is not None else np.arange(n))] = 1

        raw_adj = sp.csr_matrix(graph.adj)
        h = hashlib.md5(np.ascontiguousarray(x))
        for a in (x_raw, mask, y):
            h.update(np.ascontiguousarray(a))
        cache_key = (id(graph), raw_adj.shape, raw_adj.nnz, str(use_bsr), bsr_block,
                     str(self.device), h.hexdigest())
        if getattr(self, "_build_cache_key", None) != cache_key:
            self._build_cache = self._build(raw_adj, [x, x_raw, size_factors, y, mask],
                                            use_bsr, bsr_block)
            self._build_cache_key = cache_key
        (self.adj1, self.adj2), self._prop_adj, self._perm, tensors, self.fmts, \
            self.build_seconds = self._build_cache
        self.x, *self._targets = tensors
        logger.info("scHeteroNet hop formats: %s", self.fmts)

        net = self.net = self._make_net(x.shape[1], self.num_labels, x.shape[1])
        net.train()
        opt = torch.optim.Adam(net.parameters(), lr=lr)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        clock, losses = EpochClock(self.device), []
        for epoch in range(epochs):
            clock.tick()
            opt.zero_grad(set_to_none=True)
            loss = self._loss(gen, use_zinb, zinb_weight, cl_weight, mask_ratio)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
            if epoch % 50 == 0:
                logger.info("scHeteroNet epoch %d, loss %.5f", epoch, float(losses[-1]))
        clock.tick()
        values = torch.stack(losses).cpu().tolist() if losses else []
        self.history = [{"epoch": e, "loss": l, "seconds": s}
                        for e, (l, s) in enumerate(zip(values, clock.seconds()))]
        net.eval()
        return self

    def _loss(self, gen: Optional[torch.Generator], use_zinb: bool = True,
              zinb_weight: float = 0.1, cl_weight: float = 0.0,
              mask_ratio: float = 0.2) -> torch.Tensor:
        """The training loss of the current weights on the fitted inputs
        (counterpart: ``_step``'s ``loss_fn``, scheteronet.py:190-214): the
        masked cross-entropy, ``zinb_weight`` x the masked ZINB NLL and
        ``cl_weight`` x the contrastive term; dropout and the view from
        ``gen``."""
        net, (xr, sf, yt, mt) = self.net, self._targets
        n_train = mt.sum().clamp(min=1.0)
        logits, hid = net(self.adj1, self.adj2, self.x, gen)
        ce = F.cross_entropy(logits, yt.clamp(min=0), reduction="none")
        loss = (ce * mt).sum() / n_train
        if use_zinb:
            mean, disp, pi = net.zinb(hid)
            nll = zinb_nll(xr, mean, disp, pi, scale_factor=sf[:, None], reduce=False).sum(1)
            loss = loss + zinb_weight * (nll * mt).sum() / n_train
        if cl_weight != 0.0:
            # the masked-view contrastive regulariser (scheteronet.py:202-210)
            view = (torch.rand(self.x.shape, generator=gen, device=self.device)
                    > mask_ratio).to(self.x.dtype)
            z1, _ = net(self.adj1, self.adj2, self.x * view, gen)
            loss = loss + cl_weight * contrastive_loss(logits, z1)
        return loss

    def _logits(self) -> torch.Tensor:
        with torch.no_grad():
            return self.net(self.adj1, self.adj2, self.x)[0]

    # --- OOD machinery ------------------------------------------------------

    def propagation(self, e, adj, prop_layers: int = 1, alpha: float = 0.5) -> np.ndarray:
        """Energy belief propagation over the one-hop graph, each step
        ``alpha e + (1 - alpha) mean of the neighbours' e`` (counterpart:
        scheteronet.py:346)."""
        e = torch.as_tensor(np.asarray(e, np.float32)).to(adj.indptr.device)[:, None]
        for _ in range(prop_layers):
            e = e * alpha + spmm(adj, e, weighted=False, op="mean") * (1 - alpha)
        return e[:, 0].cpu().numpy()

    def two_hop_propagation(self, e, adj, prop_layers: int = 1,
                            alpha: float = 0.5) -> np.ndarray:
        """The same through the squared mean operator (counterpart:
        scheteronet.py:355)."""
        e = torch.as_tensor(np.asarray(e, np.float32)).to(adj.indptr.device)[:, None]
        for _ in range(prop_layers):
            hop = spmm(adj, spmm(adj, e, weighted=False, op="mean"), weighted=False, op="mean")
            e = e * alpha + hop * (1 - alpha)
        return e[:, 0].cpu().numpy()

    def detect(self, graph=None, node_idx=None, T: float = 1.0, use_prop: bool = True,
               use_2hop: bool = False, oodprop: int = 2, oodalpha: float = 0.5,
               **kwargs) -> np.ndarray:
        """The negative energy ``T logsumexp(logits / T)`` of every cell,
        propagated ``oodprop`` times when ``use_prop``, in the caller's
        order (counterpart: scheteronet.py:366)."""
        neg_energy = (T * torch.logsumexp(self._logits() / T, dim=-1)).cpu().numpy()
        if use_prop:
            prop = self.two_hop_propagation if use_2hop else self.propagation
            neg_energy = prop(neg_energy, self._prop_adj, oodprop, oodalpha)
        neg_energy = unpermute(self._perm, neg_energy)
        return neg_energy[node_idx] if node_idx is not None else neg_energy

    def evaluate_ood(self, ind_idx, ood_idx, **detect_kwargs):
        """``(auroc, aupr, fpr@95)`` of :meth:`detect`'s scores, the
        ``ind_idx`` cells positive (counterpart: scheteronet.py:380)."""
        scores = self.detect(**detect_kwargs)
        return ood_measures(scores[np.asarray(ind_idx)], scores[np.asarray(ood_idx)])

    def predict_proba(self, graph=None) -> np.ndarray:
        """Class probabilities of every cell, in the caller's order
        (counterpart: scheteronet.py:386)."""
        return unpermute(self._perm, torch.softmax(self._logits(), dim=-1).cpu().numpy())

    def predict(self, graph=None, idx=None) -> np.ndarray:
        pred = self.predict_proba(graph).argmax(1)
        return pred[idx] if idx is not None else pred


# --------------------------------------------------------------------------
# preprocessing on arrays (counterpart: scheteronet.py:170-184, 510-535)
# --------------------------------------------------------------------------

class HeteroNetInputs(NamedTuple):
    """What :func:`scheteronet_preprocess` returns: ``graph`` the cell kNN
    graph carrying the log features, ``x`` those features, ``x_raw`` the
    counts of the kept genes (``SaveRaw``), ``size_factors``, ``labels``
    (codes into ``cell_types``, every input type kept as a code), ``cells``
    the indices of the kept cells and ``genes`` of the kept genes."""

    graph: Graph
    x: np.ndarray
    x_raw: np.ndarray
    size_factors: np.ndarray
    labels: np.ndarray
    cell_types: np.ndarray
    cells: np.ndarray
    genes: np.ndarray


def scheteronet_preprocess(counts, labels, *, n_top_genes: int = 4000) -> HeteroNetInputs:
    """:meth:`scHeteroNet.preprocessing_pipeline` on raw ``counts`` (cells x
    genes, numpy or scipy, taken as float32) and per-cell ``labels``
    wrapped in a ``Data`` (the labels one-hot in ``obsm["cell_type"]``, a
    column per type of ``np.unique(labels)``), for a caller that holds a
    matrix. With more HVGs asked for than genes left, JAX's cut keeps every
    gene whose normalised dispersion ranks at or above the last finite one.
    The label codes index ``np.unique(labels)``, removed types included."""
    x = sp.csr_matrix(counts, dtype=np.float32) if sp.issparse(counts) \
        else np.asarray(counts, np.float32)
    cell_types, codes = np.unique(np.asarray(labels), return_inverse=True)
    adata = AnnData(x)
    adata.obsm["cell_type"] = Frame(np.eye(len(cell_types), dtype=np.float32)[codes],
                                    index=adata.obs_names, columns=list(cell_types))
    data = Data(adata)
    scHeteroNet.preprocessing_pipeline(log_level="WARNING", n_top_genes=n_top_genes)(data)
    return heteronet_inputs(data, cell_types)


def heteronet_inputs(data, cell_types) -> HeteroNetInputs:
    """What :func:`scheteronet_preprocess` returns, of a ``Data`` the pipeline
    ran on whose cells and genes are named by their rows and columns in the
    input."""
    adata = data.data
    g = adata.uns["HeteronetGraph"]
    raw = adata.raw.X
    return HeteroNetInputs(g, g.ndata["feat"],
                           np.asarray(raw.toarray() if sp.issparse(raw) else raw, np.float32),
                           np.asarray(adata.obs["size_factors"]),
                           adata.obsm["cell_type"].to_numpy().argmax(1), cell_types,
                           np.asarray(adata.obs_names).astype(np.int64),
                           np.asarray(adata.var_names).astype(np.int64))


def get_genename(var_names, gene_id=None, symbol=None):
    """The gene names: the ``gene_id`` column when given, else ``symbol``,
    else the index (counterpart: scheteronet.py:499, which reads them from
    ``var``)."""
    if gene_id is not None:
        return np.asarray(gene_id)
    if symbol is not None:
        return np.asarray(symbol)
    return np.asarray(var_names)


def print_statistics(n_cells: int, n_genes: int, labels=None, name: str = "dataset"):
    """Log the matrix size and, given the cells' labels, each class's count
    (counterpart: scheteronet.py:551, which reads them from an AnnData)."""
    logger.info("%s: %d cells x %d genes", name, n_cells, n_genes)
    if labels is not None:
        counts = Counter(np.asarray(labels).tolist())
        logger.info("%s class counts: %s", name, dict(sorted(counts.items())))


def set_split(labels, train_idx=(), val_idx=(), test_idx=()) -> Dict[str, List[int]]:
    """The splits of ``set_split`` (scheteronet.py:510) on a label vector
    (codes or one-hot rows): the rarest type (the first seen among equals)
    is the OOD class and leaves the labelled splits. Returns the lists
    ``train_idx``, ``val_idx``, ``test_idx``, ``ood_idx`` and ``id_idx``."""
    y = np.asarray(labels)
    if y.ndim == 2:
        y = y.argmax(1)
    ood_class = min(Counter(y.tolist()).items(), key=lambda kv: kv[1])[0]
    ood = y == ood_class
    return {"train_idx": [int(i) for i in train_idx if not ood[i]],
            "val_idx": [int(i) for i in val_idx if not ood[i]],
            "test_idx": [int(i) for i in test_idx if not ood[i]],
            "ood_idx": np.nonzero(ood)[0].tolist(), "id_idx": np.nonzero(~ood)[0].tolist()}


def set_graph_split(split: Dict[str, Sequence[int]], ref_adata_name, g: Graph) -> Graph:
    """Boolean ``{train,val,test,id,ood}_mask`` node data on ``g`` from the
    index lists of :func:`set_split` (counterpart: scheteronet.py:537;
    ``ref_adata_name`` kept for the reference's signature)."""
    for name in ("train", "val", "test", "id", "ood"):
        mask = np.zeros(g.adj.shape[0], bool)
        mask[np.asarray(split[f"{name}_idx"], int)] = True
        g.ndata[f"{name}_mask"] = mask
    return g


# --------------------------------------------------------------------------
# reference-named evaluation helpers and containers (scheteronet.py:402-497)
# --------------------------------------------------------------------------

def eval_acc(true_labels, model_output, acc=None) -> float:
    """Accuracy of the argmax of ``model_output`` against integer labels
    (counterpart: scheteronet.py:402)."""
    pred = np.asarray(model_output).argmax(1)
    y = np.asarray(true_labels)
    if y.ndim == 2 and y.shape[1] == 1:
        y = y[:, 0]
    elif y.ndim == 2:
        y = y.argmax(1)
    return float((pred == y).mean())


def stable_cumsum(arr, rtol: float = 1e-05, atol: float = 1e-08) -> np.ndarray:
    """float64 cumsum whose last value must match the sum (counterpart:
    scheteronet.py:413)."""
    out = np.cumsum(arr, dtype=np.float64)
    expected = np.sum(arr, dtype=np.float64)
    if not np.allclose(out[-1], expected, rtol=rtol, atol=atol):
        raise RuntimeError("cumsum was found to be unstable: its last element does not "
                           "correspond to sum")
    return out


def fpr_and_fdr_at_recall(y_true, y_score, recall_level: float = 0.95,
                          pos_label=None) -> float:
    """The false-positive rate at the score threshold whose recall on the
    positives is nearest ``recall_level`` (counterpart: scheteronet.py:423)."""
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score)
    classes = np.unique(y_true)
    if (pos_label is None
            and not any(np.array_equal(classes, c) for c in ([0, 1], [-1, 1], [0], [-1], [1]))):
        raise ValueError("Data is not binary and pos_label is not specified")
    if pos_label is None:
        pos_label = 1.0
    y_true = y_true == pos_label
    desc = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, y_true = y_score[desc], y_true[desc]
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]
    tps = stable_cumsum(y_true)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    recall = tps / tps[-1]
    last_ind = tps.searchsorted(tps[-1])
    sl = slice(last_ind, None, -1)
    recall, fps = np.r_[recall[sl], 1], np.r_[fps[sl], 0]
    cutoff = np.argmin(np.abs(recall - recall_level))
    return float(fps[cutoff] / (np.sum(~y_true) or 1))


def get_measures(in_scores, out_scores, recall_level: float = 0.95):
    """``(auroc, aupr, fpr@95)`` (counterpart: scheteronet.py:450, which
    hands over to ``ood_measures``)."""
    return ood_measures(in_scores, out_scores)


# the network and the decoder under the reference class names
HeteroNet = _HeteroNet
ZINBDecoder = _ZINBDecoder


class NCDataset:
    """A graph and labels with named splits (counterpart: scheteronet.py:475,
    after ogb's NodePropPredDataset)."""

    def __init__(self, name):
        self.name = name
        self.graph = {}
        self.label = None
        self.split_idx = {}

    def get_idx_split(self):
        return self.split_idx

    def __getitem__(self, idx):
        if idx != 0:
            raise IndexError("This dataset has only one graph")
        return self.graph, self.label

    def __len__(self):
        return 1

    def __repr__(self):
        return f"{self.__class__.__name__}({len(self)})"


__all__ = ["HeteroNet", "HeteroNetInputs", "HetConv", "MLP", "NCDataset", "ZINBDecoder",
           "build_hop_adjacencies", "contrastive_loss", "eval_acc", "fpr_and_fdr_at_recall",
           "get_genename", "get_measures", "heteronet_inputs", "print_statistics",
           "scHeteroNet", "scheteronet_preprocess", "set_graph_split", "set_split",
           "stable_cumsum"]
