"""scMoGNN for modality prediction: a heterogeneous GNN over the cell-feature
bipartite graph of one modality's expression, trained to regress the other
modality.

Counterpart: dance_tpu/modules/multi_modality/predict_modality/scmogcn.py
(``HeteroExpnGraph`` :54, ``_rel_sum``/``_rel_mean`` :84-96,
``build_hetero_graph`` :99, ``_Norm`` :163, ``_SAGERelation`` :186,
``_drop_adj`` :208, ``ScMoGCN`` :227, ``default_args`` :435,
``ScMoGCNWrapper`` :452, ``_fit_sampling`` :586).

The graph keeps one adjacency per relation: ``f2c`` (cells x features,
feature -> cell messages), ``c2f`` (its transpose) and an optional pathway
relation between features. Edge weights are the raw expression values. Each
layer runs a SAGE convolution per relation, one weighted sum of messages
through :func:`~dance_tpu_torch.ops.segment.spmm`: on the card a dense
adjacency is one cuBLAS product, a CSR one a gather and a fixed-order sum, a BSR
one the block-sparse SpMM kernel (#1, ``csrc/bsr_spmm.cu``) forward and
``Aᵀḡ`` backward, on the rectangular ``f2c``/``c2f`` tilings. Edge dropout
acts on the adjacency's weights at every step (a zero slot stays zero, and
the degrees stay those of the whole graph); on BSR the dropped tiles share
every index, schedule and the transposed pattern with the graph's tiling
(:func:`~dance_tpu_torch.ops.bsr.bsr_like`), so a step builds nothing on the
host.

Where this differs from the JAX package:

- Dropout masks come from a ``torch.Generator`` on the model's device,
  seeded with ``seed`` and drawn in order (JAX folds the epoch into a key);
  the weights from a CPU ``torch.Generator`` (flax's initializers: lecun
  normal ``Dense``, unit-variance normal ``Embed``). Parity tests copy the
  flax weights in (:func:`dance_tpu_torch.utils.params.scmogcn_flax_to_torch`)
  and turn dropout off.
- Torch layers are sized explicitly where flax infers them: with
  ``res_cat`` every layer after the first takes 2 x hidden inputs, the
  readout ``hidden x conv_layers``; ``cell_init="svd"`` needs the width of
  the cell features.
- ``history`` records each epoch's loss, validation RMSE and seconds.
- The best-validation weights are a copy of the ``state_dict`` (JAX keeps
  its immutable parameter tree).
- The Data-container ``preprocessing_pipeline`` (a ``SetConfig``) is not
  ported; ``fit`` takes arrays.
"""

import hashlib
import math
from types import SimpleNamespace
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F
from torch import nn

from dance_tpu_torch.modules.multi_modality.configs import predict_modality_config
from dance_tpu_torch.modules.base import BaseRegressionMethod, resolve_score_func
from dance_tpu_torch.nn.gnn import flax_dense_init_, flax_dropout
from dance_tpu_torch.ops.bsr import BSRMatrix, bipartite_bsr, bsr_like, resolve_adj_format
from dance_tpu_torch.ops.segment import spmm
from dance_tpu_torch.ops.sparse import CSRMatrix, DenseAdj, csr_from_scipy
from dance_tpu_torch.settings import logger
from dance_tpu_torch.utils import EpochClock, resolve_device
from dance_tpu_torch.utils.optim import best_state


def _to(x, device):
    return None if x is None else x.to(device)


class HeteroExpnGraph(NamedTuple):
    """The cell-feature hetero graph (counterpart: scmogcn.py:54): one
    adjacency per relation (a :class:`CSRMatrix`, :class:`DenseAdj`,
    :class:`BSRMatrix`, or a dense tensor in the sampled fit), the degrees
    the mean aggregator divides by (stored entries per row of each
    relation), the node ids and the optional cell and batch features.
    ``fmt`` is the format of ``f2c`` and ``c2f``."""

    f2c: Any
    c2f: Any
    pw: Any                          # None without pathway edges
    deg_c: torch.Tensor              # (n_cells,)
    deg_f: torch.Tensor              # (n_feats,)
    deg_pw: Optional[torch.Tensor]   # (n_feats,) or None
    feature_ids: torch.Tensor        # (n_feats,) int64
    cell_ids: Optional[torch.Tensor]     # (n_cells,) int64 (cell_init="none") or None
    cell_feats: Optional[torch.Tensor]   # (n_cells, d) (cell_init="svd") or None
    batch_feats: Optional[torch.Tensor]  # (n_cells, batch_num) or None
    fmt: str = "csr"

    @property
    def n_cells(self) -> int:
        return self.deg_c.shape[0]

    @property
    def n_feats(self) -> int:
        return self.deg_f.shape[0]

    def to(self, device) -> "HeteroExpnGraph":
        return self._replace(**{k: _to(getattr(self, k), device) for k in self._fields
                                if k != "fmt"})


def _rel_sum(adj, h_src: torch.Tensor, n_out: int) -> torch.Tensor:
    """Σ_e w_e h_src[e] per destination: one weighted SpMM (counterpart:
    scmogcn.py:84). A BSR matrix takes ``n_out``, its true number of rows."""
    if isinstance(adj, torch.Tensor):  # the sampled fit's dense block
        return adj @ h_src
    return spmm(adj, h_src, n_out=n_out)


def _rel_mean(adj, h_src: torch.Tensor, deg: torch.Tensor, n_out: int) -> torch.Tensor:
    return _rel_sum(adj, h_src, n_out) / deg.clamp(min=1.0)[:, None]


def build_hetero_graph(x: np.ndarray, *, pathway_edges=None, cell_init: str = "none",
                       cell_svd_feats=None, batch_features=None, use_bsr="auto",
                       bsr_block: int = 128, device="auto") -> HeteroExpnGraph:
    """The hetero graph of a (cells x features) expression matrix, on
    ``device`` (counterpart: scmogcn.py:99). Edge weights are the raw values.
    ``use_bsr``: ``True`` tiles ``f2c`` and ``c2f`` to BSR (#1 on the card),
    ``False`` keeps them CSR, ``"auto"`` takes
    :func:`~dance_tpu_torch.ops.bsr.resolve_adj_format` in the natural order
    and ``"no_bsr"`` the same with a BSR answer demoted to CSR (the sampled
    fit gathers dense blocks, which a tiling cannot serve).
    ``pathway_edges`` is an ``(uu, vv, ee)`` triple of feature -> feature
    edges, kept as CSR."""
    device = resolve_device(device)
    a = sp.csr_matrix(np.asarray(x, np.float32))
    n_cells, n_feats = a.shape
    deg_c = np.diff(a.indptr).astype(np.float32)
    at = a.T.tocsr()
    deg_f = np.diff(at.indptr).astype(np.float32)
    fmt = resolve_adj_format("auto" if use_bsr == "no_bsr" else use_bsr, a, bsr_block,
                             device=device, reorder=False)
    if use_bsr == "no_bsr" and fmt == "bsr":
        fmt = "csr"
    if fmt == "dense":
        mat = torch.from_numpy(a.toarray())
        f2c = DenseAdj(mat, torch.from_numpy(deg_c))
        c2f = DenseAdj(mat.T.contiguous(), torch.from_numpy(deg_f))
    elif fmt == "bsr":
        f2c, c2f = bipartite_bsr(a, block=bsr_block)
    else:
        f2c, c2f = csr_from_scipy(a), csr_from_scipy(at)
    pw = deg_pw = None
    if pathway_edges is not None:
        uu, vv, ee = pathway_edges
        pw_sp = sp.csr_matrix((np.asarray(ee, np.float32), (np.asarray(vv), np.asarray(uu))),
                              shape=(n_feats, n_feats))
        deg_pw = torch.from_numpy(np.diff(pw_sp.indptr).astype(np.float32))
        pw = csr_from_scipy(pw_sp)
    cell_ids = cell_feats = None
    if cell_init == "none":
        cell_ids = torch.ones(n_cells, dtype=torch.int64)
    else:
        cell_feats = (cell_svd_feats.float() if isinstance(cell_svd_feats, torch.Tensor)
                      else torch.from_numpy(np.asarray(cell_svd_feats, np.float32)))
    bf = None if batch_features is None else torch.from_numpy(
        np.asarray(batch_features, np.float32))
    return HeteroExpnGraph(f2c, c2f, pw, torch.from_numpy(deg_c), torch.from_numpy(deg_f),
                           deg_pw, torch.arange(n_feats), cell_ids, cell_feats, bf,
                           fmt).to(device)


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # flax's gelu is the tanh form


# "prelu" is a leaky ReLU, as in the JAX package (scmogcn.py:159-160)
_ACTS = {"gelu": _gelu, "relu": torch.relu, "leaky_relu": F.leaky_relu,
         "prelu": F.leaky_relu}


class _Norm(nn.Module):
    """group / layer / batch / none normalisation (counterpart: scmogcn.py:163).
    ``group`` takes gcd(4, width) groups, ``batch`` standardises with the
    batch's own mean and population variance and keeps no running
    statistics; eps 1e-5 throughout."""

    def __init__(self, kind: str, dim: int):
        super().__init__()
        if kind not in ("group", "layer", "batch", "none"):
            raise ValueError(f"unknown normalization {kind!r}")
        self.kind = kind
        if kind == "group":
            self.norm = nn.GroupNorm(math.gcd(4, dim), dim, eps=1e-5)
        elif kind == "layer":
            self.norm = nn.LayerNorm(dim, eps=1e-5)
        elif kind == "batch":
            self.scale = nn.Parameter(torch.ones(dim))
            self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        if self.kind == "none":
            return h
        if self.kind == "batch":
            mu, var = h.mean(0), h.var(0, unbiased=False)
            return (h - mu) / torch.sqrt(var + 1e-5) * self.scale + self.bias
        return self.norm(h)


class _SAGERelation(nn.Module):
    """One relation's SAGE convolution with edge weights (counterpart:
    scmogcn.py:186): ``mean``: ``fc_self(h_dst) + fc_neigh(Σ w h_src / deg)``;
    ``gcn``: ``fc_neigh((Σ w h_src + h_dst) / (deg + 1))``. ``fc_self`` has
    no bias (flax's ``Dense_0`` of ``mean``; ``Dense_1`` is ``fc_neigh``).
    Source and destination features have the same width ``in_dim``, as in
    every layer of the trunk (``gcn`` adds them)."""

    def __init__(self, in_dim: int, out_dim: int, agg: str = "mean"):
        super().__init__()
        if agg not in ("mean", "gcn"):
            raise ValueError(f"unknown agg_function {agg!r}")
        self.agg = agg
        if agg == "mean":
            self.fc_self = nn.Linear(in_dim, out_dim, bias=False)
        self.fc_neigh = nn.Linear(in_dim, out_dim)

    def forward(self, adj, h_src, h_dst, deg):
        n_out = h_dst.shape[0]
        if self.agg == "gcn":
            neigh = (_rel_sum(adj, h_src, n_out) + h_dst) / (deg + 1.0)[:, None]
            return self.fc_neigh(neigh)
        return self.fc_self(h_dst) + self.fc_neigh(_rel_mean(adj, h_src, deg, n_out))


def _drop_adj(adj, drop):
    """Edge dropout on an adjacency's weights (counterpart: scmogcn.py:208):
    ``drop`` maps the weights (a dense block, ``DenseAdj.mat``, the BSR tiles
    or the CSR values) to dropped ones; ``None`` keeps ``adj``. Zero slots
    stay zero, the degrees are kept, and a BSR copy shares its pattern
    (:func:`bsr_like`)."""
    if adj is None or drop is None:
        return adj
    if isinstance(adj, torch.Tensor):
        return drop(adj)
    if isinstance(adj, DenseAdj):
        return DenseAdj(drop(adj.mat), adj.degrees)
    if isinstance(adj, BSRMatrix):
        return bsr_like(adj, drop(adj.tiles))
    if isinstance(adj, CSRMatrix):
        return adj.with_data(drop(adj.data))
    raise TypeError(f"no edge dropout for {type(adj).__name__}")


class ScMoGCN(nn.Module):
    """The scMoGNN trunk (counterpart: scmogcn.py:227), with every field of the
    JAX module; defaults are the benchmark example's. ``cell_feat_size`` is
    the width of the cell features when ``cell_init`` is not ``"none"``."""

    def __init__(self, out_size: int, feature_size: int, hidden_size: int = 48,
                 conv_layers: int = 4, embedding_layers: int = 1, readout_layers: int = 1,
                 agg_function: str = "mean", activation: str = "gelu",
                 normalization: str = "group", pathway: bool = False,
                 pathway_aggregation: str = "alpha", pathway_alpha: float = 0.25,
                 residual: str = "res_cat", initial_residual: bool = False, batch_num: int = 0,
                 cell_init: str = "none", weighted_sum: bool = False,
                 no_readout_concatenate: bool = False, edge_dropout: float = 0.3,
                 model_dropout: float = 0.2, subpath_activation: bool = False,
                 output_relu: str = "none", cell_feat_size: int = 0):
        super().__init__()
        if residual not in ("none", "res_add", "res_cat"):
            raise ValueError(f"unknown residual {residual!r}")
        if pathway_aggregation not in ("sum", "attention", "one_gate", "two_gate", "alpha",
                                       "cat"):
            raise ValueError(f"unknown pathway_aggregation {pathway_aggregation!r}")
        hid = hidden_size
        self.hidden_size, self.conv_layers, self.cell_init = hid, conv_layers, cell_init
        self.batch_num, self.pathway, self.residual = batch_num, pathway, residual
        self.initial_residual, self.weighted_sum = initial_residual, weighted_sum
        self.no_readout_concatenate, self.output_relu = no_readout_concatenate, output_relu
        self.pathway_aggregation, self.pathway_alpha = pathway_aggregation, pathway_alpha
        self.subpath_activation = subpath_activation
        self.edge_dropout, self.model_dropout = edge_dropout, model_dropout
        self.act = _ACTS[activation]
        ne = self.n_edges
        if batch_num > 0:
            self.extra_encoder = nn.Linear(batch_num, hid)
        self.embed_cell = (nn.Embedding(2, hid) if cell_init == "none"
                           else nn.Linear(cell_feat_size, hid))
        self.embed_feat = nn.Embedding(feature_size, hid)
        n_in = embedding_layers - 1
        self.cell_input_linears = nn.ModuleList(nn.Linear(hid, hid) for _ in range(n_in))
        self.feat_input_linears = nn.ModuleList(nn.Linear(hid, hid) for _ in range(n_in))
        self.cell_input_norm = nn.ModuleList(_Norm(normalization, hid) for _ in range(n_in))
        self.feat_input_norm = nn.ModuleList(_Norm(normalization, hid) for _ in range(n_in))
        # with res_cat every layer after the first sees [h, residual] on both sides
        ins = [hid] + [2 * hid if residual == "res_cat" else hid] * (conv_layers - 1)
        self.conv_f2c = nn.ModuleList(_SAGERelation(d, hid, agg_function) for d in ins)
        self.conv_c2f = nn.ModuleList(_SAGERelation(d, hid, agg_function) for d in ins)
        if pathway:
            self.conv_pw = nn.ModuleList(_SAGERelation(d, hid, agg_function) for d in ins)
        self.conv_norm = nn.ModuleList(_Norm(normalization, hid)
                                       for _ in range(conv_layers * ne))
        att_in = {"attention": hid, "one_gate": 3 * hid, "cat": 2 * hid,
                  "two_gate": 2 * hid}.get(pathway_aggregation)
        if att_in is not None:
            n_att = conv_layers * (2 if pathway_aggregation == "two_gate" else 1)
            self.att_linears = nn.ModuleList(nn.Linear(att_in, hid) for _ in range(n_att))
        ro_hid = hid if weighted_sum or no_readout_concatenate else hid * conv_layers
        widths = [ro_hid] * readout_layers + [out_size]
        self.readout_linears = nn.ModuleList(nn.Linear(a, b)
                                             for a, b in zip(widths[:-1], widths[1:]))
        self.wt = nn.Parameter(torch.zeros(conv_layers))
        if pathway_aggregation == "alpha" and pathway_alpha < 0:
            self.aph = nn.Parameter(torch.zeros(2))

    @property
    def n_edges(self) -> int:
        return 3 if self.pathway else 2

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's init: lecun-normal ``Dense`` kernels with zero biases,
        unit-variance normal ``Embed`` tables (std 1 / sqrt(width)), unit
        norms, zero ``wt`` and ``aph``."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                flax_dense_init_(m, generator)
            elif isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, std=m.embedding_dim ** -0.5, generator=generator)
            elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
                m.reset_parameters()
            elif isinstance(m, _Norm) and m.kind == "batch":
                nn.init.ones_(m.scale)
                nn.init.zeros_(m.bias)
        nn.init.zeros_(self.wt)
        if hasattr(self, "aph"):
            nn.init.zeros_(self.aph)

    # -- attention_agg (scmogcn.py:308-341) ---------------------------------
    def attention_agg(self, layer: int, h0, h1, h2):
        ne = self.n_edges
        if h2 is None:
            return self.conv_norm[layer * ne + 1](h1)
        agg = self.pathway_aggregation
        if agg == "sum":
            return h1 + h2
        if self.subpath_activation:
            h1, h2 = F.leaky_relu(h1), F.leaky_relu(h2)
        h1 = self.conv_norm[layer * ne + 1](h1)
        h2 = self.conv_norm[layer * ne + 2](h2)
        if agg == "attention":
            feats = torch.stack([h1, h2], 1)                     # (n, 2, hid)
            q = self.att_linears[layer](h0)[:, :, None]          # (n, hid, 1)
            att = torch.softmax(feats @ q, dim=1)                # (n, 2, 1)
            return (att.transpose(1, 2) @ feats)[:, 0, :]
        if agg == "one_gate":
            att = torch.sigmoid(self.att_linears[layer](torch.cat([h0, h1, h2], 1)))
            return att * h1 + (1 - att) * h2
        if agg == "two_gate":
            a1 = torch.sigmoid(self.att_linears[layer * 2](torch.cat([h0, h1], 1)))
            a2 = torch.sigmoid(self.att_linears[layer * 2 + 1](torch.cat([h0, h2], 1)))
            return a1 * h1 + a2 * h2
        if agg == "alpha":
            if self.pathway_alpha < 0:
                w = torch.softmax(self.aph, -1)
                return w[0] * h1 + w[1] * h2
            return (1 - self.pathway_alpha) * h1 + self.pathway_alpha * h2
        return self.att_linears[layer](torch.cat([h1, h2], 1))  # "cat"

    # -- one hetero conv layer (scmogcn.py:344-361) --------------------------
    def conv(self, g: HeteroExpnGraph, layer: int, h_feat, h_cell, h0_feat,
             generator: Optional[torch.Generator]):
        def edge_drop(w):
            return flax_dropout(w, self.edge_dropout, generator)

        if generator is None or self.edge_dropout == 0.0:
            edge_drop = None
        f2c, c2f = _drop_adj(g.f2c, edge_drop), _drop_adj(g.c2f, edge_drop)
        out_cell = self.conv_f2c[layer](f2c, h_feat, h_cell, g.deg_c)
        out_f1 = self.conv_c2f[layer](c2f, h_cell, h_feat, g.deg_f)
        out_f2 = None
        if self.pathway and g.pw is not None:
            out_f2 = self.conv_pw[layer](_drop_adj(g.pw, edge_drop), h_feat, h_feat, g.deg_pw)
        new_feat = flax_dropout(self.act(self.attention_agg(layer, h0_feat, out_f1, out_f2)),
                                self.model_dropout, generator)
        new_cell = flax_dropout(self.act(self.conv_norm[layer * self.n_edges](out_cell)),
                                self.model_dropout, generator)
        return new_feat, new_cell

    # -- initial embedding (scmogcn.py:364-383) -----------------------------
    def initial_embedding(self, g: HeteroExpnGraph, generator: Optional[torch.Generator]):
        hfeat = F.leaky_relu(self.embed_feat(g.feature_ids))
        cells = g.cell_ids if self.cell_init == "none" else g.cell_feats
        hcell = F.leaky_relu(self.embed_cell(cells))
        if self.batch_num > 0 and g.batch_feats is not None:
            hcell = hcell + F.leaky_relu(flax_dropout(self.extra_encoder(g.batch_feats), 0.2,
                                                  generator))
        for lin, norm in zip(self.feat_input_linears, self.feat_input_norm):
            hfeat = flax_dropout(norm(self.act(lin(hfeat))), self.model_dropout, generator)
        for lin, norm in zip(self.cell_input_linears, self.cell_input_norm):
            hcell = flax_dropout(norm(self.act(lin(hcell))), self.model_dropout, generator)
        return hfeat, hcell

    # -- propagation with hist residuals (scmogcn.py:386-402) ---------------
    def propagate(self, g: HeteroExpnGraph, generator: Optional[torch.Generator] = None):
        hfeat, hcell = self.initial_embedding(g, generator)
        hist = [(hfeat, hcell)]
        for i in range(self.conv_layers):
            if i > 0 and self.residual != "none":
                ref = hist[0] if self.initial_residual else hist[-2]
                if self.residual == "res_add":
                    hfeat, hcell = hfeat + ref[0], hcell + ref[1]
                else:
                    hfeat, hcell = torch.cat([hfeat, ref[0]], 1), torch.cat([hcell, ref[1]], 1)
            hfeat, hcell = self.conv(g, i, hfeat, hcell, hist[-1][0], generator)
            hist.append((hfeat, hcell))
        return hist

    def _combine(self, hist):
        if self.weighted_sum:
            w = torch.softmax(self.wt, -1)
            return sum(w[i] * hist[i + 1][1] for i in range(self.conv_layers))
        if not self.no_readout_concatenate:
            return torch.cat([hc for _, hc in hist[1:]], 1)
        return hist[-1][1]

    def encode(self, g: HeteroExpnGraph, generator: Optional[torch.Generator] = None):
        """The cell representation before the readout (counterpart: :412)."""
        return self._combine(self.propagate(g, generator))

    def readout(self, hist, generator: Optional[torch.Generator] = None):
        h = self._combine(hist)
        for lin in self.readout_linears[:-1]:
            h = flax_dropout(self.act(lin(h)), self.model_dropout, generator)
        h = self.readout_linears[-1](h)
        if self.output_relu == "relu":
            return torch.relu(h)
        if self.output_relu == "leaky_relu":
            return F.leaky_relu(h)
        return h

    def forward(self, g: HeteroExpnGraph, generator: Optional[torch.Generator] = None):
        """Predictions for every cell of ``g``; dropout only with a
        ``generator`` (the JAX module's ``deterministic=False``)."""
        return self.readout(self.propagate(g, generator), generator)


# --------------------------------------------------------------------------
# wrapper
# --------------------------------------------------------------------------


def default_args(**overrides) -> SimpleNamespace:
    """The reference benchmark's defaults (counterpart: scmogcn.py:435)."""
    args = dict(epoch=15000, learning_rate=1e-2, lr_decay=0.99, weight_decay=1e-5,
                hidden_size=48, conv_layers=4, embedding_layers=1,
                readout_layers=1, agg_function="mean", activation="gelu",
                normalization="group", pathway=False,
                pathway_aggregation="alpha", pathway_alpha=0.25,
                residual="res_cat", initial_residual=False,
                no_batch_features=True, cell_init="none", weighted_sum=False,
                no_readout_concatenate=False, edge_dropout=0.3,
                model_dropout=0.2, subpath_activation=False, output_relu="none",
                early_stopping=200, batch_size=1000, node_sampling_rate=0.5,
                eval_interval=1, seed=1)
    args.update(overrides)
    return SimpleNamespace(**args)


def set_lr(opt: torch.optim.Optimizer, lr: float, epoch: int, lr_decay: float) -> float:
    """After epoch 1200, every 15th epoch's end multiplies the learning rate by
    ``lr_decay`` (counterpart: ``_set_lr``, scmogcn.py:520); returns it."""
    if epoch > 1200 and epoch % 15 == 0:
        lr *= lr_decay
        for group in opt.param_groups:
            group["lr"] = lr
    return lr


class ScMoGCNWrapper(BaseRegressionMethod):
    """scMoGNN for modality prediction (counterpart: scmogcn.py:452). Takes a
    reference-style ``args`` namespace or keyword overrides of
    :func:`default_args` (``hidden`` and ``n_layers`` alias ``hidden_size``
    and ``conv_layers``). ``device="auto"`` is the card."""

    _DISPLAY_ATTRS = ("hidden_size", "conv_layers")

    @staticmethod
    def preprocessing_pipeline(log_level: str = "INFO"):
        """The ``SetConfig`` of a ``MuData`` of ``mod1`` and ``mod2``: mod1's
        ``X`` the features, mod2's ``X`` the labels (counterpart: scmogcn.py:478)."""
        return predict_modality_config(log_level)

    def __init__(self, args=None, hidden: Optional[int] = None,
                 n_layers: Optional[int] = None, seed: int = 0, device="auto", **overrides):
        if args is None:
            if hidden is not None:
                overrides.setdefault("hidden_size", hidden)
            if n_layers is not None:
                overrides.setdefault("conv_layers", n_layers)
            overrides.setdefault("seed", seed)
            args = default_args(**overrides)
        self.args = args
        self.hidden_size = args.hidden_size
        self.conv_layers = args.conv_layers
        self.seed = getattr(args, "seed", seed)
        self.device = resolve_device(device)
        self.net: Optional[ScMoGCN] = None
        self.history: List[Dict[str, float]] = []  # per epoch: epoch, loss, val, seconds

    def _make_net(self, out_size: int, g: HeteroExpnGraph) -> ScMoGCN:
        """A new trunk for ``g`` with flax's init drawn from ``seed``, on the device."""
        a = self.args
        batch_num = 0 if g.batch_feats is None else g.batch_feats.shape[1]
        net = ScMoGCN(out_size=out_size, feature_size=g.n_feats, hidden_size=a.hidden_size,
                      conv_layers=a.conv_layers, embedding_layers=a.embedding_layers,
                      readout_layers=a.readout_layers, agg_function=a.agg_function,
                      activation=a.activation, normalization=a.normalization,
                      pathway=a.pathway, pathway_aggregation=a.pathway_aggregation,
                      pathway_alpha=a.pathway_alpha, residual=a.residual,
                      initial_residual=a.initial_residual,
                      batch_num=0 if a.no_batch_features else batch_num,
                      cell_init=a.cell_init, weighted_sum=a.weighted_sum,
                      no_readout_concatenate=a.no_readout_concatenate,
                      edge_dropout=a.edge_dropout, model_dropout=a.model_dropout,
                      subpath_activation=a.subpath_activation, output_relu=a.output_relu,
                      cell_feat_size=0 if g.cell_feats is None else g.cell_feats.shape[1])
        net.reset_parameters(torch.Generator().manual_seed(self.seed))
        return net.to(self.device)

    def _start(self, y, g: HeteroExpnGraph):
        """Targets on the device, a new net and AdamW, the learning rate."""
        y = torch.as_tensor(np.asarray(y, np.float32)).to(self.device)
        self.net = self._make_net(y.shape[1], g)
        self._lr = self.args.learning_rate
        opt = torch.optim.AdamW(self.net.parameters(), lr=self._lr,
                                weight_decay=self.args.weight_decay)
        return y, opt, torch.Generator(device=self.device).manual_seed(self.seed)

    def _validate(self, epoch: int, g, val_idx, y, state: dict) -> bool:
        """Best-validation selection and the late early stop (counterpart:
        scmogcn.py:556-564); True to stop."""
        a = self.args
        val = self._score_graph(g, val_idx, y[val_idx])
        state["vals"].append(val)
        if val < state["minval"]:
            state["minval"], state["best"] = val, best_state(self.net)
        self.history[-1]["val"] = val
        if epoch > 1500 and a.early_stopping > 0 \
                and min(state["vals"][-a.early_stopping:]) > state["minval"]:
            logger.info("scMoGNN early stopped at epoch %d", epoch)
            return True
        return False

    # -- full-batch fit (scmogcn.py:529-571) ---------------------------------
    def fit_graph(self, g: HeteroExpnGraph, y, split=None, evaluate: bool = False,
                  y_test=None, sampling: bool = False, epochs: Optional[int] = None,
                  eval_interval: Optional[int] = None):
        """Full-graph training with AdamW, the lr decay of :func:`set_lr`, the
        best validation RMSE's weights and the late early stop; ``sampling``
        runs :meth:`_fit_sampling` instead. ``evaluate`` and ``y_test`` are
        unused, as in JAX."""
        a = self.args
        epochs = a.epoch if epochs is None else epochs
        eval_interval = a.eval_interval if eval_interval is None else eval_interval
        if g.deg_c.device.type != self.device.type:  # a graph built for another device
            g = g.to(self.device)
        if sampling:
            return self._fit_sampling(g, y, split, epochs, eval_interval)
        y, opt, gen = self._start(y, g)
        n = y.shape[0]
        train_idx = torch.as_tensor(split["train"] if split else np.arange(n)).to(self.device)
        val_idx = (torch.as_tensor(split["valid"]).to(self.device)
                   if split and "valid" in split else None)
        state = {"minval": np.inf, "best": best_state(self.net), "vals": []}
        clock, self.history = EpochClock(self.device), []
        for epoch in range(epochs):
            clock.tick()
            self.net.train()
            opt.zero_grad(set_to_none=True)
            pred = self.net(g, generator=gen)
            loss = ((pred[train_idx] - y[train_idx]) ** 2).mean()
            loss.backward()
            opt.step()
            self.history.append({"epoch": epoch, "loss": loss.detach()})
            if val_idx is not None and epoch % eval_interval == 0 \
                    and self._validate(epoch, g, val_idx, y, state):
                break
            self._lr = set_lr(opt, self._lr, epoch, a.lr_decay)
        clock.tick()
        self._finish(clock, val_idx is not None, state, g)
        return self

    def _finish(self, clock: EpochClock, selected: bool, state: dict, g):
        for h, s in zip(self.history, clock.seconds()):
            h["loss"], h["seconds"] = float(h["loss"]), s
        for h in self.history[::50]:
            logger.info("scMoGNN epoch %d, MSE %.5f", h["epoch"], h["loss"])
        if selected:
            self.net.load_state_dict(state["best"])
        self._graph = g

    def _forward(self, g) -> torch.Tensor:
        self.net.eval()
        with torch.no_grad():
            return self.net(g)

    def _score_graph(self, g, idx, y_ref) -> float:
        """RMSE of ``relu`` of the predictions (counterpart: scmogcn.py:580)."""
        pred = self._forward(g)[idx]
        return float(torch.sqrt(((torch.relu(pred) - y_ref) ** 2).mean()))

    # -- sampled fit (scmogcn.py:586-689) ------------------------------------
    def _fit_sampling(self, g: HeteroExpnGraph, y, split, epochs: int, eval_interval: int):
        """Cell minibatches with degree-weighted feature samples, drawn from a
        numpy generator as in JAX: each step gathers the dense (batch x
        sampled features) block of the expression matrix on the device,
        recomputes its degrees from ``w != 0`` and feeds the sampled
        ``feature_ids`` to the embedding; dense products only."""
        a = self.args
        if isinstance(g.f2c, DenseAdj):
            x_dense = g.f2c.mat
        elif isinstance(g.f2c, CSRMatrix):
            x_dense = _csr_dense(g.f2c)
        else:
            raise ValueError("sampled fit requires the dense or CSR graph path "
                             "(use_bsr='no_bsr' or False)")
        pw_dense = _csr_dense(g.pw) if a.pathway and g.pw is not None else None
        y, opt, gen = self._start(y, g)
        train_ids = np.asarray(split["train"]) if split else np.arange(len(y))
        val_idx = (torch.as_tensor(split["valid"]).to(self.device)
                   if split and "valid" in split else None)
        bs = min(a.batch_size, len(train_ids))
        n_feat_samp = max(1, int(a.node_sampling_rate * g.n_feats))
        deg_f = g.deg_f.cpu().numpy()
        p_feat = deg_f / max(deg_f.sum(), 1e-12)
        rng_np = np.random.default_rng(self.seed)
        state = {"minval": np.inf, "best": best_state(self.net), "vals": []}
        clock, self.history = EpochClock(self.device), []
        for epoch in range(epochs):
            clock.tick()
            losses = []
            for cells, feats in sampled_batches(rng_np, train_ids, bs, g.n_feats, n_feat_samp,
                                                p_feat, a.node_sampling_rate):
                cell_idx = torch.from_numpy(cells).to(self.device)
                feat_idx = torch.from_numpy(feats).to(self.device)
                sub = _subgraph(g, x_dense, pw_dense, cell_idx, feat_idx)
                self.net.train()
                opt.zero_grad(set_to_none=True)
                loss = ((self.net(sub, generator=gen) - y[cell_idx]) ** 2).mean()
                loss.backward()
                opt.step()
                losses.append(loss.detach())
            self.history.append({"epoch": epoch, "loss": torch.stack(losses).mean()})
            if val_idx is not None and epoch % eval_interval == 0 \
                    and self._validate(epoch, g, val_idx, y, state):
                break
            self._lr = set_lr(opt, self._lr, epoch, a.lr_decay)
        clock.tick()
        self._finish(clock, val_idx is not None, state, g)
        return self

    # -- array fit (scmogcn.py:692-748) --------------------------------------
    def fit(self, x_train, y_train, x_test=None, epochs: int = 200,
            lr: Optional[float] = None, weight_decay: Optional[float] = None,
            use_bsr="auto", bsr_block: int = 128, sampling: bool = False,
            batch_features=None, pathway_edges=None, val_fraction: float = 0.15):
        """Train on the train cells (the last ``val_fraction`` of a permutation
        from ``default_rng(seed)`` held out for best-epoch selection); test
        cells join the graph transductively (``split`` keeps the train and
        validation rows). The graph is kept across fits, keyed by a hash of
        its content. ``sampling`` turns ``"auto"`` into
        ``"no_bsr"`` and ``True`` into ``False``."""
        a = self.args
        if lr is not None:
            a.learning_rate = lr
        if weight_decay is not None:
            a.weight_decay = weight_decay
        x_tr = np.asarray(x_train, np.float32)
        y_tr = np.asarray(y_train, np.float32)
        x_all = x_tr if x_test is None else np.concatenate(
            [x_tr, np.asarray(x_test, np.float32)])
        self._n_train = len(x_tr)
        if sampling:
            use_bsr = "no_bsr" if use_bsr == "auto" else False
        h = hashlib.md5(np.ascontiguousarray(x_all))
        for arr in ([] if batch_features is None else [batch_features]) + \
                list(pathway_edges or ()):
            h.update(np.ascontiguousarray(np.asarray(arr)))
        cache_key = (x_all.shape, a.cell_init, str(use_bsr), bsr_block, h.hexdigest())
        if getattr(self, "_graph_cache_key", None) == cache_key:
            g = self._graph_cache
        else:
            cell_svd = None
            if a.cell_init == "svd":
                from dance_tpu_torch.ops.linalg import svd_embedding
                k = min(100, min(x_all.shape) - 1)
                cell_svd = svd_embedding(torch.from_numpy(x_all).to(self.device), k)[0]
            g = build_hetero_graph(x_all, pathway_edges=pathway_edges, cell_init=a.cell_init,
                                   cell_svd_feats=cell_svd, batch_features=batch_features,
                                   use_bsr=use_bsr, bsr_block=bsr_block, device=self.device)
            self._graph_cache_key, self._graph_cache = cache_key, g
        n_val = int(len(x_tr) * val_fraction)
        idx = np.random.default_rng(self.seed).permutation(len(x_tr))
        split = {"train": idx[:-n_val] if n_val else idx}
        if n_val:
            split["valid"] = idx[-n_val:]
        self.split = split
        y_all = y_tr if len(x_all) == len(y_tr) else np.concatenate(
            [y_tr, np.zeros((len(x_all) - len(y_tr), y_tr.shape[1]), np.float32)])
        return self.fit_graph(g, y_all, split, sampling=sampling, epochs=epochs)

    def predict(self, x=None, idx=None) -> np.ndarray:
        """Predictions of every cell of the last fit's graph; ``idx`` picks
        rows, and an ``x`` of the test cells' count picks the test cells."""
        pred = self._forward(self._graph).cpu().numpy()
        if idx is not None:
            return pred[idx]
        if x is not None and len(x) != pred.shape[0]:
            return pred[self._n_train:]
        return pred

    def score(self, x, y, *, score_func=None, return_pred: bool = False, **kwargs):
        pred = self.predict(x)
        s = resolve_score_func(score_func or "rmse")(np.asarray(y), pred)
        return (s, pred) if return_pred else s


def sampled_batches(rng: np.random.Generator, train_ids: np.ndarray, batch_size: int,
                    n_feats: int, n_feat_samp: int, p_feat: np.ndarray, rate: float):
    """One epoch's (cell ids, feature ids) steps of the sampled fit, drawn
    from ``rng`` in the JAX package's order (scmogcn.py:659-668): a
    permutation of the train cells in ``len // batch_size`` batches, and per
    step ``n_feat_samp`` features without replacement, weighted by degree
    (all features at ``rate >= 1``)."""
    perm = rng.permutation(train_ids)
    for s in range(max(1, len(perm) // batch_size)):
        cells = perm[s * batch_size:(s + 1) * batch_size]
        if rate < 1:
            feats = rng.choice(n_feats, n_feat_samp, replace=False, p=p_feat)
        else:
            feats = np.arange(n_feats)
        yield np.asarray(cells, np.int64), np.asarray(feats, np.int64)


def _csr_dense(adj: CSRMatrix) -> torch.Tensor:
    """A CSR adjacency as a dense tensor on its device."""
    return torch.sparse_csr_tensor(adj.indptr, adj.indices, adj.data,
                                   size=adj.shape).to_dense()


def _subgraph(g: HeteroExpnGraph, x_dense, pw_dense, cell_idx, feat_idx) -> HeteroExpnGraph:
    """The dense block of the sampled cells and features (counterpart:
    scmogcn.py:624-639), degrees recomputed from its nonzeros."""
    w = x_dense.index_select(0, cell_idx).index_select(1, feat_idx)
    nz = (w != 0).to(torch.float32)
    pw = deg_pw = None
    if pw_dense is not None:
        pw = pw_dense.index_select(0, feat_idx).index_select(1, feat_idx)
        deg_pw = (pw != 0).sum(1).to(torch.float32)

    def rows(t):
        return None if t is None else t.index_select(0, cell_idx)

    return HeteroExpnGraph(w, w.T, pw, nz.sum(1), nz.sum(0), deg_pw, feat_idx,
                           rows(g.cell_ids), rows(g.cell_feats), rows(g.batch_feats), "dense")


__all__ = ["HeteroExpnGraph", "ScMoGCN", "ScMoGCNWrapper", "build_hetero_graph",
           "default_args", "sampled_batches", "set_lr"]
