"""stdGCN: a two-tower GCN over expression and spatial spot graphs.

Counterpart: dance_tpu/modules/spatial/cell_type_deconvo/stdgcn.py (the graph
builders :42-213, ``_FullBatchNorm`` :216, ``_ConGCN`` :225, ``StdGCN``
:264-499, ``get_idx``/``full_block``/``autoencoder``/``auto_train`` :516-591,
``stdGCNMarkGenes`` :603-658). An expression tower over ``adj_exp`` (mutual-NN
links between real and pseudo-spots in an integrated embedding, plus each
split's expression kNN) and a spatial tower over ``adj_sp`` (the real spots'
inverse-distance kNN) each run GCN layers of Dense → aggregate → full-batch
norm → ELU → dropout; their outputs are concatenated into a dense head with a
log-softmax over the cell types, trained with KL divergence against the
pseudo-spots' portions under global-norm clipping and Adam, with early
stopping on a 10 % validation split of the pseudo-spots. Every aggregation
goes through :func:`~dance_tpu_torch.ops.segment.spmm`: one matrix product on
a dense adjacency, the block-sparse SpMM (the CUDA kernel #1 on the card,
forward and ``Aᵀḡ``) on BSR tiles, which both towers take under one shared RCM
order of ``adj_exp + adj_sp``. ``use_bsr="auto"`` (the default, as in JAX)
lets :func:`~dance_tpu_torch.ops.bsr.resolve_adj_format` pick dense, BSR or
CSR for that sum; CSR off the card.

Where this differs from the JAX package:

- The graph builders return scipy CSR matrices where JAX fills dense
  (n x n) arrays, and the two Python double loops (mutual pairs, spatial
  links) are vectorised; the edges and weights are the same, the spatial
  link that two spots both write keeping the later write as JAX's loop
  does. The PCA and the kNN run on ``device`` (the card unless the CPU is
  named) and are the port's: see transforms/graph/dstg_graph.py for what
  that means for ties.
- ``batch_removal="combat"`` runs :func:`dance_tpu_torch.sc.pp.combat` on
  the pseudo and real blocks on ``device``, in float64, as JAX runs
  ``sc.pp.combat`` on the host. ``stdGCNMarkGenes`` is the function
  :func:`stdgcn_marker_genes` on arrays (a thin class keeps the name); the
  model's pipeline uses ``FilterGenesMarker``.
- Plain ``max_epochs`` training (``early_stopping_patience=0``) is an epoch
  loop; JAX runs it as one compiled scan.
- The weights are drawn at each ``fit`` from a CPU ``torch.Generator``
  seeded with ``seed``, the dropout masks from a generator on the device;
  parity tests copy the flax weights in
  (:func:`dance_tpu_torch.utils.params.stdgcn_flax_to_torch`) by patching
  :meth:`StdGCN._make_net`.
- ``full_block``'s dropout drops in training (the reference's module);
  JAX's never drops. ``data_integration`` passes ``p_drop=0``, where the two
  agree.
- ``history`` records each epoch's loss, validation loss and seconds,
  ``stopped_epoch`` the epoch early stopping ended on, ``fmt`` the
  adjacency format and ``graph_seconds`` the graph build's wall time.
- ``preprocessing_pipeline`` is JAX's step list with one difference, and
  :func:`stdgcn_preprocess` is its array front. On a container of
  reference cells and spots JAX's takes the cell-type profile of the pseudo
  split, whose spots carry no type (every NaN label a type of its own), and
  keeps no gene. The port's takes the profile of the reference cells
  (``CellTopicProfile.split_name`` is ``"ref"``), as DSTG's does; its
  ``PseudoMixture`` keeps the portions and the spots' coordinates, which
  JAX's ``Data.append`` drops.
"""

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from dance_tpu_torch.modules.base import BaseRegressionMethod
from dance_tpu_torch.modules.spatial.cell_type_deconvo.dstg import deconvo_container, spot_order
from dance_tpu_torch.nn.gnn import flax_dense_init_, flax_dropout
# stdgcn.py:216's block, shared with scHeteroNet and GraphSCI
from dance_tpu_torch.nn.mlp import FullBatchNorm as _FullBatchNorm
from dance_tpu_torch.ops.bsr import (bsr_from_scipy, rcm_reorder, resolve_adj_format,
                                     unpermute)
from dance_tpu_torch.ops.linalg import pca
from dance_tpu_torch.ops.neighbors import _knn_block
from dance_tpu_torch.ops.segment import spmm
from dance_tpu_torch.ops.sparse import csr_from_scipy, dense_adj_from_scipy
from dance_tpu_torch.sc.pp import combat
from dance_tpu_torch.sc.tl import rank_genes_groups
from dance_tpu_torch.settings import logger
from dance_tpu_torch.transforms.filter import FilterGenesMarker
from dance_tpu_torch.transforms.misc import Compose, SetConfig
from dance_tpu_torch.transforms.pseudobulk import CellTopicProfile, PseudoMixture
from dance_tpu_torch.utils import EpochClock, resolve_device
from dance_tpu_torch.utils.optim import best_state, clip_by_global_norm_


# --------------------------------------------------------------------------
# adjacency builders (counterpart: stdgcn.py:42-209)
# --------------------------------------------------------------------------

def _knn(query: np.ndarray, base: np.ndarray, k: int, device) -> Tuple[np.ndarray, np.ndarray]:
    """Distances and indices of each query row's ``min(k, len(base))``
    nearest base rows, nearest first, computed on ``device`` (counterpart:
    ``_knn_indices``, stdgcn.py:42)."""
    q = torch.as_tensor(np.asarray(query, np.float32)).to(device)
    x = torch.as_tensor(np.asarray(base, np.float32)).to(device)
    d, idx = _knn_block(q, x, min(k, x.shape[0]))
    return d.cpu().numpy(), idx.cpu().numpy()


def find_mutual_nn(data1: np.ndarray, data2: np.ndarray, k1: int, k2: int, *,
                   device="auto") -> np.ndarray:
    """Mutual nearest neighbours of two point sets (counterpart: stdgcn.py:50):
    the (m, 2) pairs ``(i, j)``, ``i`` a row of ``data1`` among the ``k2``
    nearest of ``data2[j]`` and ``j`` among the ``k1`` nearest of
    ``data1[i]``; ordered by ``j``, then by ``i``'s rank, as JAX's loop."""
    device = resolve_device(device)
    k_index_1 = _knn(data2, data1, k2, device)[1]  # each row of data2: its NNs in data1
    k_index_2 = _knn(data1, data2, k1, device)[1]  # each row of data1: its NNs in data2
    n2 = data2.shape[0]
    j = np.repeat(np.arange(n2), k_index_1.shape[1])
    i = k_index_1.ravel().astype(np.int64)
    back = np.repeat(np.arange(data1.shape[0]), k_index_2.shape[1]) * n2 + k_index_2.ravel()
    mutual = np.isin(i * n2 + j, back)
    return np.stack([i[mutual], j[mutual]], axis=1)


def inter_adj(real_emb: np.ndarray, pseudo_emb: np.ndarray, corr_dist_neighbors: int = 20, *,
              device="auto") -> sp.csr_matrix:
    """Mutual-NN links between real and pseudo-spots in the integrated
    space, symmetric, ones, in the [pseudo; real] layout (counterpart:
    stdgcn.py:64)."""
    n_p, n_r = pseudo_emb.shape[0], real_emb.shape[0]
    pairs = find_mutual_nn(real_emb, pseudo_emb, corr_dist_neighbors, corr_dist_neighbors,
                           device=device)
    rows, cols = n_p + pairs[:, 0], pairs[:, 1]
    a = sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)), shape=(n_p + n_r,) * 2)
    return (a + a.T).tocsr()


def intra_exp_adj(feat: np.ndarray, corr_dist_neighbors: int = 10, pca_dim: int = 50,
                  seed: int = 0, *, device="auto") -> sp.csr_matrix:
    """The expression kNN graph of one split over its ``pca_dim``-d PCA,
    symmetrised by the maximum, ones (counterpart: stdgcn.py:78). The
    nearest column is taken as the spot itself and dropped, as in JAX."""
    device = resolve_device(device)
    x = np.asarray(feat, np.float32)
    if pca_dim and min(x.shape) > pca_dim + 1:
        x = pca(torch.from_numpy(x).to(device), pca_dim, seed=seed).embedding.cpu().numpy()
    n = x.shape[0]
    idx = _knn(x, x, min(corr_dist_neighbors + 1, n), device)[1][:, 1:]
    rows = np.repeat(np.arange(n), idx.shape[1])
    a = sp.csr_matrix((np.ones(rows.size, np.float32), (rows, idx.ravel())), shape=(n, n))
    return a.maximum(a.T).tocsr()


def intra_dist_adj(coords: np.ndarray, space_dist_neighbors: int = 27,
                   link_method: str = "soft", space_dist_threshold: Optional[float] = None,
                   *, device="auto") -> sp.csr_matrix:
    """The spatial kNN graph, symmetric; ``"soft"`` weighs a link by its
    inverse distance, ``"hard"`` by 1; links at ``space_dist_threshold`` or
    farther are dropped (counterpart: stdgcn.py:93). Where both spots of a
    pair list each other, the link keeps the weight written by the later
    spot, as JAX's loop leaves it."""
    x = np.asarray(coords, np.float32)
    n = x.shape[0]
    d, idx = _knn(x, x, min(space_dist_neighbors + 1, n), resolve_device(device))
    d, idx = d[:, 1:], idx[:, 1:]  # the self column
    writer = np.repeat(np.arange(n), idx.shape[1])
    nb, d = idx.ravel().astype(np.int64), d.ravel()
    keep = np.ones(nb.size, bool) if space_dist_threshold is None else d < space_dist_threshold
    writer, nb, d = writer[keep], nb[keep], d[keep]
    w = (np.ones_like(d) if link_method == "hard"
         else (1.0 / np.maximum(d, np.float32(1e-12))).astype(np.float32))
    rows, cols = np.concatenate([writer, nb]), np.concatenate([nb, writer])
    writer, w = np.concatenate([writer, writer]), np.concatenate([w, w])
    key = rows * n + cols
    order = np.lexsort((writer, key))  # by cell, then by writer: the last write last
    last = order[np.r_[key[order][1:] != key[order][:-1], True]]
    return sp.csr_matrix((w[last], (rows[last], cols[last])), shape=(n, n))


def _expand_block(adj: sp.spmatrix, which: str, n_pseudo: int, n_real: int) -> sp.csr_matrix:
    """Place one split's adjacency into the [pseudo; real] layout
    (counterpart: ``A_intra_transfer``, stdgcn.py:115)."""
    coo = sp.coo_matrix(adj)
    off = 0 if which == "pseudo" else n_pseudo
    n = n_pseudo + n_real
    return sp.csr_matrix((coo.data.astype(np.float32), (coo.row + off, coo.col + off)),
                         shape=(n, n))


def _sym_normalize(adj: sp.spmatrix) -> sp.csr_matrix:
    """``D^-1/2 A D^-1/2`` in float32, degrees floored at 1e-12 (counterpart:
    stdgcn.py:127)."""
    coo = sp.coo_matrix(adj, dtype=np.float32)
    deg = np.maximum(np.asarray(coo.sum(1), np.float32).ravel(), np.float32(1e-12))
    dinv = (1.0 / np.sqrt(deg)).astype(np.float32)
    data = coo.data * dinv[coo.row] * dinv[coo.col]
    out = sp.csr_matrix((data, (coo.row, coo.col)), shape=coo.shape)
    out.eliminate_zeros()
    return out


def adj_normalize(adj) -> sp.csr_matrix:
    """Symmetric normalisation of a dense or sparse adjacency (counterpart:
    stdgcn.py:507)."""
    return _sym_normalize(adj if sp.issparse(adj) else sp.csr_matrix(np.asarray(adj)))


def _scaled(x: np.ndarray) -> np.ndarray:
    return (x - x.mean(0)) / np.maximum(x.std(0), 1e-8)


def data_integration(feat: np.ndarray, n_pseudo: int, *, method: Optional[str] = "pca",
                     min_dim: int = 50, scale: bool = True,
                     batch_removal: Optional[str] = None, ae_epochs: int = 2000,
                     ae_lr: float = 1e-3, ae_drop: float = 0.0, seed: int = 0,
                     device="auto") -> np.ndarray:
    """The spot embedding that the real-pseudo links are found in
    (counterpart: stdgcn.py:133): with ``"pca"`` the PCA of the standardised
    spots, with ``"autoencoder"`` the :func:`auto_train` embedding
    standardised, with ``None`` the spots standardised; ``min(min_dim,
    genes // 2)`` dimensions. ``feat`` is ordered [pseudo; real]. With
    ``batch_removal="combat"`` the spots are first corrected by
    :func:`~dance_tpu_torch.sc.pp.combat` on ``device``, the pseudo-spots and
    the real spots its two batches."""
    dim = min(min_dim, max(1, feat.shape[1] // 2))
    x = np.asarray(feat, np.float32)
    if batch_removal == "combat":
        batch = np.array(["pseudo"] * n_pseudo + ["real"] * (len(x) - n_pseudo))
        x = combat(x, batch, device=device)
    elif batch_removal is not None:
        raise ValueError(f"unknown batch removal {batch_removal!r}")
    if method in ("pca", "PCA"):
        if scale:
            x = _scaled(x)
        device = resolve_device(device)
        return pca(torch.from_numpy(x).to(device), dim, seed=seed).embedding.cpu().numpy()
    if method == "autoencoder":
        emb = auto_train(x, epoch_n=ae_epochs, lr=ae_lr, latent_size=dim, p_drop=ae_drop,
                         seed=seed, device=device)
        return _scaled(emb) if scale else emb
    if method in (None, "none", "None"):
        return _scaled(x) if scale else x
    raise ValueError(f"unknown integration method {method!r}")


def build_stdgcn_adjacencies(feat: np.ndarray, coords_real: np.ndarray, n_pseudo: int, *,
                             inter_k: int = 20, intra_exp_k: int = 10, space_k: int = 27,
                             adj_alpha: float = 1.0, adj_beta: float = 1.0,
                             diag_power: float = 20.0, seed: int = 0,
                             integration_method: Optional[str] = "pca",
                             integration_dim: int = 50,
                             integration_batch_removal: Optional[str] = None,
                             ae_epochs: int = 2000, ae_lr: float = 1e-3,
                             device="auto") -> Tuple[sp.csr_matrix, sp.csr_matrix]:
    """``(adj_exp, adj_sp)``, both normalised, float32 CSR, in the [pseudo;
    real] order of ``feat`` (counterpart: stdgcn.py:172): ``adj_exp = (A_inter
    + α A_pseudo + β A_real) / ((1 + α + β) diag_power) + I`` with the
    real-pseudo mutual links on the :func:`data_integration` embedding (the
    raw features without integration) and each split's expression kNN;
    ``adj_sp = A_space / diag_power + I`` with the real spots' spatial kNN
    (pseudo-spots keep their self-loop alone)."""
    device = resolve_device(device)
    n = feat.shape[0]
    n_real = n - n_pseudo
    pseudo_feat, real_feat = feat[:n_pseudo], feat[n_pseudo:]
    if integration_method in (None, "none", "None"):
        emb = feat
    else:
        emb = data_integration(feat, n_pseudo, method=integration_method,
                               min_dim=integration_dim, batch_removal=integration_batch_removal,
                               ae_epochs=ae_epochs, ae_lr=ae_lr, seed=seed, device=device)
    a_inter = inter_adj(emb[n_pseudo:], emb[:n_pseudo], inter_k, device=device)
    a_p = _expand_block(intra_exp_adj(pseudo_feat, intra_exp_k, seed=seed, device=device),
                        "pseudo", n_pseudo, n_real)
    a_r = _expand_block(intra_exp_adj(real_feat, intra_exp_k, seed=seed, device=device),
                        "real", n_pseudo, n_real)
    a_sp = _expand_block(intra_dist_adj(coords_real, space_k, device=device), "real",
                         n_pseudo, n_real)
    balance = (1 + adj_alpha + adj_beta) * diag_power
    eye = sp.eye(n, format="csr", dtype=np.float32)
    adj_exp = (a_inter + a_p * np.float32(adj_alpha) + a_r * np.float32(adj_beta)) \
        / np.float32(balance) + eye
    adj_sp = a_sp / np.float32(diag_power) + eye
    return _sym_normalize(adj_exp), _sym_normalize(adj_sp)


# reference name for the split-block placement helper (stdgcn.py:595)
A_intra_transfer = _expand_block


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------

class _ConGCN(nn.Module):
    """The two GCN towers and the dense head (counterpart: stdgcn.py:225).
    ``exp``/``sp`` hold each tower's GCN Dense layers, ``exp_norm``/``sp_norm``
    their norms, ``fc``/``fc_norm`` the head's, ``out`` the last Dense; flax
    names them in call order (see utils/params.py)."""

    def __init__(self, in_dim: int, nhid: int, out_dim: int, common_hid_layers_num: int = 1,
                 fcnn_hid_layers_num: int = 1, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        widths = [in_dim] + [nhid] * (common_hid_layers_num + 1)
        for tower in ("exp", "sp"):
            setattr(self, tower, nn.ModuleList(nn.Linear(a, b)
                                               for a, b in zip(widths[:-1], widths[1:])))
            setattr(self, f"{tower}_norm", nn.ModuleList(_FullBatchNorm(nhid)
                                                         for _ in widths[1:]))
        head = [2 * nhid] + [nhid] * (fcnn_hid_layers_num + 1)
        self.fc = nn.ModuleList(nn.Linear(a, b) for a, b in zip(head[:-1], head[1:]))
        self.fc_norm = nn.ModuleList(_FullBatchNorm(nhid) for _ in head[1:])
        self.out = nn.Linear(nhid, out_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax ``Dense``'s init (lecun-normal kernels, zero biases) in flax's
        call order; norms at scale 1, bias 0."""
        for layer in self.modules():
            if isinstance(layer, nn.Linear):
                flax_dense_init_(layer, generator)
            elif isinstance(layer, _FullBatchNorm):
                nn.init.ones_(layer.scale)
                nn.init.zeros_(layer.bias)

    def forward(self, adj_exp, adj_sp, x: torch.Tensor,
                dropout_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        def block(norm, h):
            return flax_dropout(nn.functional.elu(norm(h)), self.dropout, dropout_gen)

        h_exp, h_sp = x, x
        for lin_e, norm_e, lin_s, norm_s in zip(self.exp, self.exp_norm, self.sp, self.sp_norm):
            h_exp = block(norm_e, spmm(adj_exp, lin_e(h_exp)))
            h_sp = block(norm_s, spmm(adj_sp, lin_s(h_sp)))
        h = torch.cat([h_exp, h_sp], dim=1)
        for lin, norm in zip(self.fc, self.fc_norm):
            h = block(norm, lin(h))
        return torch.log_softmax(self.out(h), dim=-1)


# reference class name for the two-tower network (stdgcn.py:513)
conGCN = _ConGCN


class StdGCN(BaseRegressionMethod):
    """stdGCN (counterpart: stdgcn.py:264). ``fit((x, coords), y)``: ``x``
    the spots' features ordered [pseudo; real], ``coords`` the real spots'
    coordinates (or every spot's, the pseudo rows ignored), ``y`` the
    pseudo-spots' portions over zero rows for the real spots."""

    _DISPLAY_ATTRS = ("nhid", "dropout")

    def __init__(self, hidden: Tuple[int, ...] = (256,), nhid: Optional[int] = None,
                 common_hid_layers_num: int = 1, fcnn_hid_layers_num: int = 1,
                 dropout: float = 0.1, device="auto", seed: int = 0):
        self.nhid = nhid or (hidden[0] if hidden else 256)
        self.common_hid_layers_num = common_hid_layers_num
        self.fcnn_hid_layers_num = fcnn_hid_layers_num
        self.dropout = dropout
        self.seed = seed
        self.device = resolve_device(device)
        self.net: Optional[_ConGCN] = None
        self.history: List[Dict[str, float]] = []  # per epoch: epoch, loss, val, seconds
        self.stopped_epoch: Optional[int] = None

    @staticmethod
    def preprocessing_pipeline(n_pseudo: int = 500, log_level: str = "INFO") -> Compose:
        """stdGCN's preprocessing of a container of labelled reference cells
        and spots (:func:`~dance_tpu_torch.modules.spatial.cell_type_deconvo.
        dstg.deconvo_container`, the spots' coordinates in
        ``obsm["spatial"]``): ``n_pseudo`` pseudo-spots (split ``"pseudo"``),
        the median profile of each type over the reference cells and its
        marker genes (log-FC 1.25); the features are ``X`` and the
        coordinates, the labels the portions (counterpart: stdgcn.py:280-292;
        the one difference, the reference cells' profile, is in the module's
        notes). Nothing here runs on the card."""
        return Compose(
            PseudoMixture(n_pseudo=n_pseudo),
            CellTopicProfile(ct_select="auto", split_name="ref"),
            FilterGenesMarker(threshold=1.25),
            SetConfig({"feature_channel": [None, "spatial"],
                       "feature_channel_type": ["X", "obsm"],
                       "label_channel": "cell_type_portion"}),
            log_level=log_level,
        )

    @staticmethod
    def _kl(logp: torch.Tensor, target: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        """torch ``KLDivLoss(reduction="mean")`` over the rows in ``m``: the
        mean over their elements of ``target (log target - logp)``
        (counterpart: stdgcn.py:294)."""
        elem = target * (torch.log(target.clamp(min=1e-10)) - logp)
        return (elem * m[:, None]).sum() / (m.sum() * target.shape[1]).clamp(min=1.0)

    def _make_net(self, in_dim: int, out_dim: int) -> _ConGCN:
        """A new network with flax's init drawn from ``seed``, on the device."""
        net = _ConGCN(in_dim, self.nhid, out_dim, self.common_hid_layers_num,
                      self.fcnn_hid_layers_num, self.dropout)
        net.reset_parameters(torch.Generator().manual_seed(self.seed))
        return net.to(self.device)

    def _graph(self, x, real_coords, n_pseudo: int, use_bsr, bsr_block: int, kw):
        """The two adjacencies on the device in the chosen format, and the
        shared permutation (None unless BSR); ``graph_seconds`` times it."""
        t0 = time.perf_counter()
        adj_exp, adj_sp = build_stdgcn_adjacencies(x, real_coords, n_pseudo, seed=self.seed,
                                                   device=self.device, **kw)
        self.fmt = resolve_adj_format(use_bsr, adj_exp + adj_sp, bsr_block, device=self.device)
        logger.info("stdGCN adjacency format: %s", self.fmt)
        perm = None
        if self.fmt == "bsr":
            perm, _ = rcm_reorder(adj_exp + adj_sp)
            perm = np.asarray(perm)
            adj_exp = bsr_from_scipy(adj_exp[perm][:, perm], block=bsr_block)
            adj_sp = bsr_from_scipy(adj_sp[perm][:, perm], block=bsr_block)
        elif self.fmt == "dense":
            adj_exp, adj_sp = dense_adj_from_scipy(adj_exp), dense_adj_from_scipy(adj_sp)
        else:
            adj_exp, adj_sp = csr_from_scipy(adj_exp), csr_from_scipy(adj_sp)
        out = adj_exp.to(self.device), adj_sp.to(self.device), perm
        self.graph_seconds = time.perf_counter() - t0
        return out

    def fit(self, inputs, y, train_mask=None, lr: float = 1e-2, max_epochs: int = 300,
            early_stopping_patience: int = 5, train_valid_ratio: float = 0.9,
            clip_grad_max_norm: float = 1.0, inter_k: int = 20, intra_exp_k: int = 10,
            space_k: int = 27, use_bsr="auto", bsr_block: int = 128,
            dimensionality_reduction_method: Optional[str] = "pca", integration_dim: int = 50,
            batch_removal_method: Optional[str] = None, autoencoder_epoches: int = 2000,
            autoencoder_LR: float = 1e-3):
        """Build the graphs (or take them from the cache, keyed as JAX keys it
        on the inputs' content and the graph options), then train from new
        weights (counterpart: stdgcn.py:345). With ``early_stopping_patience
        > 0`` the validation loss is read after every step, rounded to 4
        places, and training stops once it has not fallen for that many
        epochs; the best weights are kept. With 0, ``max_epochs`` steps and the
        last weights."""
        x, coords = inputs
        x = np.asarray(x, np.float32)
        coords = np.asarray(coords, np.float32)
        y = np.asarray(y, np.float32)
        n = x.shape[0]
        train_mask = np.asarray(y.sum(1) > 0 if train_mask is None else train_mask, bool)
        n_pseudo = int(train_mask.sum())
        real_coords = coords[~train_mask] if coords.shape[0] == n else coords
        cache_key = (x.shape, coords.shape, float(x[:: max(1, n // 7)].sum()),
                     float(coords.sum()), inter_k, intra_exp_k, space_k, self.seed,
                     dimensionality_reduction_method, integration_dim, batch_removal_method,
                     str(use_bsr), bsr_block, str(self.device))
        if getattr(self, "_graph_cache_key", None) != cache_key:
            kw = dict(inter_k=inter_k, intra_exp_k=intra_exp_k,
                      space_k=min(space_k, max(int((~train_mask).sum()) - 1, 1)),
                      integration_method=dimensionality_reduction_method,
                      integration_dim=integration_dim,
                      integration_batch_removal=batch_removal_method,
                      ae_epochs=autoencoder_epoches, ae_lr=autoencoder_LR)
            self._graph_cache = self._graph(x, real_coords, n_pseudo, use_bsr, bsr_block, kw)
            self._graph_cache_key = cache_key
        self.adj_exp, self.adj_sp, self._perm = self._graph_cache
        if self._perm is not None:
            x, y, train_mask = x[self._perm], y[self._perm], train_mask[self._perm]

        # 90/10 train/valid split of the labelled spots, in the training order
        labeled = np.nonzero(train_mask)[0]
        n_tr = int(len(labeled) * train_valid_ratio)
        tr_mask, va_mask = np.zeros(n, np.float32), np.zeros(n, np.float32)
        tr_mask[labeled[:n_tr]] = 1
        va_mask[labeled[n_tr:]] = 1
        if va_mask.sum() == 0:
            va_mask = tr_mask

        dev = self.device
        self.x = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        yt = torch.from_numpy(np.ascontiguousarray(y)).to(dev)
        trm, vam = torch.from_numpy(tr_mask).to(dev), torch.from_numpy(va_mask).to(dev)
        net = self.net = self._make_net(x.shape[1], y.shape[1])
        params = list(net.parameters())
        opt = torch.optim.Adam(params, lr=lr)
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        eval_val = early_stopping_patience > 0
        best_val, best, patience = np.inf, best_state(net), 0
        clock, losses, vals = EpochClock(dev), [], []
        self.stopped_epoch = None
        for epoch in range(max_epochs):
            clock.tick()
            opt.zero_grad(set_to_none=True)
            loss = self._kl(net(self.adj_exp, self.adj_sp, self.x, gen), yt, trm)
            loss.backward()
            clip_by_global_norm_(params, clip_grad_max_norm)
            opt.step()
            losses.append(loss.detach())
            if eval_val:
                with torch.no_grad():
                    val = round(float(self._kl(net(self.adj_exp, self.adj_sp, self.x), yt,
                                               vam)), 4)
                vals.append(val)
                if val < best_val:
                    best_val, best, patience = val, best_state(net), 1
                else:
                    patience += 1
                    if patience > early_stopping_patience:
                        self.stopped_epoch = epoch
                        logger.info("stdGCN early stop at epoch %d (val %.4f)", epoch, best_val)
                        break
            if epoch % 100 == 0:
                logger.info("stdGCN epoch %d, KL %.5f", epoch, float(loss.detach()))
        clock.tick()
        values = torch.stack(losses).cpu().tolist() if losses else []
        vals = vals or [None] * len(values)
        self.history = [{"epoch": e, "loss": l, "val": v, "seconds": s}
                        for e, (l, v, s) in enumerate(zip(values, vals, clock.seconds()))]
        if eval_val:
            net.load_state_dict(best)
        return self

    def predict(self, x=None) -> np.ndarray:
        """The portions ``exp(log_softmax)`` of every spot, in the caller's
        order (counterpart: stdgcn.py:485)."""
        with torch.no_grad():
            logp = self.net(self.adj_exp, self.adj_sp, self.x)
        return unpermute(self._perm, torch.exp(logp).cpu().numpy())



# reference tuning harnesses import the model under this name (stdgcn.py:504)
stdGCNWrapper = StdGCN


def get_idx(train_valid_len: int, test_len: int, train_valid_ratio: float = 0.9):
    """(train, valid, test) index ranges (counterpart: stdgcn.py:516)."""
    train_idx = range(int(train_valid_len * train_valid_ratio))
    valid_idx = range(len(train_idx), train_valid_len)
    return train_idx, valid_idx, range(test_len)


def full_block(in_features: int, out_features: int, p_drop: float) -> nn.Sequential:
    """Dense → LayerNorm (flax's eps 1e-6) → ELU → dropout (counterpart:
    stdgcn.py:524)."""
    return nn.Sequential(nn.Linear(in_features, out_features),
                         nn.LayerNorm(out_features, eps=1e-6), nn.ELU(), nn.Dropout(p_drop))


class autoencoder(nn.Module):
    """The spot autoencoder (counterpart: stdgcn.py:535): two
    :func:`full_block` down to the embedding and two back up; returns
    ``(embedding, reconstruction)``."""

    def __init__(self, x_size: int, hidden_size: int, embedding_size: int, p_drop: float = 0.0):
        super().__init__()
        self.encoder = nn.Sequential(full_block(x_size, hidden_size, p_drop),
                                     full_block(hidden_size, embedding_size, p_drop))
        self.decoder = nn.Sequential(full_block(embedding_size, hidden_size, p_drop),
                                     full_block(hidden_size, x_size, p_drop))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's init: ``Dense`` defaults, LayerNorm at scale 1, bias 0."""
        for layer in self.modules():
            if isinstance(layer, nn.Linear):
                flax_dense_init_(layer, generator)
            elif isinstance(layer, nn.LayerNorm):
                layer.reset_parameters()

    def forward(self, x: torch.Tensor):
        en = self.encoder(x)
        return en, self.decoder(en)


def auto_train(x, epoch_n: int = 2000, lr: float = 1e-3, latent_size: Optional[int] = None,
               p_drop: float = 0.0, seed: int = 0, device="auto") -> np.ndarray:
    """Full-batch MSE training of :class:`autoencoder` with Adam for
    ``epoch_n`` steps, returning the embedding of ``x`` (counterpart:
    stdgcn.py:560); the hidden width is the mean of the input's and the
    latent's, the latent ``min(50, genes // 2)`` by default."""
    device = resolve_device(device)
    xt = torch.as_tensor(np.asarray(x, np.float32)).to(device)
    x_size = xt.shape[1]
    latent_size = latent_size or min(50, max(1, x_size // 2))
    net = autoencoder(x_size, int((x_size + latent_size) / 2), latent_size, p_drop)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    net.to(device).train()
    opt = torch.optim.Adam(net.parameters(), lr=lr)
    for _ in range(epoch_n):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((net(xt)[1] - xt) ** 2)
        loss.backward()
        opt.step()
    net.eval()
    with torch.no_grad():
        return net(xt)[0].cpu().numpy()


def stdgcn_marker_genes(x, cell_types, gene_names, *, filter_wilcoxon_marker_genes: bool = True,
                        top_gene_per_type: int = 20,
                        pvals_adj_threshold: Optional[float] = 0.10,
                        log_fold_change_threshold: Optional[float] = 1.0,
                        min_within_group_fraction_threshold: Optional[float] = 0.7,
                        max_between_group_fraction_threshold: Optional[float] = 0.3,
                        device="auto") -> Tuple[List[str], Dict[str, List[str]]]:
    """stdGCN's marker genes of the reference cells ``x`` (log data, cells x
    genes) in types ``cell_types`` (counterpart: ``stdGCNMarkGenes``,
    stdgcn.py:603-658): Wilcoxon :func:`~dance_tpu_torch.sc.tl.rank_genes_groups`
    with BH correction and nonzero shares on ``device``; per type the genes
    ordered by adjusted p-value (ties by gene index: JAX's unstable sort
    leaves them in numpy's order), kept where the adjusted p-value is under
    ``pvals_adj_threshold``, the log fold change at least
    ``log_fold_change_threshold``, the share of the type's cells expressing
    it at least ``min_within_group_fraction_threshold`` and the other cells'
    share under ``max_between_group_fraction_threshold`` (each filter off
    when None, all off without ``filter_wilcoxon_marker_genes``), the first
    ``top_gene_per_type``. Returns ``(gene_list, gene_dict)``: the sorted
    union of the kept genes and each type's list (JAX's ``uns["gene_list"]``
    and ``uns["gene_dict"]``). The reference's ``marker_gene_method`` is not
    taken: it runs Wilcoxon whatever that option says."""
    names = np.asarray(gene_names)
    res = rank_genes_groups(x, cell_types, method="wilcoxon", pts=True, gene_names=names,
                            device=device)
    index = {name: i for i, name in enumerate(names.tolist())}
    gene_dict, gene_list = {}, []
    for name in res["names"]:
        padj = res["pvals_adj"][name]
        ranked = res["names"][name]
        order = np.lexsort((np.array([index[g] for g in ranked.tolist()]), padj))
        keep = np.ones(len(order), bool)
        if filter_wilcoxon_marker_genes:
            if pvals_adj_threshold is not None:
                keep &= padj[order] < pvals_adj_threshold
            if log_fold_change_threshold is not None:
                keep &= res["logfoldchanges"][name][order] >= log_fold_change_threshold
            if min_within_group_fraction_threshold is not None:
                keep &= res["pts"][name][order] >= min_within_group_fraction_threshold
            if max_between_group_fraction_threshold is not None:
                keep &= res["pts_rest"][name][order] < max_between_group_fraction_threshold
        sel = ranked[order][keep][:top_gene_per_type]
        gene_dict[name] = list(sel)
        gene_list = sorted(set(gene_list) | set(sel))
    return gene_list, gene_dict


class stdGCNMarkGenes:
    """The reference's transform name over :func:`stdgcn_marker_genes`: its
    keyword options at construction, ``(x, cell_types, gene_names)`` at the
    call (counterpart: stdgcn.py:603, which reads the reference split of a
    ``Data`` and writes ``uns``)."""

    def __init__(self, **kwargs):
        self.kwargs = kwargs

    def __call__(self, x, cell_types, gene_names):
        return stdgcn_marker_genes(x, cell_types, gene_names, **self.kwargs)


def stdgcn_preprocess(x_ref, ref_labels, x_spots, coords, *, n_pseudo: int = 500):
    """:meth:`StdGCN.preprocessing_pipeline` on the reference cells ``x_ref``
    (cells x genes, labelled ``ref_labels``), the spots ``x_spots`` and
    their ``coords`` wrapped in a container, for a caller that holds
    matrices. Returns :meth:`StdGCN.fit`'s ``((x, coords), y)`` in spot
    order [pseudo; real]: the marker genes' counts (float32), every spot's
    coordinates (zeros for the pseudo-spots) and the pseudo-spots' portions
    over zeros for the real spots."""
    data = deconvo_container(x_ref, ref_labels, x_spots, coords)
    StdGCN.preprocessing_pipeline(n_pseudo=n_pseudo, log_level="WARNING")(data)
    return stdgcn_inputs(data)


def stdgcn_inputs(data):
    """``((x, coords), y)`` of a container that stdGCN's pipeline ran on, in
    spot order [pseudo; real]."""
    order = spot_order(data)
    (x, coords), y = data.get_data(return_type="numpy")
    return ((np.asarray(x, np.float32)[order], np.asarray(coords, np.float32)[order]),
            np.asarray(y, np.float32)[order])


__all__ = ["A_intra_transfer", "StdGCN", "adj_normalize", "auto_train", "autoencoder",
           "build_stdgcn_adjacencies", "conGCN", "data_integration", "find_mutual_nn",
           "full_block", "get_idx", "inter_adj", "intra_dist_adj", "intra_exp_adj",
           "stdGCNMarkGenes", "stdGCNWrapper", "stdgcn_inputs", "stdgcn_marker_genes",
           "stdgcn_preprocess"]
