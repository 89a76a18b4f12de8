"""scTAG: a topology-adaptive graph-convolution ZINB autoencoder with a DEC
clustering stage.

Counterpart: dance_tpu/modules/single_modality/clustering/sctag.py
(``_ScTAGNet`` :32-63, ``ScTAG`` :66-273, ``preprocessing_pipeline``
:89-112). Two :class:`~dance_tpu_torch.nn.gnn.TAGConv` encoders run on the
symmetric-normalised cell kNN graph (self-loops added); the decoders are an
inner product over the latent (the adjacency) and an MLP with the three ZINB
heads. Pretraining minimises ``w_a`` x the BCE of ``z zᵀ`` against the graph's
pattern plus ``w_x`` x the ZINB loss (plus ``w_d`` x a latent distance
barrier); the DEC stage adds ``w_c`` x KL(p || q) around k-means centres of
the pretrained latent. With ``use_bsr=True`` the graph is RCM-banded and every
TAGConv hop is one block-sparse SpMM (the CUDA kernel on the card, forward and
``Aᵀḡ`` backward); ``q`` and ``z`` are put back in the input order.
``use_bsr="auto"`` (the default, as in JAX) decides BSR or CSR by
:func:`~dance_tpu_torch.ops.bsr.resolve_use_bsr` on the kNN graph; CSR off
the card.

Where this differs from the JAX package:

- An epoch encodes once. JAX encodes twice with the same parameters (the
  pre-update ``z``, ``q`` and ``p``, then the loss forward) and prunes the
  unused ``sigmoid(z zᵀ)``; here the pre-update values are the loss forward's
  ``z`` detached, the same numbers, and the training step never forms the
  n x n sigmoid (``_ScTAGNet.forward`` still returns it, as the flax module).
- A later ``fit`` on another graph trains on that graph; JAX builds the
  adjacency once, at the first fit, and keeps it. The net is built before the
  pretrain, so that a pretrained ``state_dict`` can be loaded from
  ``pretrain_path`` (JAX's load path leaves no net to encode with).
- ``dropout`` is stored and never applied, as in JAX (sctag.py:38).
- Weights are drawn from a CPU ``torch.Generator`` seeded with ``seed`` and
  k-means is the port's; parity tests copy the flax weights in
  (:func:`dance_tpu_torch.utils.params.sctag_flax_to_torch`) and set the
  centres from the JAX run.
- ``history`` and ``pretrain_history`` record each epoch's loss and seconds
  (:class:`~dance_tpu_torch.utils.EpochClock`, read once after each stage).
- :func:`sctag_preprocess` is the array front of ``preprocessing_pipeline``:
  it runs the pipeline on a matrix wrapped in a ``Data``.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from dance_tpu_torch.modules.base import BaseClusteringMethod, NNPretrain, wrap_matrix
from dance_tpu_torch.nn.gnn import TAGConv, flax_dense_init_
from dance_tpu_torch.nn.zinb_ae import disp_act, mean_act
from dance_tpu_torch.ops.bsr import bsr_from_scipy, rcm_reorder, resolve_use_bsr, unpermute
from dance_tpu_torch.ops.cluster import kmeans
from dance_tpu_torch.ops.sparse import csr_from_scipy, sym_norm_adjacency
from dance_tpu_torch.settings import logger
from dance_tpu_torch.transforms.cell_feature import CellPCA
from dance_tpu_torch.transforms.graph import NeighborGraph
from dance_tpu_torch.transforms.interface import AnnDataTransform
from dance_tpu_torch.transforms.misc import Compose, SaveRaw, SetConfig
from dance_tpu_torch.utils import EpochClock, ari, resolve_device
from dance_tpu_torch.utils.loss import (binary_ce_logits, cluster_kl_loss, dist_loss,
                                        soft_assign, target_distribution, zinb_nll)

def _dense_pattern(adj: sp.csr_matrix, device) -> torch.Tensor:
    """``(adj > 0)`` as a dense float32 matrix, built on ``device`` from the
    entries' coordinates."""
    coo = adj.tocoo()
    pos = coo.data > 0
    out = torch.zeros(adj.shape, dtype=torch.float32, device=device)
    out[torch.from_numpy(coo.row[pos]).long().to(device),
        torch.from_numpy(coo.col[pos]).long().to(device)] = 1.0
    return out


class _ScTAGNet(nn.Module):
    """Two TAGConv encoders, the inner-product adjacency decoder and an MLP
    ZINB decoder (counterpart: sctag.py:32). flax infers the input width;
    torch takes it as ``in_dim``. ``dropout`` is kept and not applied, as in
    JAX."""

    def __init__(self, in_dim: int, hidden_dim: int, latent_dim: int,
                 dec_dims: Sequence[int], k: int, dropout: float):
        super().__init__()
        self.dropout = dropout
        self.encoder1 = TAGConv(in_dim, hidden_dim, k=k)
        self.encoder2 = TAGConv(hidden_dim, latent_dim, k=k)
        widths = [latent_dim, *dec_dims]
        self.dec_stack = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.dec_mean = nn.Linear(widths[-1], in_dim)
        self.dec_disp = nn.Linear(widths[-1], in_dim)
        self.dec_pi = nn.Linear(widths[-1], in_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax ``Dense``'s default init for every layer."""
        self.encoder1.reset_parameters(generator)
        self.encoder2.reset_parameters(generator)
        for layer in (*self.dec_stack, self.dec_mean, self.dec_disp, self.dec_pi):
            flax_dense_init_(layer, generator)

    def encode(self, adj, x: torch.Tensor) -> torch.Tensor:
        return self.encoder2(adj, torch.relu(self.encoder1(adj, x)))

    def decode(self, z: torch.Tensor):
        h = z
        for layer in self.dec_stack:
            h = torch.relu(layer(h))
        return mean_act(self.dec_mean(h)), disp_act(self.dec_disp(h)), torch.sigmoid(self.dec_pi(h))

    def forward(self, adj, x: torch.Tensor):
        """``(z, sigmoid(z zᵀ), mean, disp, pi)``, as the flax module returns
        them; training does not call it (the n x n sigmoid is unused)."""
        z = self.encode(adj, x)
        return (z, torch.sigmoid(z @ z.T), *self.decode(z))


class ScTAG(NNPretrain, BaseClusteringMethod):
    """scTAG (counterpart: sctag.py:66). ``fit((adj, x, x_raw, n_counts), y)``
    trains on the cell graph ``adj``, the features ``x``, the counts the ZINB
    loss scores ``x_raw`` and the library sizes ``n_counts`` (the output of
    :func:`sctag_preprocess`); ``predict`` is the argmax of ``q``."""

    _DISPLAY_ATTRS = ("n_clusters", "k", "hidden_dim", "latent_dim")
    _MODULE_ATTR = "net"

    def __init__(self, n_clusters: int, k: int = 3, hidden_dim: int = 128, latent_dim: int = 15,
                 dec_dim: Optional[Sequence[int]] = None, dropout: float = 0.2, device="auto",
                 alpha: float = 1.0, pretrain_path: Optional[str] = None, seed: int = 0):
        super().__init__()
        self.n_clusters, self.k = n_clusters, k
        self.hidden_dim, self.latent_dim = hidden_dim, latent_dim
        self.dec_dim = tuple(dec_dim or (128, 256, 512))
        self.dropout, self.alpha = dropout, alpha
        self.pretrain_path, self.seed = pretrain_path, seed
        self.device = resolve_device(device)
        self.net: Optional[_ScTAGNet] = None
        self.mu: Optional[torch.Tensor] = None
        self.q: Optional[np.ndarray] = None
        self.z: Optional[np.ndarray] = None
        self.history: List[Dict[str, float]] = []           # DEC epochs: epoch, loss, seconds
        self.pretrain_history: List[Dict[str, float]] = []  # pretrain epochs, the same

    def _set_graph(self, adj, use_bsr: bool, bsr_block: int):
        """The encoders' adjacency (BSR tiles or CSR of the normalised graph)
        and the reconstruction target ``(A + I) > 0``, on the device
        (counterpart: sctag.py:114-125)."""
        adj, adj_n = sym_norm_adjacency(adj)
        self.adj_n = (bsr_from_scipy(adj_n, block=bsr_block) if use_bsr
                      else csr_from_scipy(adj_n)).to(self.device)
        self.adj_dense = _dense_pattern(adj, self.device)

    def _init_net(self, in_dim: int):
        """A new net with flax's init drawn from ``seed``."""
        self.net = _ScTAGNet(in_dim, self.hidden_dim, self.latent_dim, self.dec_dim, self.k,
                             self.dropout)
        self.net.reset_parameters(torch.Generator().manual_seed(self.seed))
        self.net.to(self.device)

    def init_model(self, adj, x, *, use_bsr: bool = True, bsr_block: int = 128):
        """The graph (:meth:`_set_graph`) and a new net (counterpart: sctag.py:114)."""
        self._set_graph(adj, use_bsr, bsr_block)
        self._init_net(x.shape[1])

    def _tensors(self, x, x_raw, n_counts):
        dev = self.device
        n_counts = np.asarray(n_counts)
        sf = torch.from_numpy(np.asarray(n_counts / np.median(n_counts), np.float32)).to(dev)
        return (torch.from_numpy(np.asarray(x, np.float32)).to(dev),
                torch.from_numpy(np.asarray(x_raw, np.float32)).to(dev), sf)

    def _run(self, opt, x, x_raw, sf, w_a, w_x, w_c, w_d, min_dist, max_dist, epochs: int,
             collect_q: bool):
        """One training stage (counterpart: ``_run``, sctag.py:132-182): per
        epoch encode, take the pre-update ``q`` and the target ``p`` (DEC
        stage, ``self.mu`` set), one Adam step on the joint loss. Returns the
        history, the pre-update ``q`` of every epoch when ``collect_q`` (on the
        device), and the last epoch's pre-update ``q`` and ``z``."""
        use_cluster = w_c is not None
        clock, losses, qs = EpochClock(self.device), [], []
        q_pre = z_pre = None
        for _ in range(epochs):
            clock.tick()
            opt.zero_grad(set_to_none=True)
            z = self.net.encode(self.adj_n, x)
            z_pre = z.detach()
            mean, disp, pi = self.net.decode(z)
            # the adjacency BCE from the raw logits, one softplus an element
            loss = (w_a * binary_ce_logits(z @ z.T, self.adj_dense)
                    + w_x * zinb_nll(x_raw, mean, disp, pi, scale_factor=sf[:, None]))
            if w_d > 0:  # the O(n²) pairwise term only when it is weighted
                loss = loss + w_d * dist_loss(z, min_dist, max_dist)
            if use_cluster:
                q_pre = soft_assign(z_pre, self.mu.detach(), self.alpha)
                p = target_distribution(q_pre)
                loss = loss + w_c * cluster_kl_loss(p, soft_assign(z, self.mu, self.alpha))
                if collect_q:
                    qs.append(q_pre)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        clock.tick()
        history = [{"epoch": e, "loss": float(l), "seconds": s}
                   for e, (l, s) in enumerate(zip(losses, clock.seconds()))]
        return history, qs, q_pre, z_pre

    def pretrain(self, adj, x, x_raw, n_counts, *, epochs: int = 1000, info_step: int = 10,
                 lr: float = 5e-4, w_a: float = 0.3, w_x: float = 1.0, w_d: float = 0.0,
                 min_dist: float = 0.5, max_dist: float = 20.0):
        """The autoencoder stage without the clustering term (counterpart:
        sctag.py:188), from the current weights with a new Adam."""
        if self.net is None:
            self.init_model(adj, x)
        x, x_raw, sf = self._tensors(x, x_raw, n_counts)
        opt = torch.optim.Adam(self.net.parameters(), lr=lr)
        self.pretrain_history, _, _, _ = self._run(opt, x, x_raw, sf, w_a, w_x, None, w_d,
                                                   min_dist, max_dist, epochs, False)
        for h in self.pretrain_history[::max(info_step * 10, 1)]:
            logger.info("Pretrain epoch %d, loss %.6f", h["epoch"], h["loss"])

    @staticmethod
    def preprocessing_pipeline(n_top_genes: int = 3000, n_components: int = 50,
                               n_neighbors: int = 15, log_level: str = "INFO",
                               device="auto") -> Compose:
        """scTAG's preprocessing of a ``Data`` (:func:`sctag_preprocess` runs it
        on a matrix): :func:`count_steps`, the ``n_components``-d cell PCA of
        the scaled matrix (on ``device``: the card unless the CPU is named)
        and the ``n_neighbors``-NN graph of it into ``obsp["NeighborGraph"]``;
        ``get_train_data`` gives :meth:`fit`'s inputs and the labels in
        ``obsm["Group"]`` (counterpart: sctag.py:89-112)."""
        device = resolve_device(device)
        return Compose(
            *count_steps(n_top_genes),
            CellPCA(n_components=n_components, device=device),
            NeighborGraph(n_neighbors=n_neighbors, n_pcs=n_components),
            SetConfig(ZINB_CONFIG),
            log_level=log_level,
        )

    def fit(self, inputs: Tuple, y=None, *, epochs: int = 300, pretrain_epochs: int = 200,
            lr: float = 5e-4, w_a: float = 0.3, w_x: float = 1.0, w_c: float = 1.5,
            w_d: float = 0.0, info_step: int = 1, max_dist: float = 20.0,
            min_dist: float = 0.5, force_pretrain: bool = False, use_bsr="auto",
            bsr_block: int = 128):
        """Pretrain (or load, or skip; :meth:`_pretrain`), k-means centres of
        the latent (20 restarts), then the DEC stage from a new Adam
        (counterpart: sctag.py:209-267). With labels ``y``, ``q`` is the
        pre-update assignment of the epoch whose argmax has the best ARI (the
        first best), read back once after the stage; otherwise the last
        epoch's. ``z`` is the last epoch's pre-update latent. ``info_step`` is
        unused, as in JAX."""
        adj, x, x_raw, n_counts = inputs
        use_bsr = resolve_use_bsr(use_bsr, sp.csr_matrix(adj), bsr_block, device=self.device)
        x, x_raw, n_counts = (np.asarray(a.toarray() if sp.issparse(a) else a)
                              for a in (x, x_raw, n_counts))
        self._perm = None
        if use_bsr:
            perm, adj = rcm_reorder(sp.csr_matrix(adj))
            self._perm = np.asarray(perm)
            x, x_raw, n_counts = x[perm], x_raw[perm], n_counts[perm]
        self._set_graph(adj, use_bsr, bsr_block)
        if self.net is None:
            self._init_net(x.shape[1])
        self._pretrain(adj, x, x_raw, n_counts, epochs=pretrain_epochs, lr=lr, w_a=w_a,
                       w_x=w_x, w_d=w_d, min_dist=min_dist, max_dist=max_dist,
                       force_pretrain=force_pretrain)
        xt, xrt, sf = self._tensors(x, x_raw, n_counts)
        with torch.no_grad():
            latent = self.net.encode(self.adj_n, xt)
        self.mu = kmeans(latent, self.n_clusters, n_init=20, seed=self.seed).centers \
            .detach().clone().requires_grad_(True)
        opt = torch.optim.Adam([*self.net.parameters(), self.mu], lr=lr)
        self.history, qs, q, z = self._run(opt, xt, xrt, sf, w_a, w_x, w_c, w_d, min_dist,
                                           max_dist, epochs, y is not None)
        if q is None:  # no DEC epoch: JAX's zero carry
            q = xt.new_zeros((xt.shape[0], self.n_clusters))
            z = xt.new_zeros((xt.shape[0], self.latent_dim))
        if qs:
            # the ARI of every epoch, on the permuted order (labels permuted to match)
            y_cmp = np.asarray(y).ravel()
            y_cmp = y_cmp[self._perm] if self._perm is not None else y_cmp
            labels = torch.stack([qe.argmax(1) for qe in qs]).cpu().numpy()
            aris = [ari(y_cmp, lab) for lab in labels]
            q = qs[int(np.argmax(aris))]
        self.q = unpermute(self._perm, q.cpu().numpy())
        self.z = unpermute(self._perm, z.cpu().numpy())
        return self

    def predict_proba(self, x=None) -> np.ndarray:
        return np.asarray(self.q)

    def predict(self, x=None) -> np.ndarray:
        return np.asarray(self.q).argmax(1)


# the channels of scTAG's and scDSC's fit inputs, and their labels
ZINB_CONFIG = {"feature_channel": ["NeighborGraph", None, None, "n_counts"],
               "feature_channel_type": ["obsp", "X", "raw_X", "obs"], "label_channel": "Group"}


def count_steps(n_top_genes: int) -> list:
    """The count processing scTAG's and scDSC's pipelines share
    (sctag.py:93-105, scdsc.py:131-143): genes under 3 counts and cells
    without counts dropped, ``normalize_per_cell``, ``log1p``, the
    ``n_top_genes`` cell_ranger HVGs kept, genes and cells without counts
    dropped; that matrix is the ZINB target (``SaveRaw``), and the features
    are it after ``normalize_total``, ``log1p`` and ``scale``."""
    return [AnnDataTransform("sc.pp.filter_genes", min_counts=3),
            AnnDataTransform("sc.pp.filter_cells", min_counts=1),
            AnnDataTransform("sc.pp.normalize_per_cell"),
            AnnDataTransform("sc.pp.log1p"),
            AnnDataTransform("sc.pp.highly_variable_genes", min_mean=0.0125, max_mean=4,
                             flavor="cell_ranger", min_disp=0.5, n_top_genes=n_top_genes,
                             subset=True),
            AnnDataTransform("sc.pp.filter_genes", min_counts=1),
            AnnDataTransform("sc.pp.filter_cells", min_counts=1),
            SaveRaw(),
            AnnDataTransform("sc.pp.normalize_total"),
            AnnDataTransform("sc.pp.log1p"),
            AnnDataTransform("sc.pp.scale")]


def zinb_inputs(data) -> tuple:
    """``(adj, x, x_raw, n_counts)`` of a ``Data`` that scTAG's or scDSC's
    pipeline ran on: the graph as stored (CSR; ``get_train_data`` reads an
    ``obsp`` graph back dense, as JAX's does), the dense float32 features
    and ZINB target, and the cells' totals as the last ``filter_cells``
    wrote them."""
    adata = data.data
    raw = adata.raw.X
    x_raw = np.asarray(raw.toarray() if sp.issparse(raw) else raw, np.float32)
    return (adata.obsp["NeighborGraph"], np.asarray(adata.X), x_raw,
            np.asarray(adata.obs["n_counts"]))


def sctag_preprocess(counts, *, n_top_genes: int = 3000, n_components: int = 50,
                     n_neighbors: int = 15, device="auto"):
    """:meth:`ScTAG.preprocessing_pipeline` on raw ``counts`` (cells x genes,
    numpy or scipy, taken as float32) wrapped in a ``Data``, for a caller
    that holds a matrix. Returns ``((adj, x, x_raw, n_counts), cells)``: the
    input of :meth:`ScTAG.fit` (:func:`zinb_inputs`) and the indices of the
    kept cells, so that labels can follow them."""
    data = wrap_matrix(counts)
    ScTAG.preprocessing_pipeline(n_top_genes=n_top_genes, n_components=n_components,
                                 n_neighbors=n_neighbors, log_level="WARNING",
                                 device=device)(data)
    return zinb_inputs(data), np.asarray(data.data.obs_names).astype(np.int64)


__all__ = ["ScTAG", "ZINB_CONFIG", "count_steps", "sctag_preprocess",
           "zinb_inputs"]
