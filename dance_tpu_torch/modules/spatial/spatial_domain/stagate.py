"""STAGATE: a graph-attention autoencoder for spatial domains.

Counterpart: dance_tpu/modules/spatial/spatial_domain/stagate.py (``_StagateNet``
:57-87, ``Stagate`` :90-183, ``preprocessing_pipeline`` :104-118). Full-graph
training: every epoch is one forward/backward of the whole spot graph and one
clipped AdamW step. With ``use_bsr=True`` the graph is banded by an RCM
reordering and tiled, and each of the two attention aggregations per pass is
one fused GAT (:func:`~dance_tpu_torch.ops.bsr.bsr_gat_ad`): on the card the
hand-written CUDA forward-with-stats kernel forward, the flash backward
kernel backward, and the primal forward kernel for the final embedding.
``use_bsr="auto"`` (the default, as in JAX) decides BSR or CSR by
:func:`~dance_tpu_torch.ops.bsr.resolve_use_bsr` on the graph with its
self-loops; CSR off the card.

Where this differs from the JAX package:

- optax's ``clip_by_global_norm`` is written out
  (:func:`~dance_tpu_torch.utils.optim.clip_by_global_norm_`): it scales by
  ``max / norm`` only when ``norm >= max``, where
  ``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` always.
  ``torch.optim.AdamW`` is ``optax.adamw``'s math (decoupled decay, eps
  outside the square root).
- ``fit`` records each epoch's loss and seconds in ``history``; the JAX
  ``fit`` logs every 100th loss.
- Weights are drawn from a ``torch.Generator`` seeded with ``seed``, not from
  ``jax.random``; parity tests copy the flax weights in
  (:func:`dance_tpu_torch.utils.params.stagate_flax_to_torch`).
- :func:`stagate_preprocess` is the array front of
  ``preprocessing_pipeline``: it runs the pipeline on a matrix and
  coordinates wrapped in a ``Data``.

``Stagate`` takes ``pretrain_path`` and the ``BasePretrain`` mixin, as the
JAX class does (stagate.py:90-99); as there, ``fit`` does not pretrain.
"""

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from dance_tpu_torch.data import AnnData, Data
from dance_tpu_torch.modules.base import BaseClusteringMethod, BasePretrain
from dance_tpu_torch.ops.bsr import (BSRMatrix, bsr_from_scipy, bsr_gat_ad, rcm_reorder,
                                     resolve_use_bsr, unpermute)
from dance_tpu_torch.ops.cluster import kmeans
from dance_tpu_torch.ops.segment import aggregate, edge_softmax, gather_dst, gather_src
from dance_tpu_torch.ops.sparse import csr_from_scipy
from dance_tpu_torch.settings import logger
from dance_tpu_torch.transforms.graph import StagateGraph
from dance_tpu_torch.transforms.interface import AnnDataTransform
from dance_tpu_torch.transforms.misc import Compose, SetConfig
from dance_tpu_torch.utils import resolve_device
from dance_tpu_torch.utils.optim import clip_by_global_norm_


def _edge_attention(adj, feat, attn_src, attn_dst) -> torch.Tensor:
    """Per-edge ``softmax_dst(sigmoid(att_src·f[src] + att_dst·f[dst]))``
    (counterpart: stagate.py:28)."""
    el = (feat * attn_src).sum(-1)
    er = (feat * attn_dst).sum(-1)
    logits = torch.sigmoid(gather_src(adj, el) + gather_dst(adj, er))
    return edge_softmax(adj, logits)


def _fused_gat(adj: BSRMatrix, feat_logits, attn_src, attn_dst, h) -> torch.Tensor:
    """Fused sigmoid-attention GAT over the BSR tiles (counterpart:
    stagate.py:40): logits from ``feat_logits``, messages from ``h``."""
    el = (feat_logits * attn_src).sum(-1)
    er = (feat_logits * attn_dst).sum(-1)
    return bsr_gat_ad(adj, er, el, h, act="sigmoid")[:h.shape[0]]


def _att_aggregate(adj, feat, att) -> torch.Tensor:
    return aggregate(adj, gather_src(adj, feat) * att[:, None], op="sum")


class StagateNet(nn.Module):
    """The GAT autoencoder with STAGATE's tied dataflow (counterpart:
    ``_StagateNet``, stagate.py:57): ``h1 = elu(GAT(x W1))`` with sigmoid
    attention; ``z = h1 W2`` without propagation; ``h3 = elu(GAT(z W2ᵀ))``
    reusing layer 1's attention; ``x̂ = h3 W1ᵀ``. Returns ``(z, x̂)``."""

    def __init__(self, hidden_dims: Tuple[int, int, int]):
        super().__init__()
        in_dim, h_dim, z_dim = hidden_dims
        self.w1 = nn.Parameter(torch.empty(in_dim, h_dim))
        self.w2 = nn.Parameter(torch.empty(h_dim, z_dim))
        self.a1l = nn.Parameter(torch.empty(1, h_dim))
        self.a1r = nn.Parameter(torch.empty(1, h_dim))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's glorot-uniform on every parameter (symmetric in fan-in and
        fan-out, so torch's xavier-uniform draws from the same range)."""
        for p in (self.w1, self.w2, self.a1l, self.a1r):
            nn.init.xavier_uniform_(p, generator=generator)

    def forward(self, adj, x: torch.Tensor):
        f1 = x @ self.w1
        if isinstance(adj, BSRMatrix):
            h1 = nn.functional.elu(_fused_gat(adj, f1, self.a1l, self.a1r, f1))
            z = h1 @ self.w2
            h3 = nn.functional.elu(_fused_gat(adj, f1, self.a1l, self.a1r, z @ self.w2.T))
            return z, h3 @ self.w1.T
        att1 = _edge_attention(adj, f1, self.a1l, self.a1r)
        h1 = nn.functional.elu(_att_aggregate(adj, f1, att1))
        z = h1 @ self.w2
        h3 = nn.functional.elu(_att_aggregate(adj, z @ self.w2.T, att1))
        return z, h3 @ self.w1.T


class Stagate(BasePretrain, BaseClusteringMethod):
    """STAGATE (counterpart: stagate.py:90). ``fit((x, adj))`` trains on
    spots x genes features ``x`` and the spot graph ``adj``; ``predict``
    clusters the embedding with k-means."""

    _DISPLAY_ATTRS = ("hidden_dims",)

    def __init__(self, hidden_dims: Tuple[int, ...] = (3000, 512, 30), device="auto",
                 pretrain_path: Optional[str] = None, seed: int = 0):
        self.hidden_dims = tuple(hidden_dims)
        self.pretrain_path = pretrain_path
        self.seed = seed
        self.device = resolve_device(device)
        self.net = StagateNet(self.hidden_dims)
        self.net.reset_parameters(torch.Generator().manual_seed(seed))
        self.net.to(self.device)
        self.history: List[Dict[str, float]] = []  # per epoch: epoch, loss, seconds

    @staticmethod
    def preprocessing_pipeline(n_top_genes: int = 3000, model_name: str = "radius",
                               radius: float = 150, n_neighbors: int = 5, log_level: str = "INFO",
                               device="auto") -> Compose:
        """STAGATE's preprocessing of a ``Data`` (:func:`stagate_preprocess`
        runs it on arrays): seurat_v3 HVGs of the raw counts,
        ``normalize_total(1e4)``, ``log1p``, the spatial graph of
        ``obsm["spatial_pixel"]`` into ``obsp["StagateGraph"]``; features
        ``[X, obsp["StagateGraph"]]``, labels ``obs["label"]`` (counterpart:
        stagate.py:105). Every step is host work; ``device`` is only checked
        (the card unless the CPU is named), as for every entry point."""
        resolve_device(device)
        return Compose(
            AnnDataTransform("sc.pp.highly_variable_genes", flavor="seurat_v3",
                             n_top_genes=n_top_genes, subset=True),
            AnnDataTransform("sc.pp.normalize_total", target_sum=1e4),
            AnnDataTransform("sc.pp.log1p"),
            StagateGraph(model_name, radius=radius, n_neighbors=n_neighbors),
            SetConfig({"feature_channel": [None, "StagateGraph"],
                       "feature_channel_type": ["X", "obsp"],
                       "label_channel": "label", "label_channel_type": "obs"}),
            log_level=log_level,
        )

    def fit(self, inputs, y=None, *, epochs: int = 500, lr: float = 1e-3,
            gradient_clipping: float = 5.0, weight_decay: float = 1e-4, n_clusters: int = 7,
            use_bsr="auto", bsr_block: int = 128):
        """Train from the current weights (counterpart: stagate.py:130). The
        graph gains self-loops; with ``use_bsr=True`` it is RCM-reordered and
        tiled, and the embedding ``z`` is put back in the input order."""
        x, adj = inputs
        x = np.asarray(x, dtype=np.float32)
        adj = sp.csr_matrix(adj) + sp.eye(adj.shape[0], format="csr", dtype=np.float32)
        use_bsr = resolve_use_bsr(use_bsr, adj, bsr_block, device=self.device)
        self._perm = None
        if use_bsr:
            perm, adj = rcm_reorder(adj)
            x = x[perm]
            self._perm = np.asarray(perm)
            self.adj = bsr_from_scipy(adj, block=bsr_block).to(self.device)
        else:
            self.adj = csr_from_scipy(adj).to(self.device)
        self.n_clusters = n_clusters
        xt = torch.from_numpy(x).to(self.device)
        params = list(self.net.parameters())
        opt = torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay)
        self.net.train()
        self.history = []
        for epoch in range(epochs):
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            _, x_hat = self.net(self.adj, xt)
            loss = torch.mean((xt - x_hat) ** 2)
            loss.backward()
            clip_by_global_norm_(params, gradient_clipping)
            opt.step()
            self.history.append({"epoch": epoch, "loss": float(loss.detach()),
                                 "seconds": time.perf_counter() - t0})
            if epoch % 100 == 0:
                logger.info("STAGATE epoch %d, MSE %.6f", epoch, self.history[-1]["loss"])
        self.net.eval()
        with torch.no_grad():
            z, _ = self.net(self.adj, xt)
        self.z = unpermute(self._perm, z.cpu().numpy())
        return self

    def predict(self, x=None) -> np.ndarray:
        """k-means of the embedding, best of 10 restarts (counterpart: stagate.py:177)."""
        return kmeans(self.z, self.n_clusters, n_init=10, seed=self.seed,
                      device=self.device).labels.cpu().numpy()

    def get_latent(self) -> np.ndarray:
        return self.z


def stagate_preprocess(counts, xy, *, n_top_genes: int = 3000, model_name: str = "radius",
                       radius: float = 150, n_neighbors: int = 5):
    """:meth:`Stagate.preprocessing_pipeline` on raw ``counts`` (spots x
    genes) and their coordinates ``xy`` wrapped in a ``Data``, for a caller
    that holds arrays: seurat_v3 HVGs of the counts kept, then
    ``normalize_total(1e4)`` and ``log1p``, and the spatial graph of ``xy``.
    Every step is host numpy, so the pipeline is built for the CPU. Returns
    ``(x, adj)``: dense float32 features and the scipy CSR graph, the input
    of :meth:`Stagate.fit`."""
    adata = AnnData(counts)
    adata.obsm["spatial_pixel"] = np.asarray(xy)
    data = Data(adata)
    Stagate.preprocessing_pipeline(n_top_genes=n_top_genes, model_name=model_name,
                                   radius=radius, n_neighbors=n_neighbors, log_level="WARNING",
                                   device="cpu")(data)
    x = data.data.X
    x = np.asarray(x.toarray() if sp.issparse(x) else x, np.float32)
    return x, data.data.obsp["StagateGraph"]


__all__ = ["Stagate", "StagateNet", "stagate_preprocess"]
