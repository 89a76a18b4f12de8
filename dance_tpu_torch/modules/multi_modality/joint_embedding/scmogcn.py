"""scMoGNN for joint embedding: the scMoGNN trunk over the cell-feature graph
of both modalities side by side, its cell output taken as the embedding and
supervised by a cell-type head.

Counterpart: dance_tpu/modules/multi_modality/joint_embedding/scmogcn.py
(``_JENet`` :25, ``ScMoGCNWrapper`` :46-139). The trunk is
:class:`~dance_tpu_torch.modules.multi_modality.predict_modality.scmogcn.ScMoGCN`
at ``hidden=64``, ``n_layers=2``, ``z_dim=32`` and the trunk's other
defaults. As in JAX, the trunk runs without dropout in training too: its
``deterministic`` defaults to True and ``_JENet`` never sets it, so the
dropout rates (0.3 on edges, 0.2 in the model) are unused. The head is a
linear layer on ``relu(z)``; the loss is the head's cross-entropy (with
labels) plus ``1e-4 * mean(z²)``, minimised with Adam. ``score(metric="clustering")``
clusters the embedding with k-means and gives its NMI
(:func:`~dance_tpu_torch.utils.labeled_clustering_evaluate`);
``score(metric="openproblems")`` runs the scIB suite
(:func:`~dance_tpu_torch.utils.metrics.integration_openproblems_evaluate`).

The reference-named helpers (:142-202): :func:`propagation_layer_combination`
and :func:`cell_feature_propagation` over a graph of
:func:`~dance_tpu_torch.transforms.graph.scmogcn_graph.construct_enhanced_feature_graph`.

Where this differs from the JAX package: the weights come from a CPU
``torch.Generator`` (parity tests copy the flax weights in); ``history``
records each epoch's loss and seconds.
"""

import hashlib
from typing import Dict, List, Optional

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F
from torch import nn

from dance_tpu_torch.modules.multi_modality.configs import joint_embedding_config
from dance_tpu_torch.modules.base import BaseRegressionMethod
from dance_tpu_torch.modules.multi_modality.match_modality.scmogcn import _std, _std_guarded
from dance_tpu_torch.modules.multi_modality.predict_modality.scmogcn import (
    ScMoGCN, build_hetero_graph)
from dance_tpu_torch.nn.gnn import flax_dense_init_
from dance_tpu_torch.ops.sparse import csr_from_scipy, csr_matmat
from dance_tpu_torch.settings import logger
from dance_tpu_torch.utils import EpochClock, resolve_device
from dance_tpu_torch.utils.metrics import score_embedding


class _JENet(nn.Module):
    """The trunk -> embedding ``z`` -> cell-type head (counterpart: :25)."""

    def __init__(self, z_dim: int, n_ct: int, hidden: int, n_layers: int, feature_size: int):
        super().__init__()
        self.trunk = ScMoGCN(out_size=z_dim, feature_size=feature_size, hidden_size=hidden,
                             conv_layers=n_layers)
        self.head = nn.Linear(z_dim, n_ct)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.trunk.reset_parameters(generator)
        flax_dense_init_(self.head, generator)

    def embed(self, g) -> torch.Tensor:
        return self.trunk(g)

    def forward(self, g):
        z = self.trunk(g)
        return z, self.head(torch.relu(z))


class ScMoGCNWrapper(BaseRegressionMethod):
    """scMoGNN joint embedding (counterpart: :46). ``fit(x_mod1, x_mod2,
    cell_type)`` trains on both modalities' features joined side by side;
    ``predict`` returns the cells' embedding. ``device="auto"`` is the card."""

    _DISPLAY_ATTRS = ("hidden", "n_layers")

    @staticmethod
    def preprocessing_pipeline(log_level: str = "INFO"):
        """The ``SetConfig`` of a ``MuData`` of ``mod1`` and ``mod2``: both
        modalities' ``X`` the features, mod1's ``obs["cell_type"]`` the labels
        (counterpart: scmogcn.py:60)."""
        return joint_embedding_config(log_level)

    def __init__(self, args=None, hidden: int = 64, n_layers: int = 2, z_dim: int = 32,
                 seed: int = 0, device="auto"):
        self.hidden, self.n_layers, self.z_dim, self.seed = hidden, n_layers, z_dim, seed
        self.device = resolve_device(device)
        self.net: Optional[_JENet] = None
        self.history: List[Dict[str, float]] = []  # per epoch: epoch, loss, seconds

    def _make_net(self, n_ct: int, feature_size: int) -> _JENet:
        """A new net with flax's init drawn from ``seed``, on the device."""
        net = _JENet(self.z_dim, n_ct, self.hidden, self.n_layers, feature_size)
        net.reset_parameters(torch.Generator().manual_seed(self.seed))
        return net.to(self.device)

    def fit(self, x_mod1, x_mod2, cell_type=None, epochs: int = 150, lr: float = 1e-2,
            use_bsr="auto", bsr_block: int = 128):
        """Full-graph training with Adam (counterpart: :79-121); the graph is
        kept across fits, keyed by a hash of its content."""
        x = np.concatenate([np.asarray(x_mod1), np.asarray(x_mod2)], axis=1).astype(np.float32)
        cache_key = (x.shape, str(use_bsr), bsr_block,
                     hashlib.md5(np.ascontiguousarray(x)).hexdigest())
        if getattr(self, "_graph_cache_key", None) == cache_key:
            g = self._graph_cache
        else:
            g = build_hetero_graph(x, use_bsr=use_bsr, bsr_block=bsr_block, device=self.device)
            self._graph_cache_key, self._graph_cache = cache_key, g
        has_labels = cell_type is not None
        if has_labels:
            names, ct = np.unique(np.asarray(cell_type), return_inverse=True)
            n_ct = len(names)
        else:
            ct, n_ct = np.zeros(len(x), np.int64), 1
        self.net = self._make_net(n_ct, g.n_feats)
        opt = torch.optim.Adam(self.net.parameters(), lr=lr)
        ct = torch.as_tensor(np.asarray(ct, np.int64)).to(self.device)
        clock, losses = EpochClock(self.device), []
        self.net.train()
        for _ in range(epochs):
            clock.tick()
            opt.zero_grad(set_to_none=True)
            emb, logits = self.net(g)
            loss = 1e-4 * torch.mean(emb ** 2)  # mild embedding regularisation
            if has_labels:
                loss = loss + F.cross_entropy(logits, ct)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        clock.tick()
        self.history = [{"epoch": e, "loss": float(l), "seconds": s}
                        for e, (l, s) in enumerate(zip(losses, clock.seconds()))]
        for h in self.history[::50]:
            logger.info("scMoGNN-JE epoch %d, loss %.5f", h["epoch"], h["loss"])
        self._cache = g
        return self

    def predict(self, x=None) -> np.ndarray:
        """The embedding of every cell of the last fit's graph."""
        self.net.eval()
        with torch.no_grad():
            return self.net.embed(self._cache).cpu().numpy()

    def score(self, x, y, *, score_func=None, return_pred: bool = False,
              metric: str = "clustering", batch=None, **kwargs):
        """k-means NMI of the embedding against ``y`` (``metric="clustering"``,
        counterpart: :122-135, with as many clusters as labels), or the scIB
        suite's ``final_scores`` (``metric="openproblems"``; ``batch`` and the
        suite's keyword arguments pass through, its scores and the
        embedding with ``return_pred``)."""
        return score_embedding(self.predict(), y, metric=metric, batch=batch, device=self.device,
                               return_pred=return_pred, **kwargs)


# --------------------------------------------------------------------------
# reference-named propagation helpers (counterpart: :142-202)
# --------------------------------------------------------------------------


def propagation_layer_combination(X, idx, wt, from_logits: bool = True) -> torch.Tensor:
    """The per-layer cell embeddings ``X`` at the cells ``idx``, mixed by the
    softmax of ``wt`` (its raw values with ``from_logits=False``)
    (counterpart: :142)."""
    wt = torch.as_tensor(wt)
    if from_logits:
        wt = torch.softmax(wt, -1)
    x = 0
    for i in range(wt.shape[0]):
        x = x + wt[i] * torch.as_tensor(X[i])[idx]
    return x


def cell_feature_propagation(g, alpha: float = 0.5, beta: float = 0.5,
                             cell_init: Optional[str] = None, feature_init: Optional[str] = "id",
                             device="auto", layers: int = 3) -> List[torch.Tensor]:
    """Alternating cell <-> feature propagation over ``g``, a graph of
    :func:`~dance_tpu_torch.transforms.graph.scmogcn_graph.construct_enhanced_feature_graph`
    (features first), with a global standardisation (ddof 0, as ``jnp.std``)
    after every product and every mix (counterpart: :153). Features start
    one-hot (``"id"``) or at zero (None), cells at zero or at
    ``info["cell_node_features"]`` (any ``cell_init``). Returns the cell
    embeddings of layers 2 .. ``layers`` on ``device`` (the card unless the
    CPU is named)."""
    device = resolve_device(device)
    n_feat, n_cell = int(g.info["num_genes"]), int(g.info["num_cells"])
    adj = sp.csr_matrix(g.adj)
    a_cf = csr_from_scipy(adj[n_feat:, :n_feat]).to(device)  # cell <- feature
    a_fc = csr_from_scipy(adj[:n_feat, n_feat:]).to(device)  # feature <- cell
    if feature_init is None:
        width = np.asarray(g.info["cell_node_features"]).shape[1]
        feature_x = torch.zeros((n_feat, width), device=device)
    elif feature_init == "id":
        feature_x = torch.eye(n_feat, device=device)
    else:
        raise NotImplementedError(f"Not implemented feature init feature {feature_init}.")
    if cell_init is None:
        cell_x = torch.zeros((n_cell, feature_x.shape[1]), device=device)
    else:
        cell_x = torch.from_numpy(np.asarray(g.info["cell_node_features"], np.float32)).to(device)
    h_feature, h_cell = feature_x, cell_x
    hcell = []
    for _ in range(layers):
        h1_feature = _std_guarded(csr_matmat(a_fc, h_cell))
        h1_cell = _std_guarded(csr_matmat(a_cf, h_feature))
        h_feature = _std(h_feature * alpha + h1_feature * (1 - alpha))
        h_cell = _std(h_cell * beta + h1_cell * (1 - beta))
        hcell.append(h_cell)
    return hcell[1:]


__all__ = ["ScMoGCNWrapper", "cell_feature_propagation", "propagation_layer_combination"]
