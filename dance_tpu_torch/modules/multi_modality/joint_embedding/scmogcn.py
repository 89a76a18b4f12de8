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

Where this differs from the JAX package: the weights come from a CPU
``torch.Generator`` (parity tests copy the flax weights in); ``history``
records each epoch's loss and seconds. Not ported yet (ROADMAP Queue 1):
the reference-named propagation helpers (:142-202).
"""

import hashlib
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dance_tpu_torch.modules.base import BaseRegressionMethod
from dance_tpu_torch.modules.multi_modality.predict_modality.scmogcn import (
    ScMoGCN, build_hetero_graph)
from dance_tpu_torch.nn.gnn import flax_dense_init_
from dance_tpu_torch.settings import logger
from dance_tpu_torch.utils import EpochClock, labeled_clustering_evaluate, resolve_device
from dance_tpu_torch.utils.metrics import integration_openproblems_evaluate


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
        emb = self.predict()
        y = np.asarray(y)
        if metric == "openproblems":
            scores = integration_openproblems_evaluate(emb, y, batch, device=self.device,
                                                       **kwargs)
            return (scores, emb) if return_pred else scores["final_scores"]
        scores = labeled_clustering_evaluate(emb, y, n_clusters=len(np.unique(y)),
                                             device=self.device)
        return (scores, emb) if return_pred else scores["dance_nmi"]


__all__ = ["ScMoGCNWrapper"]
