"""scMoGNN v2 for joint embedding: the scMoGNN trunk over the cell-feature
graph of both modalities side by side, encode only, with a structured
latent. Columns [0, ct_dim) form a cell-type space, supervised by a
cross-entropy head and a cell-cycle phase head; columns [shared_start, -2)
a shared space. The decoder reconstructs both modalities' values from
``[emb[:, :ct_dim], emb[:, shared_start:-2], one_hot(batch)]``. The joint
embedding is ``[emb[:, :ct_dim], emb[:, shared_start:-2]]``.

Counterpart: dance_tpu/modules/multi_modality/joint_embedding/scmogcnv2.py
(``propagation_layer_combination`` :39, ``_ScMoGCNv2Net`` :51-110, the step
``_v2_epoch_steps`` :113-151, the fit ``_v2_train_run`` :154-219, the
validation ``_v2_val_loss`` :222-227, ``ScMoGCNWrapperV2`` :230-380 and the
alias ``ScMoGCNWrapper`` :384). The graph is built with
``use_bsr="no_bsr"``: dense or CSR, never the BSR kernel. Training runs on
cell minibatches: each epoch a permutation of the training cells cut to
``n_steps · batch_size`` (``n_steps = len(train) // batch_size``; at the
defaults one step, and 4,000 of 9,000 cells go unused), each step on the
dense block of its cells and of features drawn by degree without
replacement (``node_sampling_rate`` of them), its degrees counted from its
nonzeros, against the full graph's values. The loss is ``0.5 · MSE₁ + 0.5 ·
MSE₂ + CE + MSE_phase`` (:138-143); AdamW with decay 1e-5 on every weight;
the learning rate starts at 1e-2 and is multiplied by ``lr_decay`` after
every epoch past 150. After each epoch ``sqrt(0.5 · MSE₁ + 0.5 · MSE₂)`` of
the full graph's forward at the validation cells (10 % of a permutation
from numpy's ``default_rng(seed)``; every cell below 10 cells) selects the
best weights (strictly lower) and stops the fit once ``epoch >
early_stopping`` and ``epoch - best_epoch >= early_stopping``.

Where this differs from the JAX package:

- Features are drawn by Gumbel top-k on ``log(max(deg / Σdeg, 1e-20))``, as
  JAX draws them (:167-172), from a CPU ``torch.Generator``: weighted
  sampling without replacement in which a feature of zero degree can still
  be drawn (numpy's ``choice(replace=False, p=...)``, which the prediction
  model's sampled fit uses, raises when fewer features than the sample have
  a nonzero degree). The cells' permutation comes from another CPU
  generator, the dropout masks from one on the device, the weights from a
  CPU generator seeded with ``seed``. Parity tests copy the flax weights in
  (:func:`dance_tpu_torch.utils.params.scmogcn_v2_flax_to_torch`) and hold
  :func:`v2_loss` and :func:`v2_val_loss` against JAX's step functions on
  JAX's own cell and feature indices.
- The net's dropout rates are the wrapper's ``model_dropout`` and
  ``edge_dropout`` attributes, JAX's 0.2 and 0.3 (card-against-CPU runs set
  them to 0, since the two devices draw different masks).
- The epochs are a loop that reads the validation loss once an epoch (JAX
  runs them in one ``while_loop``); ``history`` records each epoch's summed
  step losses, validation loss, learning rate and seconds.
"""

import hashlib
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dance_tpu_torch.modules.multi_modality.configs import joint_embedding_config
from dance_tpu_torch.modules.multi_modality.joint_embedding.scmogcn import (
    propagation_layer_combination)
from dance_tpu_torch.modules.multi_modality.predict_modality.scmogcn import (
    HeteroExpnGraph, ScMoGCN, _gelu, _subgraph, build_hetero_graph)
from dance_tpu_torch.nn.gnn import flax_dense_init_, flax_dropout
from dance_tpu_torch.ops.sparse import DenseAdj
from dance_tpu_torch.settings import logger
from dance_tpu_torch.utils import EpochClock, labeled_clustering_evaluate, resolve_device
from dance_tpu_torch.utils.metrics import integration_openproblems_evaluate
from dance_tpu_torch.utils.optim import adamw, best_state, set_learning_rate


class _ScMoGCNv2Net(nn.Module):
    """The trunk's encoder, the structured-latent decoder and the two
    auxiliary heads (counterpart: :51). ``n_batches`` is the width of the
    batch one-hot the decoder reads (flax infers it)."""

    def __init__(self, feature_size: int, out_size: int, n_ct: int, n_batches: int,
                 phase_dim: int = 2, hidden_size: int = 14, conv_layers: int = 4,
                 readout_layers: int = 1, ct_dim: int = 20, shared_start: int = 45,
                 model_dropout: float = 0.2, edge_dropout: float = 0.3):
        super().__init__()
        self.ct_dim, self.shared_start, self.model_dropout = ct_dim, shared_start, model_dropout
        self.trunk = ScMoGCN(out_size=1, feature_size=feature_size, hidden_size=hidden_size,
                             conv_layers=conv_layers, model_dropout=model_dropout,
                             edge_dropout=edge_dropout)
        # encode only: flax creates no parameters for the readout v2 never calls
        self.trunk.readout_linears = nn.ModuleList()
        dec_hid = ct_dim + (hidden_size * conv_layers - shared_start - 2)
        widths = [dec_hid + n_batches] + [dec_hid] * (readout_layers - 1) + [out_size]
        self.decoder = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.c_decoder = nn.Linear(ct_dim, n_ct)
        self.cc_decoder = nn.Linear(ct_dim, phase_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The trunk's flax init, then flax ``Dense``'s for the decoder and heads."""
        self.trunk.reset_parameters(generator)
        for lin in [*self.decoder, self.c_decoder, self.cc_decoder]:
            flax_dense_init_(lin, generator)

    def encode(self, g: HeteroExpnGraph, generator: Optional[torch.Generator] = None):
        return self.trunk.encode(g, generator)

    def decode(self, h: torch.Tensor, generator: Optional[torch.Generator] = None):
        for lin in self.decoder[:-1]:
            h = flax_dropout(_gelu(lin(h)), self.model_dropout, generator)
        return self.decoder[-1](h)

    def structured(self, emb: torch.Tensor, batch_onehot: torch.Tensor) -> torch.Tensor:
        """``[emb[:, :ct], emb[:, ss:-2], one_hot(batch)]`` (counterpart: :96)."""
        return torch.cat([emb[:, :self.ct_dim], emb[:, self.shared_start:-2], batch_onehot], 1)

    def forward(self, g: HeteroExpnGraph, batch_onehot: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """``(emb, reconstruction, cell-type logits, phase)``; dropout only
        with a ``generator``."""
        emb = self.encode(g, generator)
        out = self.decode(self.structured(emb, batch_onehot), generator)
        ct = emb[:, :self.ct_dim]
        return emb, out, self.c_decoder(ct), self.cc_decoder(ct)


def v2_loss(net: _ScMoGCNv2Net, sub: HeteroExpnGraph, bf, y, ct, phase, f1: int, f2: int,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One step's loss on the subgraph ``sub`` of a minibatch, ``bf``, ``y``,
    ``ct`` and ``phase`` at its cells (counterpart: the ``loss_fn`` of
    ``_v2_epoch_steps``, :135-143)."""
    _, out, ct_logits, cc_pred = net(sub, bf, generator)
    l1 = ((out[:, :f1] - y[:, :f1]) ** 2).mean()
    l2 = ((out[:, -f2:] - y[:, -f2:]) ** 2).mean()
    return 0.5 * l1 + 0.5 * l2 + F.cross_entropy(ct_logits, ct) + ((cc_pred - phase) ** 2).mean()


@torch.no_grad()
def v2_val_loss(net: _ScMoGCNv2Net, g: HeteroExpnGraph, y, bf, idx, f1: int,
                f2: int) -> torch.Tensor:
    """``sqrt(0.5 · MSE₁ + 0.5 · MSE₂)`` of the full graph's forward at the
    cells ``idx`` (counterpart: ``_v2_val_loss``, :222)."""
    _, out, _, _ = net(g, bf)
    l1 = ((out[idx, :f1] - y[idx, :f1]) ** 2).mean()
    l2 = ((out[idx, -f2:] - y[idx, -f2:]) ** 2).mean()
    return torch.sqrt(0.5 * l1 + 0.5 * l2)


def gumbel_top_k(logp: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """``k`` indices drawn without replacement with weights ``exp(logp)``:
    the top ``k`` of ``logp`` plus Gumbel noise from uniforms on [1e-20, 1)
    (counterpart: ``sample_feats``, :167-172)."""
    u = torch.rand(logp.shape, generator=generator, device=logp.device).clamp(min=1e-20)
    return torch.topk(logp - torch.log(-torch.log(u)), k).indices


class ScMoGCNWrapperV2:
    """scMoGNN v2 (counterpart: :230). ``args`` may carry ``hidden_size``,
    ``conv_layers``, ``learning_rate``, ``weight_decay``, ``lr_decay``,
    ``early_stopping`` and ``seed``. ``device="auto"`` is the card."""

    _DISPLAY_ATTRS = ("hidden_size", "conv_layers")

    @staticmethod
    def preprocessing_pipeline(log_level: str = "INFO"):
        """The ``SetConfig`` of a ``MuData`` of ``mod1`` and ``mod2``: both
        modalities' ``X`` the features, mod1's ``obs["cell_type"]`` the labels
        (counterpart: scmogcnv2.py:264)."""
        return joint_embedding_config(log_level)

    def __init__(self, args=None, hidden_size: int = 14, conv_layers: int = 4, ct_dim: int = 20,
                 shared_start: int = 45, learning_rate: float = 1e-2,
                 weight_decay: float = 1e-5, lr_decay: float = 0.99, early_stopping: int = 10,
                 node_sampling_rate: float = 0.6, seed: int = 0, device="auto"):
        if args is not None:
            hidden_size = getattr(args, "hidden_size", hidden_size)
            conv_layers = getattr(args, "conv_layers", conv_layers)
            learning_rate = getattr(args, "learning_rate", learning_rate)
            weight_decay = getattr(args, "weight_decay", weight_decay)
            lr_decay = getattr(args, "lr_decay", lr_decay)
            early_stopping = getattr(args, "early_stopping", early_stopping)
            seed = getattr(args, "seed", seed)
        if hidden_size * conv_layers < shared_start + 3:
            raise ValueError("latent too small: hidden_size*conv_layers must exceed "
                             "shared_start + 2")
        self.hidden_size, self.conv_layers = hidden_size, conv_layers
        self.ct_dim, self.shared_start = ct_dim, shared_start
        self.learning_rate, self.weight_decay = learning_rate, weight_decay
        self.lr_decay, self.early_stopping = lr_decay, early_stopping
        self.node_sampling_rate, self.seed = node_sampling_rate, seed
        self.model_dropout, self.edge_dropout = 0.2, 0.3  # JAX's net (scmogcnv2.py:66-67)
        self.device = resolve_device(device)
        self.net: Optional[_ScMoGCNv2Net] = None
        self.history: List[Dict[str, float]] = []  # per epoch: epoch, loss, val, lr, seconds

    def _make_net(self, feature_size: int, out_size: int, n_ct: int, n_batches: int,
                  phase_dim: int) -> _ScMoGCNv2Net:
        """A new net with flax's init drawn from ``seed``, on the device."""
        net = _ScMoGCNv2Net(feature_size, out_size, n_ct, n_batches, phase_dim,
                            hidden_size=self.hidden_size, conv_layers=self.conv_layers,
                            ct_dim=self.ct_dim, shared_start=self.shared_start,
                            model_dropout=self.model_dropout, edge_dropout=self.edge_dropout)
        net.reset_parameters(torch.Generator().manual_seed(self.seed))
        return net.to(self.device)

    def fit(self, x_mod1, x_mod2, cell_type=None, train_labels=None, batch_label=None,
            phase_score=None, epochs: int = 500, batch_size: int = 5000):
        """The sampled, validation-selected fit (counterpart: :261-361).
        ``train_labels`` takes the reference's ``[cell-type codes, batch
        codes, _, phase scores]``; ``cell_type`` / ``batch_label`` /
        ``phase_score`` are the same by keyword. The graph is kept across
        fits, keyed by a hash of its content; the weights start anew."""
        x1 = np.asarray(x_mod1, np.float32)
        x2 = np.asarray(x_mod2, np.float32)
        if train_labels is not None:
            ct_codes = np.asarray(train_labels[0], np.int64)
            batch_label, phase_score = train_labels[1], train_labels[3]
            n_ct = int(ct_codes.max()) + 1
        else:
            names, ct_codes = np.unique(np.asarray(cell_type), return_inverse=True)
            n_ct = len(names)
        n = len(x1)
        f1, f2 = x1.shape[1], x2.shape[1]
        x = np.concatenate([x1, x2], axis=1)
        batch_codes = (np.zeros(n, np.int64) if batch_label is None
                       else np.unique(np.asarray(batch_label), return_inverse=True)[1])
        n_batches = int(batch_codes.max()) + 1
        phase = np.asarray(np.zeros((n, 2)) if phase_score is None else phase_score, np.float32)
        dev = self.device
        cache_key = (x.shape, hashlib.md5(np.ascontiguousarray(x)).hexdigest())
        if getattr(self, "_graph_cache_key", None) == cache_key:
            g = self._graph_cache
        else:
            g = build_hetero_graph(x, use_bsr="no_bsr", device=dev)
            self._graph_cache_key, self._graph_cache = cache_key, g
        self.net = net = self._make_net(g.n_feats, f1 + f2, n_ct, n_batches, phase.shape[1])
        bf = F.one_hot(torch.from_numpy(batch_codes), n_batches).float().to(dev)
        # the values: the sampled blocks' weights and the reconstruction target
        y = g.f2c.mat if isinstance(g.f2c, DenseAdj) else torch.from_numpy(x).to(dev)
        ct = torch.from_numpy(ct_codes).to(dev)
        phase = torch.from_numpy(phase).to(dev)
        idx = np.random.default_rng(self.seed).permutation(n)
        train_idx = idx[:max(1, int(n * 0.9))]
        val_idx = torch.from_numpy(idx[int(n * 0.9):] if n >= 10 else idx).to(dev)
        bs = min(batch_size, len(train_idx))
        n_steps = max(1, len(train_idx) // bs)
        n_samp = max(1, int(self.node_sampling_rate * g.n_feats))
        deg_f = g.deg_f.cpu()
        logp = torch.log(torch.clamp(deg_f / max(float(deg_f.sum()), 1e-12), min=1e-20))
        lr = self.learning_rate
        opt = adamw(net, lr, self.weight_decay)
        cell_gen = torch.Generator().manual_seed(self.seed)
        feat_gen = torch.Generator().manual_seed(self.seed + 1)
        drop_gen = torch.Generator(device=dev).manual_seed(self.seed)
        best_val, best_epoch, best = np.inf, 0, best_state(net)
        clock, rows = EpochClock(dev), []
        for epoch in range(epochs):
            clock.tick()
            set_learning_rate(opt, lr)
            total = 0.0
            # a permutation of the training cells, cut to whole steps (JAX:
            # ``permutation(fold_in(key, epoch), train_idx)``, :188)
            perm = torch.randperm(len(train_idx), generator=cell_gen)[:n_steps * bs].numpy()
            for cells in train_idx[perm].reshape(n_steps, bs):
                feat_idx = gumbel_top_k(logp, n_samp, feat_gen).to(dev)
                cell_idx = torch.from_numpy(cells).to(dev)
                sub = _subgraph(g, y, None, cell_idx, feat_idx)
                opt.zero_grad(set_to_none=True)
                loss = v2_loss(net, sub, bf[cell_idx], y[cell_idx], ct[cell_idx],
                               phase[cell_idx], f1, f2, drop_gen)
                loss.backward()
                opt.step()
                total = total + loss.detach()
            val = float(v2_val_loss(net, g, y, bf, val_idx, f1, f2))
            if val < best_val:
                best_val, best_epoch, best = val, epoch, best_state(net)
            rows.append((epoch, total, val, lr))
            if epoch > 150:
                lr *= self.lr_decay
            if epoch > self.early_stopping and epoch - best_epoch >= self.early_stopping:
                logger.info("scMoGNN-v2 early stopped at epoch %d", epoch)
                break
        clock.tick()
        net.load_state_dict(best)
        self.history = [{"epoch": e, "loss": float(l), "val": v, "lr": r, "seconds": s}
                        for (e, l, v, r), s in zip(rows, clock.seconds())]
        self.best_val, self.best_epoch, self._lr = best_val, best_epoch, lr
        logger.info("scMoGNN-v2 best val %.5f at epoch %d (%d epochs)", best_val, best_epoch,
                    len(rows))
        self._cache = (g, bf)
        return self

    @torch.no_grad()
    def predict(self, x=None) -> np.ndarray:
        """The joint embedding ``[emb[:, :ct], emb[:, ss:-2]]`` of every cell
        of the last fit's graph (counterpart: :363)."""
        emb = self.net.encode(self._cache[0])
        return torch.cat([emb[:, :self.ct_dim], emb[:, self.shared_start:-2]], 1).cpu().numpy()

    def score(self, x, y, *, score_func=None, return_pred: bool = False,
              metric: str = "clustering", batch=None, **kwargs):
        """k-means NMI of the embedding against ``y`` (``metric="clustering"``),
        or the scIB suite's ``final_scores`` (``"openproblems"``; its scores
        and the embedding with ``return_pred``) (counterpart: :369)."""
        emb = self.predict()
        y = np.asarray(y)
        if metric == "openproblems":
            scores = integration_openproblems_evaluate(emb, y, batch, device=self.device,
                                                       **kwargs)
            return (scores, emb) if return_pred else scores["final_scores"]
        scores = labeled_clustering_evaluate(emb, y, n_clusters=len(np.unique(y)),
                                             device=self.device)
        return (scores, emb) if return_pred else scores["dance_nmi"]


# the reference import path exposes the operative wrapper under both names
ScMoGCNWrapper = ScMoGCNWrapperV2

__all__ = ["ScMoGCNWrapper", "ScMoGCNWrapperV2", "gumbel_top_k", "propagation_layer_combination",
           "v2_loss", "v2_val_loss"]
