"""scDSC: an SDCN-style autoencoder fused layer by layer into a GCN stack,
with a ZINB head and DEC self-supervision.

Counterpart: dance_tpu/modules/single_modality/clustering/scdsc.py (``_AE``
:32-61, ``ScDSCModel`` :64-104, ``ScDSC`` :107-325, ``preprocessing_pipeline``
:137-159). The deep autoencoder (3 encoder, 3 latent and 3 decoder layers)
is pretrained alone on minibatches; then each of the seven GCN layers mixes
the previous GCN output with the matching autoencoder layer, ``(1 - sigma) h
+ sigma tra``, and aggregates over the symmetric-normalised cell graph. The
loss is ``bcl`` BCE(q, p) + ``cl`` KL(p || softmax of the GCN) + ``rl`` MSE +
``zl`` ZINB; every 10 epochs the target ``p`` is refreshed and the
assignments are scored (ARI), and the best ``q`` is kept
(:func:`~dance_tpu_torch.nn.dec_loop.run_dec_loop`). With ``use_bsr=True``
the graph is RCM-banded and every aggregation is one block-sparse SpMM (the
CUDA kernel on the card, forward and ``Aᵀḡ`` backward); ``q`` is put back in
the input order. ``use_bsr="auto"`` (the default, as in JAX) decides BSR or
CSR by :func:`~dance_tpu_torch.ops.bsr.resolve_use_bsr` on the normalised
graph; CSR off the card.

Where this differs from the JAX package:

- The refresh runs the autoencoder branch only: ``q`` and ``p`` depend on
  nothing else, and JAX's full forward there would add the seven SpMMs.
- The weights are drawn when the model is made (JAX draws them at the first
  fit), from a CPU ``torch.Generator`` seeded with ``seed``; the pretrain
  batches come from a ``torch.Generator`` too, and k-means is the port's.
  Parity tests copy the flax weights in
  (:func:`dance_tpu_torch.utils.params.scdsc_flax_to_torch`) and take the
  batches and centres from the JAX run.
- A later ``fit`` on another graph trains on that graph; JAX keeps the first
  fit's adjacency.
- ``history`` and ``pretrain_history`` record each epoch's loss and seconds
  (:class:`~dance_tpu_torch.utils.EpochClock`).
- :func:`scdsc_preprocess` is the array front of ``preprocessing_pipeline``:
  it runs the pipeline on a matrix wrapped in a ``Data``.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from dance_tpu_torch.modules.base import BaseClusteringMethod, NNPretrain, wrap_matrix
from dance_tpu_torch.nn.dec_loop import run_dec_loop
from dance_tpu_torch.nn.gnn import flax_dense_init_, truncated_normal_
from dance_tpu_torch.nn.zinb_ae import disp_act, mean_act
from dance_tpu_torch.ops.bsr import bsr_with_rcm, resolve_use_bsr, unpermute
from dance_tpu_torch.ops.cluster import kmeans
from dance_tpu_torch.ops.segment import spmm
from dance_tpu_torch.ops.sparse import csr_from_scipy, sym_norm_adjacency
from dance_tpu_torch.modules.single_modality.clustering.sctag import (ZINB_CONFIG, count_steps,
                                                                     zinb_inputs)
from dance_tpu_torch.settings import logger
from dance_tpu_torch.transforms.graph import NeighborGraph
from dance_tpu_torch.transforms.misc import Compose, SetConfig
from dance_tpu_torch.utils import EpochClock, resolve_device
from dance_tpu_torch.utils.batch import epoch_batches
from dance_tpu_torch.utils.loss import soft_assign, target_distribution, zinb_nll

DIMS = (512, 256, 256, 256, 128, 32, 256, 256, 512)


def _linears(widths: Sequence[int], bias: bool = True) -> nn.ModuleList:
    return nn.ModuleList(nn.Linear(a, b, bias=bias) for a, b in zip(widths[:-1], widths[1:]))


class _AE(nn.Module):
    """The deep autoencoder (counterpart: scdsc.py:32). ``dims`` is (enc1,
    enc2, enc3, z1, z2, z3, dec1, dec2, dec3); flax infers the input width,
    torch takes it as ``n_input``. ``enc``, ``zs`` and ``dec`` keep flax's
    list order."""

    def __init__(self, dims: Sequence[int], n_input: int):
        super().__init__()
        e1, e2, e3, z1, z2, z3, d1, d2, d3 = dims
        self.enc = _linears((n_input, e1, e2, e3))
        self.zs = _linears((e3, z1, z2, z3))
        self.dec = _linears((z3, d1, d2, d3))
        self.out = nn.Linear(d3, n_input)

    def forward(self, x: torch.Tensor):
        """``(x_bar, tra1, tra2, tra3, z3, z2, z1, dec_h3)``, as the flax module."""
        tra, h = [], x
        for layer in self.enc:
            h = torch.relu(layer(h))
            tra.append(h)
        zl = []
        for i, layer in enumerate(self.zs):
            h = layer(h) if i == len(self.zs) - 1 else torch.relu(layer(h))
            zl.append(h)
        z1, z2, z3 = zl
        h = z3
        for layer in self.dec:
            h = torch.relu(layer(h))
        return self.out(h), tra[0], tra[1], tra[2], z3, z2, z1, h


class ScDSCModel(nn.Module):
    """The autoencoder fused into a GCN stack (counterpart: scdsc.py:64).
    ``gnn`` holds the seven bias-free GCN kernels, ``cluster_layer`` the
    cluster centres in the latent."""

    def __init__(self, n_input: int, n_clusters: int, sigma: float = 1.0,
                 dims: Sequence[int] = DIMS, v: float = 1.0):
        super().__init__()
        e1, e2, e3, z1, z2, z3, d1, d2, d3 = dims
        self.sigma, self.v = sigma, v
        self.ae = _AE(dims, n_input)
        self.gnn = _linears((n_input, e1, e2, e3, z1, z2, z3, n_clusters), bias=False)
        self.dec_mean = nn.Linear(d3, n_input)
        self.dec_disp = nn.Linear(d3, n_input)
        self.dec_pi = nn.Linear(d3, n_input)
        self.cluster_layer = nn.Parameter(torch.empty(n_clusters, z3))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's init: ``Dense`` defaults, glorot-uniform GCN kernels and
        xavier-normal (truncated, fan average) centres."""
        for layer in (*self.ae.enc, *self.ae.zs, *self.ae.dec, self.ae.out, self.dec_mean,
                      self.dec_disp, self.dec_pi):
            flax_dense_init_(layer, generator)
        for layer in self.gnn:
            nn.init.xavier_uniform_(layer.weight, generator=generator)
        fan_avg = sum(self.cluster_layer.shape) / 2
        with torch.no_grad():
            truncated_normal_(self.cluster_layer, (1.0 / fan_avg) ** 0.5, generator)

    def assign(self, z: torch.Tensor) -> torch.Tensor:
        """Student-t soft assignments of latent ``z`` to the centres."""
        return soft_assign(z, self.cluster_layer, self.v)

    def forward(self, x: torch.Tensor, adj):
        """``(x_bar, q, predict, z3, mean, disp, pi)``, as the flax module."""
        x_bar, tra1, tra2, tra3, z3, z2, z1, dec_h3 = self.ae(x)
        s = self.sigma
        h = torch.relu(spmm(adj, self.gnn[0](x)))
        for layer, mix in zip(self.gnn[1:6], (tra1, tra2, tra3, z1, z2)):
            h = torch.relu(spmm(adj, layer((1 - s) * h + s * mix)))
        h = spmm(adj, self.gnn[6]((1 - s) * h + s * z3))
        predict = torch.softmax(h, dim=1)
        mean = mean_act(self.dec_mean(dec_h3))
        disp = disp_act(self.dec_disp(dec_h3))
        pi = torch.sigmoid(self.dec_pi(dec_h3))
        return x_bar, self.assign(z3), predict, z3, mean, disp, pi


def dec_loss(model: ScDSCModel, x: torch.Tensor, adj, x_raw: torch.Tensor, sf: torch.Tensor,
             p: torch.Tensor, bcl: float = 0.1, cl: float = 0.01, rl: float = 1.0,
             zl: float = 0.1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The DEC stage's loss on one full forward (counterpart: scdsc.py:212-219):
    ``bcl`` BCE(q, p) + ``cl`` KL(p || predict) + ``rl`` MSE(x_bar, x) + ``zl``
    ZINB of ``x_raw`` at size factors ``sf``. Returns ``(loss, predict)``."""
    eps = 1e-10
    x_bar, q, pred, _, mean, disp, pi = model(x, adj)
    bce = -(p * torch.log(q + eps) + (1 - p) * torch.log(1 - q + eps)).mean()
    ce = torch.sum(p * (torch.log(p + eps) - torch.log(pred + eps)), dim=1).mean()
    re = torch.mean((x_bar - x) ** 2)
    zinb = zinb_nll(x_raw, mean, disp, pi, scale_factor=sf[:, None])
    return bcl * bce + cl * ce + rl * re + zl * zinb, pred


class ScDSC(NNPretrain, BaseClusteringMethod):
    """scDSC (counterpart: scdsc.py:107). ``fit((adj, x, x_raw, n_counts), y)``
    trains on the cell graph, the features, the ZINB target and the library
    sizes (the output of :func:`scdsc_preprocess`); ``predict`` is the argmax
    of ``q``. ``reference_protocol=True`` keeps the initial random centres
    instead of k-means ones, as the reference does (scdsc.py:263-270)."""

    _DISPLAY_ATTRS = ("n_clusters", "sigma")

    def __init__(self, pretrain_path: Optional[str] = None, sigma: float = 1.0,
                 n_enc_1: int = 512, n_enc_2: int = 256, n_enc_3: int = 256,
                 n_dec_1: int = 256, n_dec_2: int = 256, n_dec_3: int = 512,
                 n_z1: int = 256, n_z2: int = 128, n_z3: int = 32, n_clusters: int = 10,
                 n_input: int = 100, v: float = 1.0, device="auto", seed: int = 0,
                 reference_protocol: bool = False):
        super().__init__()
        self.pretrain_path, self.n_clusters, self.sigma, self.v = pretrain_path, n_clusters, sigma, v
        self.seed, self.reference_protocol = seed, reference_protocol
        self.device = resolve_device(device)
        self.model = ScDSCModel(n_input, n_clusters, sigma=sigma,
                                dims=(n_enc_1, n_enc_2, n_enc_3, n_z1, n_z2, n_z3, n_dec_1,
                                      n_dec_2, n_dec_3), v=v)
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        self.q: Optional[np.ndarray] = None
        self.history: List[Dict[str, float]] = []           # DEC epochs: epoch, loss, seconds
        self.pretrain_history: List[Dict[str, float]] = []  # AE epochs: epoch, loss, seconds
        self.dec_out: Dict = {}  # run_dec_loop's last ``out``

    def pretrain(self, x, batch_size: int = 256, epochs: int = 200, lr: float = 1e-3):
        """Minibatch autoencoder pretrain (counterpart: scdsc.py:195): per epoch
        the shuffled cells in wrap-padded batches of ``batch_size``
        (:func:`~dance_tpu_torch.utils.batch.epoch_batches`), one Adam step on
        each batch's reconstruction MSE. Only the autoencoder is updated (JAX's
        Adam over every parameter gives the others zero gradients and zero
        updates)."""
        x = torch.as_tensor(np.asarray(x, np.float32)).to(self.device)
        opt = torch.optim.Adam(self.model.ae.parameters(), lr=lr)
        gen = torch.Generator().manual_seed(self.seed)
        bs = min(batch_size, x.shape[0])
        clock, losses = EpochClock(self.device), []
        for _ in range(epochs):
            clock.tick()
            batch_losses = []
            for idx in epoch_batches(gen, x.shape[0], bs).to(self.device):
                bx = x[idx]
                opt.zero_grad(set_to_none=True)
                loss = torch.mean((self.model.ae(bx)[0] - bx) ** 2)
                loss.backward()
                opt.step()
                batch_losses.append(loss.detach())
            losses.append(torch.stack(batch_losses).mean())
        clock.tick()
        self.pretrain_history = [{"epoch": e, "loss": float(l), "seconds": s}
                                 for e, (l, s) in enumerate(zip(losses, clock.seconds()))]
        for h in self.pretrain_history[::100]:
            logger.info("AE pretrain epoch %d, MSE %.6f", h["epoch"], h["loss"])

    @staticmethod
    def preprocessing_pipeline(n_top_genes: int = 2000, n_neighbors: int = 50,
                               log_level: str = "INFO") -> Compose:
        """scDSC's preprocessing of a ``Data`` (:func:`scdsc_preprocess` runs it
        on a matrix): :func:`~dance_tpu_torch.modules.single_modality.
        clustering.sctag.count_steps` and the ``n_neighbors``-NN graph of the
        scaled features themselves (``NeighborGraph(channel=None)``, on the
        host) into ``obsp["NeighborGraph"]``; ``get_train_data`` gives
        :meth:`fit`'s inputs and the labels in ``obsm["Group"]`` (counterpart:
        scdsc.py:129-150). Nothing here runs on the card."""
        return Compose(
            *count_steps(n_top_genes),
            NeighborGraph(n_neighbors=n_neighbors, channel=None),
            SetConfig(ZINB_CONFIG),
            log_level=log_level,
        )

    def fit(self, inputs: Tuple, y=None, lr: float = 1e-3, epochs: int = 300, bcl: float = 0.1,
            cl: float = 0.01, rl: float = 1.0, zl: float = 0.1, pt_epochs: int = 200,
            pt_batch_size: int = 256, pt_lr: float = 1e-3, use_bsr="auto",
            bsr_block: int = 128):
        """Pretrain the autoencoder (always; then saved to ``pretrain_path``
        when set), k-means centres of its latent (10 restarts), then the DEC
        loop from a new Adam: a refresh every 10 epochs, never a tolerance
        stop (counterpart: scdsc.py:209-303). With labels ``y``, ``q`` is the
        refresh with the best ARI (the first best), else the last."""
        adj, x, x_raw, n_counts = inputs
        x, x_raw, n_counts = (np.asarray(a.toarray() if sp.issparse(a) else a)
                              for a in (x, x_raw, n_counts))
        x = x.astype(np.float32)
        _, adj_n = sym_norm_adjacency(adj)
        use_bsr = resolve_use_bsr(use_bsr, adj_n, bsr_block, device=self.device)
        self._perm = None
        if use_bsr:
            self._perm, tiles = bsr_with_rcm(adj_n, block=bsr_block)
            self.adj = tiles.to(self.device)
            x, x_raw, n_counts = x[self._perm], x_raw[self._perm], n_counts[self._perm]
        else:
            self.adj = csr_from_scipy(adj_n).to(self.device)
        self._pretrain(x, batch_size=pt_batch_size, epochs=pt_epochs, lr=pt_lr,
                       force_pretrain=True)
        dev, model = self.device, self.model
        xt = torch.from_numpy(x).to(dev)
        if not self.reference_protocol:
            # SDCN's k-means centres; the reference keeps its random ones
            with torch.no_grad():
                z3 = model.ae(xt)[4]
                model.cluster_layer.copy_(kmeans(z3, self.n_clusters, n_init=10,
                                                 seed=self.seed).centers)
        xr = torch.from_numpy(np.asarray(x_raw, np.float32)).to(dev)
        n_counts = np.asarray(n_counts, np.float64)
        sf = torch.from_numpy((n_counts / np.median(n_counts)).astype(np.float32)).to(dev)
        opt = torch.optim.Adam(model.parameters(), lr=lr)
        clock, losses = EpochClock(dev), []

        def refresh(_):
            with torch.no_grad():
                q = model.assign(model.ae(xt)[4])
            return q, q, target_distribution(q)

        def train(_, p):
            clock.tick()
            opt.zero_grad(set_to_none=True)
            loss, _ = dec_loss(model, xt, self.adj, xr, sf, p, bcl, cl, rl, zl)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
            return None, loss.detach()

        y_cmp = None
        if y is not None:
            # q comes back in the training (permuted) order; the labels follow it
            y_cmp = np.asarray(y).ravel()
            y_cmp = y_cmp[self._perm] if self._perm is not None else y_cmp
        _, self.dec_out = run_dec_loop(refresh, train, None, np.zeros(x.shape[0], np.int64),
                                       y_cmp, epochs, -1.0, update_interval=10)
        clock.tick()
        self.history = [{"epoch": e, "loss": float(l), "seconds": s}
                        for e, (l, s) in enumerate(zip(losses, clock.seconds()))]
        q = self.dec_out["best_q"] if y is not None else self.dec_out["q"]
        self.q = unpermute(self._perm, q.cpu().numpy())
        return self

    def predict_proba(self, x=None) -> np.ndarray:
        return np.asarray(self.q)

    def predict(self, x=None) -> np.ndarray:
        return np.asarray(self.q).argmax(1)


def scdsc_preprocess(counts, *, n_top_genes: int = 2000, n_neighbors: int = 50, device="auto"):
    """:meth:`ScDSC.preprocessing_pipeline` on raw ``counts`` (cells x genes,
    numpy or scipy, taken as float32) wrapped in a ``Data``. Returns ``((adj,
    x, x_raw, n_counts), cells)``: the input of :meth:`ScDSC.fit` and the
    indices of the kept cells. ``device`` is checked, as for every entry
    point, though nothing here runs on it."""
    resolve_device(device)
    data = wrap_matrix(counts)
    ScDSC.preprocessing_pipeline(n_top_genes=n_top_genes, n_neighbors=n_neighbors,
                                 log_level="WARNING")(data)
    return zinb_inputs(data), np.asarray(data.data.obs_names).astype(np.int64)


__all__ = ["ScDSC", "ScDSCModel", "dec_loss", "scdsc_preprocess"]
