"""scDeepCluster: a denoising ZINB autoencoder, then DEC soft clustering on
its latent.

Counterpart: dance_tpu/modules/single_modality/clustering/scdeepcluster.py
(``preprocessing_pipeline`` :52-64, the pretrain epoch :68-88, the DEC epoch
:138-164, ``pretrain`` :177-194, ``fit`` :196-252, ``euclidean_dist`` :278).
The autoencoder (:class:`~dance_tpu_torch.nn.zinb_ae.ZINBAutoencoder`) is
pretrained alone on the ZINB NLL of the raw counts over shuffled, wrap-padded
batches, the input perturbed by ``sigma`` x Gaussian noise, with optax's
AMSGrad (:class:`~dance_tpu_torch.utils.optim.amsgrad`). Then k-means (20
restarts) of the clean latent gives the centres ``mu``, and the DEC stage
trains the autoencoder and ``mu`` together with Adadelta (lr 1, rho 0.95) on
``gamma`` x KL(p || q) of the clean path's Student-t assignments plus the
noisy path's ZINB NLL, refreshing the target ``p`` every
``update_interval`` epochs, stopping when fewer than ``tol`` of the labels
change and, with labels, keeping the refresh of best ARI
(:func:`~dance_tpu_torch.nn.dec_loop.run_dec_loop`).

Where this differs from the JAX package:

- Every DEC epoch visits the batches in one fixed, wrap-padded order, as in
  JAX (``epoch_batches(jax.random.key(0), ...)``, :141); the port draws
  that order once per fit from a ``torch.Generator`` seeded with 0, so it is
  not JAX's permutation. The pretrain orders come from a CPU generator
  seeded with ``seed``, and the noise from a generator on the device; the
  weights are drawn when the model is made. Parity tests copy the flax
  weights in (:func:`dance_tpu_torch.utils.params.zinb_ae_flax_to_torch`)
  and hand the port JAX's batch orders and normals (through a patched
  ``epoch_batches`` and :meth:`ScDeepCluster._noise`).
- ``activation`` is accepted and ignored, as in JAX: the layers are ReLU.
- The epochs are loops; JAX runs them as compiled scans and one
  ``while_loop``. ``history`` and ``pretrain_history`` record each epoch's
  mean loss and seconds, ``dec_out`` the DEC loop's last state.
- :func:`scdeepcluster_preprocess` is the array front of
  ``preprocessing_pipeline``: it runs the pipeline on a matrix wrapped in a
  ``Data``.

Under ``fit_distributed`` (scdeepcluster.py:179-181, :204-206) each rank
holds its rows of the features, counts and size factors
(:func:`~dance_tpu_torch.parallel.mesh.to_device`); every rank draws the
batch orders and the noise of whole batches, computes the loss of the
batch's cells it holds, and the gradients are summed over ``dp``
(:class:`~dance_tpu_torch.parallel.mesh.RowShard`); the latent for the
k-means centres and for each target refresh is gathered whole. scDCC fits
whole on every rank.
"""

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from dance_tpu_torch.modules.base import (BaseClusteringMethod, NNPretrain, dense32,
                                          row_positions, wrap_matrix)
from dance_tpu_torch.nn.dec_loop import run_dec_loop
from dance_tpu_torch.nn.zinb_ae import ZINBAutoencoder
from dance_tpu_torch.parallel.mesh import RowShard, to_device
from dance_tpu_torch.ops.cluster import kmeans
from dance_tpu_torch.settings import logger
from dance_tpu_torch.transforms.filter import FilterGenesTopK
from dance_tpu_torch.transforms.interface import AnnDataTransform
from dance_tpu_torch.transforms.misc import Compose, SaveRaw, SetConfig
from dance_tpu_torch.utils import EpochClock, resolve_device
from dance_tpu_torch.utils.batch import epoch_batches
from dance_tpu_torch.utils.loss import cluster_kl_loss, soft_assign, target_distribution, zinb_nll
from dance_tpu_torch.utils.optim import amsgrad


class ScDeepCluster(NNPretrain, BaseClusteringMethod):
    """scDeepCluster (counterpart: scdeepcluster.py:28). ``fit((x, x_raw,
    n_counts), y)`` takes the scaled features, the raw counts (the ZINB
    target) and the cells' totals (the output of
    :func:`scdeepcluster_preprocess`); ``predict`` is the argmax of ``q``."""

    _DISPLAY_ATTRS = ("z_dim", "sigma", "alpha", "gamma")

    def __init__(self, input_dim: int, z_dim: int, encodeLayer=(256, 64), decodeLayer=(64, 256),
                 activation: str = "relu", sigma: float = 1.0, alpha: float = 1.0,
                 gamma: float = 1.0, device="auto", pretrain_path: Optional[str] = None,
                 seed: int = 0):
        super().__init__()
        self.input_dim, self.z_dim = input_dim, z_dim
        self.sigma, self.alpha, self.gamma = sigma, alpha, gamma
        self.pretrain_path = pretrain_path
        self.seed = seed
        self.device = resolve_device(device)
        self.model = ZINBAutoencoder(input_dim, z_dim, tuple(encodeLayer), tuple(decodeLayer),
                                     sigma=sigma)
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        self.mu: Optional[nn.Parameter] = None  # the cluster centres
        self.q: Optional[np.ndarray] = None
        self.z: Optional[np.ndarray] = None
        self.y_pred: Optional[np.ndarray] = None
        self.history: List[Dict[str, float]] = []           # DEC epochs: epoch, loss, seconds
        self.pretrain_history: List[Dict[str, float]] = []  # AE epochs: epoch, loss, seconds
        self.dec_out: Dict = {}  # run_dec_loop's last ``out``

    def _noise(self, shape, generator: torch.Generator) -> torch.Tensor:
        """The denoising noise of one batch: standard normals on the device."""
        return torch.randn(shape, generator=generator, device=self.device)

    def _noisy(self, shape, generator: torch.Generator) -> Optional[torch.Tensor]:
        """The noise of a whole batch of ``shape``, or None at ``sigma`` 0."""
        return self._noise(shape, generator) if self.sigma > 0 else None

    def _tensors(self, x, x_raw, n_counts):
        """Features, counts and size factors (totals over their median) on the
        device, float32 (this rank's rows in a data-parallel fit)."""
        x, x_raw = (np.asarray(a.toarray() if sp.issparse(a) else a, np.float32)
                    for a in (x, x_raw))
        n_counts = np.asarray(n_counts, np.float64)
        sf = (n_counts / np.median(n_counts)).astype(np.float32)
        return tuple(to_device(a, device=self.device) for a in (x, x_raw, sf))

    def pretrain(self, x, x_raw, n_counts, batch_size: int = 256, lr: float = 0.001,
                 epochs: int = 400):
        """The denoising ZINB pretrain with AMSGrad (counterpart:
        scdeepcluster.py:177): per epoch the shuffled cells in wrap-padded
        batches, one step on each batch's ZINB NLL at its size factors."""
        shard = RowShard.of(x.shape[0])
        x, xr, sf = self._tensors(x, x_raw, n_counts)
        model, dev = self.model, self.device
        opt = amsgrad(model.parameters(), lr=lr)
        order_gen = torch.Generator().manual_seed(self.seed)
        noise_gen = torch.Generator(device=dev).manual_seed(self.seed)
        clock, losses = EpochClock(dev), []
        for _ in range(epochs):
            clock.tick()
            batch_losses = []
            for rows in epoch_batches(order_gen, shard.n, batch_size).to(dev):
                pos, loc = shard.split(rows)
                noise = self._noisy((len(rows), x.shape[1]), noise_gen)
                opt.zero_grad(set_to_none=True)
                loss = None
                if pos is None or len(pos):
                    mean, disp, pi = model.noisy_heads(x[loc], shard.take(noise, pos))
                    loss = zinb_nll(xr[loc], mean, disp, pi, scale_factor=sf[loc][:, None])
                batch_losses.append(shard.step(loss, model.parameters(),
                                               shard.share(pos, len(rows))))
                opt.step()
            losses.append(torch.stack(batch_losses).mean())
        clock.tick()
        self.pretrain_history = [{"epoch": e, "loss": float(l), "seconds": s}
                                 for e, (l, s) in enumerate(zip(losses, clock.seconds()))]
        for h in self.pretrain_history[::100]:
            logger.info("Pretrain epoch %3d, ZINB loss: %.6f", h["epoch"] + 1, h["loss"])

    def _init_centres(self, x: torch.Tensor, n_clusters: int, init_centroid=None,
                      y_pred_init=None, shard: Optional[RowShard] = None):
        """``mu`` from k-means of the latent (20 restarts), or as given;
        returns the initial labels."""
        if init_centroid is None:
            with torch.no_grad():
                latent = self.model.encode(x)
            if shard is not None:
                latent = shard.gather(latent)
            res = kmeans(latent, n_clusters, n_init=20, seed=self.seed)
            centres, labels = res.centers, res.labels.cpu().numpy()
        else:
            centres, labels = torch.as_tensor(init_centroid, dtype=torch.float32), y_pred_init
        self.mu = nn.Parameter(centres.detach().clone().to(self.device))
        self.y_pred = np.asarray(labels)
        return self.y_pred

    def _dec_stage(self, x, xr, sf, y, *, lr: float, batch_size: int, epochs: int,
                   update_interval: int, tol: float, after_epoch: Optional[Callable] = None,
                   shard: Optional[RowShard] = None):
        """The DEC epochs (counterpart: scdeepcluster.py:224-252): Adadelta on
        the autoencoder and ``mu``, every epoch one pass over the fixed batch
        order, then ``after_epoch()`` when given (scDCC's constraint step)."""
        model, dev, mu = self.model, self.device, self.mu
        shard = shard if shard is not None else RowShard(x.shape[0])
        params = [*model.parameters(), mu]
        opt = torch.optim.Adadelta(params, lr=lr, rho=0.95, eps=1e-6)
        order = epoch_batches(torch.Generator().manual_seed(0), shard.n, batch_size).to(dev)
        noise_gen = torch.Generator(device=dev).manual_seed(self.seed + 13)
        clock, losses = EpochClock(dev), []

        def refresh(_):
            with torch.no_grad():
                z = shard.gather(model.encode(x))
                q = soft_assign(z, mu, self.alpha)
            return q, z, target_distribution(q)

        def train(_, p):
            clock.tick()
            batch_losses = []
            for rows in order:
                pos, loc = shard.split(rows)
                noise = self._noisy((len(rows), x.shape[1]), noise_gen)
                opt.zero_grad(set_to_none=True)
                loss = None
                if pos is None or len(pos):
                    z, mean, disp, pi = model(x[loc], noise=shard.take(noise, pos))
                    q = soft_assign(z, mu, self.alpha)
                    loss = (self.gamma * cluster_kl_loss(p[shard.take(rows, pos)], q)
                            + zinb_nll(xr[loc], mean, disp, pi, scale_factor=sf[loc][:, None]))
                batch_losses.append(shard.step(loss, params, shard.share(pos, len(rows))))
                opt.step()
            if after_epoch is not None:
                after_epoch()
            loss = torch.stack(batch_losses).mean()
            losses.append(loss)
            return None, loss

        _, self.dec_out = run_dec_loop(refresh, train, None, self.y_pred, y, epochs, tol,
                                       update_interval=update_interval)
        clock.tick()
        self.history = [{"epoch": e, "loss": float(l), "seconds": s}
                        for e, (l, s) in enumerate(zip(losses, clock.seconds()))]
        out = self.dec_out
        if out["stop"]:
            logger.info("Reach tolerance threshold (%.3e < %.3e) at epoch %d. Stopped training.",
                        out["delta"], tol, out["epoch"])
        logger.info("Epoch %3d: loss %.6f", out["epoch"], out["loss"])
        src = "best_" if y is not None else ""
        self.q = out[f"{src}q"].cpu().numpy()
        self.z = out[f"{src}z"].cpu().numpy()
        self.y_pred = out[f"{src}labels"].cpu().numpy()

    @staticmethod
    def preprocessing_pipeline(log_level: str = "INFO") -> Compose:
        """:func:`zinb_pipeline` without a top-k cut (counterpart:
        scdeepcluster.py:52-64)."""
        return zinb_pipeline(log_level=log_level)

    def fit(self, inputs: Tuple, y=None, n_clusters: int = 10, init_centroid=None,
            y_pred_init=None, lr: float = 1.0, batch_size: int = 256, epochs: int = 10,
            update_interval: int = 1, tol: float = 1e-3, pt_batch_size: int = 256,
            pt_lr: float = 0.001, pt_epochs: int = 400):
        """Pretrain (always; then saved to ``pretrain_path`` when set), the
        centres, then the DEC stage (counterpart: scdeepcluster.py:196). With
        labels ``y``, ``q`` is the refresh of best ARI, else the last."""
        x, x_raw, n_counts = inputs
        self._pretrain(x, x_raw, n_counts, batch_size=pt_batch_size, lr=pt_lr,
                       epochs=pt_epochs, force_pretrain=True)
        shard = RowShard.of(x.shape[0])
        x, xr, sf = self._tensors(x, x_raw, n_counts)
        self._init_centres(x, n_clusters, init_centroid, y_pred_init, shard)
        self._dec_stage(x, xr, sf, y, lr=lr, batch_size=min(batch_size, shard.n),
                        epochs=epochs, update_interval=update_interval, tol=tol, shard=shard)
        return self

    def predict_proba(self, x=None) -> np.ndarray:
        return np.asarray(self.q)

    def predict(self, x=None) -> np.ndarray:
        return np.asarray(self.q).argmax(1)

    def get_latent(self) -> np.ndarray:
        return np.asarray(self.z)


def euclidean_dist(x, y) -> torch.Tensor:
    """The sum of squared differences (counterpart: scdeepcluster.py:278)."""
    return torch.sum(torch.square(torch.as_tensor(x) - torch.as_tensor(y)))


class ClusteringInputs(NamedTuple):
    """What :func:`scdeepcluster_preprocess` and ``scdcc_preprocess`` return:
    the scaled features ``x``, the counts ``x_raw`` (``SaveRaw``), the cells'
    totals ``n_counts``, the kept cells' ``labels`` (None without labels),
    the kept ``gene_names`` and the indices of the kept ``cells``."""

    x: np.ndarray
    x_raw: np.ndarray
    n_counts: np.ndarray
    labels: Optional[np.ndarray]
    gene_names: np.ndarray
    cells: np.ndarray

    @property
    def inputs(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(x, x_raw, n_counts)``, what ``fit`` takes."""
        return self.x, self.x_raw, self.n_counts


def zinb_pipeline(n_top_genes: Optional[int] = None, log_level: str = "INFO") -> Compose:
    """The count processing of scDeepCluster's and scDCC's pipelines
    (scdeepcluster.py:52-64, scdcc.py:41-54): genes without counts and cells
    without counts dropped, the cells' totals written there
    (``obs["n_counts"]``, before any top-k cut); with ``n_top_genes`` the
    genes of largest variance (``FilterGenesTopK(mode="var")``, sorted-name
    order); the counts kept (``SaveRaw``); then ``normalize_total``,
    ``log1p`` and ``scale``."""
    transforms = [AnnDataTransform("sc.pp.filter_genes", min_counts=1),
                  AnnDataTransform("sc.pp.filter_cells", min_counts=1)]
    if n_top_genes is not None:
        transforms.append(FilterGenesTopK(num_genes=n_top_genes, mode="var"))
    transforms.extend([
        SaveRaw(),
        AnnDataTransform("sc.pp.normalize_total"),
        AnnDataTransform("sc.pp.log1p"),
        AnnDataTransform("sc.pp.scale"),
        SetConfig({"feature_channel": [None, None, "n_counts"],
                   "feature_channel_type": ["X", "raw_X", "obs"],
                   "label_channel": "Group"}),
    ])
    return Compose(*transforms, log_level=log_level)


def zinb_counts_front(counts, gene_names: Sequence, labels, pipeline: Compose) -> ClusteringInputs:
    """``pipeline`` (:func:`zinb_pipeline`) on raw ``counts`` (cells x genes,
    numpy or scipy, taken as float32) named ``gene_names``, wrapped in a
    ``Data``; the kept cells' ``labels`` follow them."""
    names = np.asarray(gene_names)
    if names.shape != (counts.shape[1],):
        raise ValueError(f"{names.size} gene names for {counts.shape[1]} genes")
    data = wrap_matrix(counts, names)
    pipeline(data)
    adata = data.data
    cells = row_positions(adata.obs_names)
    return ClusteringInputs(np.asarray(adata.X), dense32(adata.raw.X),
                            np.asarray(adata.obs["n_counts"]),
                            None if labels is None else np.asarray(labels)[cells],
                            np.asarray(adata.var_names), cells)


def scdeepcluster_preprocess(counts, gene_names: Sequence, labels=None) -> ClusteringInputs:
    """:meth:`ScDeepCluster.preprocessing_pipeline` on raw ``counts`` (cells x
    genes) named ``gene_names``, wrapped in a ``Data``, for a caller that
    holds a matrix."""
    return zinb_counts_front(counts, gene_names, labels,
                             ScDeepCluster.preprocessing_pipeline(log_level="WARNING"))


__all__ = ["ClusteringInputs", "ScDeepCluster", "euclidean_dist", "scdeepcluster_preprocess",
           "zinb_pipeline",
           "zinb_counts_front"]
