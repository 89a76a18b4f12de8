"""ACTINN cell-type annotation: an MLP classifier trained on L2-regularised
NLL over shuffled minibatches.

Counterpart: dance_tpu/modules/single_modality/cell_type_annotation/
actinn.py (``preprocessing_pipeline`` :56-68, ``_loss_fn`` :71-79, the epoch
scan :82-108, ``fit`` :110-139, ``predict_proba``/``predict`` :210-218). The
network is :class:`~dance_tpu_torch.nn.mlp.VanillaMLP` (Linear + ReLU,
Xavier-uniform kernels, zero biases). The loss is the NLL of the true type,
averaged over a batch's real cells (the last batch of an epoch is padded
and masked, :func:`~dance_tpu_torch.utils.batch.epoch_batches_masked`),
plus ``lambd`` times the sum of the squared Linear weights (biases left
out). Adam's learning rate decays by 0.95 every 1,000 steps (optax's
staircase ``exponential_decay``, here ``StepLR`` stepped once per step).

Where this differs from the JAX package:

- The weights are drawn at each ``fit`` from a CPU ``torch.Generator``
  seeded with ``seed``, and the epochs' batch orders from another; parity
  tests copy the flax weights in
  (:func:`dance_tpu_torch.utils.params.actinn_flax_to_torch`, through a
  patched :meth:`ACTINN._make_net`) and the batches from the JAX run. The
  epochs are a loop; JAX runs them as one compiled scan.
- ``history`` records each epoch's mean loss and seconds.
- JAX's ``dtype=bfloat16`` option is not ported (ROADMAP Queue 1).
  :func:`actinn_preprocess` is the array front of
  ``preprocessing_pipeline``: it runs the pipeline on a matrix and gene
  names wrapped in a ``Data``.

``fit_distributed`` is JAX's own data-parallel protocol (actinn.py:141-208),
run as one rank of a launched process group: a global batch of
``max(batch_size // dp, 1) * dp`` cells, ``max(n // bs, 1)`` batches an
epoch from ``np.random.default_rng(seed)`` with the tail dropped, this
rank's ``bs / dp`` consecutive rows of each batch, Adam on the staircase
decay, the gradients summed over ``dp``.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from dance_tpu_torch.data import AnnData, Data, Frame
from dance_tpu_torch.modules.base import BaseClassificationMethod
from dance_tpu_torch.nn.mlp import VanillaMLP
from dance_tpu_torch.parallel.mesh import current_mesh, sync_grads
from dance_tpu_torch.settings import logger
from dance_tpu_torch.transforms.filter import FilterGenesPercentile
from dance_tpu_torch.transforms.interface import AnnDataTransform
from dance_tpu_torch.transforms.misc import Compose, SetConfig
from dance_tpu_torch.utils import EpochClock, resolve_device
from dance_tpu_torch.utils.batch import epoch_batches_masked


def actinn_loss(net: VanillaMLP, x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                lambd: float) -> torch.Tensor:
    """The masked NLL of the labels ``y`` plus ``lambd`` x the squared sum of
    every Linear weight (counterpart: actinn.py:71)."""
    logp = F.log_softmax(net(x).float(), dim=-1)
    nll = -(logp.gather(1, y[:, None]).squeeze(1) * mask)
    loss = nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + lambd * sum((layer.weight ** 2).sum() for layer in net.layers)


class ACTINN(BaseClassificationMethod):
    """ACTINN classifier (counterpart: actinn.py:29). ``fit(x, y)`` takes
    (cells x genes) features and one-hot (cells x types) or integer labels;
    ``predict`` is the argmax of the logits."""

    _DISPLAY_ATTRS = ("hidden_dims", "lambd")

    def __init__(self, *, hidden_dims: Tuple[int, ...] = (100, 50, 25), lambd: float = 0.01,
                 device="auto", random_seed: Optional[int] = None):
        self.hidden_dims = tuple(hidden_dims)
        self.lambd = lambd
        self.device = resolve_device(device)
        self.random_seed = random_seed
        self.model: Optional[VanillaMLP] = None
        self.history: List[Dict[str, float]] = []  # per epoch: epoch, loss, seconds

    @staticmethod
    def preprocessing_pipeline(normalize: bool = True, filter_genes: bool = True,
                               log_level: str = "INFO", device="auto") -> Compose:
        """ACTINN's preprocessing of a ``Data`` (:func:`actinn_preprocess`
        runs it on a matrix): ``normalize_total(1e4)`` and ``log1p(base=2)``,
        the genes expressed in a cell, then between the 1st and 99th
        percentile of their sums and of their coefficients of variation;
        labels from ``obsm["cell_type"]`` (counterpart: actinn.py:56). Every
        step is host work; ``device`` is only checked (the card unless the
        CPU is named), as for every entry point."""
        resolve_device(device)
        transforms = []
        if normalize:
            transforms.append(AnnDataTransform("sc.pp.normalize_total", target_sum=1e4))
            transforms.append(AnnDataTransform("sc.pp.log1p", base=2))
        if filter_genes:
            transforms.append(AnnDataTransform("sc.pp.filter_genes", min_cells=1))
            transforms.append(FilterGenesPercentile(min_val=1, max_val=99, mode="sum"))
            transforms.append(FilterGenesPercentile(min_val=1, max_val=99, mode="cv"))
        transforms.append(SetConfig({"label_channel": "cell_type"}))
        return Compose(*transforms, log_level=log_level)

    def _make_net(self, input_dim: int, output_dim: int, seed: int) -> VanillaMLP:
        """A new network with flax's init drawn from ``seed``, on the device."""
        net = VanillaMLP(input_dim, output_dim, self.hidden_dims)
        net.reset_parameters(torch.Generator().manual_seed(seed))
        return net.to(self.device)

    def fit(self, x_train, y_train, *, batch_size: int = 128, lr: float = 0.01,
            num_epochs: int = 50, print_cost: bool = False, seed: Optional[int] = None):
        """Train new weights for ``num_epochs`` epochs of shuffled batches of
        ``batch_size`` (counterpart: actinn.py:110)."""
        x = np.asarray(x_train.toarray() if sp.issparse(x_train) else x_train, np.float32)
        y = np.asarray(y_train)
        output_dim = int(y.shape[1]) if y.ndim == 2 else int(y.max()) + 1
        y = y.argmax(1) if y.ndim == 2 else y
        seed = self.random_seed if seed is None else seed
        seed = 0 if seed is None else seed
        dev = self.device
        self.model = net = self._make_net(x.shape[1], output_dim, seed)
        xt = torch.from_numpy(x).to(dev)
        yt = torch.from_numpy(y.astype(np.int64)).to(dev)
        opt = torch.optim.Adam(net.parameters(), lr=lr)
        # optax's staircase exponential_decay(lr, 1000, 0.95), read per step
        sched = torch.optim.lr_scheduler.StepLR(opt, step_size=1000, gamma=0.95)
        gen = torch.Generator().manual_seed(seed)
        bs = min(batch_size, x.shape[0])
        clock, losses = EpochClock(dev), []
        for _ in range(num_epochs):
            clock.tick()
            idx, mask = epoch_batches_masked(gen, x.shape[0], bs)
            idx, mask = idx.to(dev), mask.to(dev)
            batch_losses = []
            for rows, m in zip(idx, mask):
                opt.zero_grad(set_to_none=True)
                loss = actinn_loss(net, xt[rows], yt[rows], m, self.lambd)
                loss.backward()
                opt.step()
                sched.step()
                batch_losses.append(loss.detach())
            losses.append(torch.stack(batch_losses).mean())
        clock.tick()
        self.history = [{"epoch": e, "loss": float(l), "seconds": s}
                        for e, (l, s) in enumerate(zip(losses, clock.seconds()))]
        if print_cost:
            for h in self.history[::10]:
                logger.info("Epoch: %4d Loss: %6.4f", h["epoch"], h["loss"])
        return self

    def fit_distributed(self, x_train, y_train, *, mesh=None, batch_size: int = 128,
                        lr: float = 0.01, num_epochs: int = 50, seed: Optional[int] = None):
        """Data-parallel fit over the ``dp`` ranks of ``mesh`` (the current
        mesh when None; counterpart: actinn.py:141). The weights are drawn
        from ``seed`` on every rank alike; ``history`` records each epoch's
        mean global loss and seconds."""
        mesh = mesh or current_mesh(self.device)
        ndev, i = mesh.size("dp"), mesh.index("dp")
        x = np.asarray(x_train.toarray() if sp.issparse(x_train) else x_train, np.float32)
        y = np.asarray(y_train)
        output_dim = int(y.shape[1]) if y.ndim == 2 else int(y.max()) + 1
        y = (y.argmax(1) if y.ndim == 2 else y).astype(np.int64)
        bs = max(batch_size // ndev, 1) * ndev
        per = bs // ndev
        n = x.shape[0]
        nb = max(n // bs, 1)
        seed = self.random_seed if seed is None else seed
        seed = 0 if seed is None else seed
        rng = np.random.default_rng(seed)
        dev = self.device
        self.model = net = self._make_net(x.shape[1], output_dim, seed)
        params = list(net.parameters())
        opt = torch.optim.Adam(params, lr=lr)
        sched = torch.optim.lr_scheduler.StepLR(opt, step_size=1000, gamma=0.95)
        ones = torch.ones(per, device=dev)
        clock, losses = EpochClock(dev), []
        for _ in range(num_epochs):
            clock.tick()
            rows = rng.permutation(n)[:nb * bs].reshape(nb, bs)[:, i * per:(i + 1) * per]
            xb = torch.from_numpy(x[rows]).to(dev)
            yb = torch.from_numpy(y[rows]).to(dev)
            batch_losses = []
            for bx, by in zip(xb, yb):
                opt.zero_grad(set_to_none=True)
                share = actinn_loss(net, bx, by, ones, self.lambd) / ndev
                share.backward()
                batch_losses.append(sync_grads(params, mesh, extra=share.detach())
                                    if ndev > 1 else share.detach())
                opt.step()
                sched.step()
            losses.append(torch.stack(batch_losses).mean())
        clock.tick()
        self.history = [{"epoch": e, "loss": float(l), "seconds": s}
                        for e, (l, s) in enumerate(zip(losses, clock.seconds()))]
        return self

    @torch.no_grad()
    def _logits(self, x) -> torch.Tensor:
        x = np.asarray(x.toarray() if sp.issparse(x) else x, np.float32)
        return self.model(torch.from_numpy(x).to(self.device)).float()

    def predict_proba(self, x) -> np.ndarray:
        return torch.softmax(self._logits(x), dim=-1).cpu().numpy()

    def predict(self, x) -> np.ndarray:
        return self._logits(x).argmax(-1).cpu().numpy()


def actinn_preprocess(counts, gene_names: Sequence) -> Tuple[np.ndarray, np.ndarray]:
    """:meth:`ACTINN.preprocessing_pipeline` on raw ``counts`` (cells x
    genes, numpy or scipy, taken as float32) named ``gene_names``, wrapped in
    a ``Data``, for a caller that holds a matrix: ``normalize_total(1e4)``,
    ``log1p(base=2)``, the genes expressed in at least one cell, then the
    genes between the 1st and 99th percentile of their sums, then of their
    coefficients of variation. Every step is host numpy, so the pipeline is
    built for the CPU. Returns the dense float32 features and the kept gene
    names, in sorted-name order as the JAX filters leave them."""
    x = sp.csr_matrix(counts, dtype=np.float32) if sp.issparse(counts) \
        else np.asarray(counts, np.float32)
    names = np.asarray(gene_names)
    if names.shape != (x.shape[1],):
        raise ValueError(f"{names.size} gene names for {x.shape[1]} genes")
    data = Data(AnnData(x, var=Frame(index=names)))
    ACTINN.preprocessing_pipeline(log_level="WARNING", device="cpu")(data)
    x = data.data.X
    return (np.asarray(x.toarray() if sp.issparse(x) else x, np.float32),
            np.asarray(data.data.var_names))


__all__ = ["ACTINN", "actinn_loss", "actinn_preprocess"]
