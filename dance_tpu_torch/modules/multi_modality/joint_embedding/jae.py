"""JAE: a joint autoencoder of both modalities side by side whose latent's
leading dimensions are its auxiliary predictions: the cell-type logits, then
the batch logits (trained toward the uniform distribution, to remove the
batch), then two cell-cycle phase scores; the rest is free.

Counterpart: dance_tpu/modules/multi_modality/joint_embedding/jae.py
(``_FullBatchNorm`` :30, ``_JAE`` :39-71, ``JAEWrapper`` :74-203, the
alias ``JAE`` :207, ``random_classification_loss`` :210). The encoder is 3 ×
(Dense → GELU, flax's tanh form → a norm on the statistics of each call →
dropout 0.2) → Dense(``z_dim``); the decoder Dense(150) → ReLU → Dense(in)
→ ReLU. The loss is ``0.7 · MSE`` of the reconstruction, ``+ 0.2 ·`` the
cell-type cross-entropy with labels, ``+ 0.05 · mean(−log_softmax(batch
logits))`` with more than one batch, ``+ 0.05 · MSE`` of the phase scores
whenever the phase slice is not empty (by default two dimensions held to
zeros). Adam at 1e-4 over the wrap-padded shuffle of each epoch
(:func:`~dance_tpu_torch.utils.batch.epoch_batches`), 64 cells a batch.
``predict`` encodes the whole input, the norm's statistics taken over it.

Where this differs from the JAX package: the weights come from a CPU
``torch.Generator`` seeded with ``seed`` (parity tests copy the flax weights
in, :func:`dance_tpu_torch.utils.params.jae_flax_to_torch`), the batch
orders from another and the dropout masks from a generator on the device
through :meth:`JAEWrapper._mask` (tests hand JAX's over); the epochs are a
Python loop; ``history`` records each epoch's mean loss and seconds. No TPU
kernel is on this path.
"""

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dance_tpu_torch.modules.multi_modality.configs import joint_embedding_config
from dance_tpu_torch.modules.base import BaseRegressionMethod
from dance_tpu_torch.nn.gnn import flax_dense_init_
from dance_tpu_torch.nn.mlp import FullBatchNorm, inverted_dropout
from dance_tpu_torch.settings import logger
from dance_tpu_torch.utils import EpochClock, resolve_device
from dance_tpu_torch.utils.batch import epoch_batches
from dance_tpu_torch.utils.metrics import score_embedding

DROPOUT = 0.2  # the encoder's rate (counterpart: :46)


class _JAE(nn.Module):
    """The encoder, the decoder and the latent's slices (counterpart: :39).
    flax's names: ``enc_layers_{i}``, ``enc_norms_{i}``, ``enc_out``,
    ``dec1``, ``dec2``."""

    def __init__(self, in_dim: int, z_dim: int = 61, n_cell_types: int = 0, n_batches: int = 0,
                 n_phases: int = 2, hidden: Sequence[int] = (150, 120, 100)):
        super().__init__()
        self.n_cell_types, self.n_batches, self.n_phases = n_cell_types, n_batches, n_phases
        widths = [in_dim, *hidden]
        self.enc_layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.enc_norms = nn.ModuleList(FullBatchNorm(d) for d in hidden)
        self.enc_out = nn.Linear(hidden[-1], z_dim)
        self.dec1 = nn.Linear(z_dim, hidden[0])
        self.dec2 = nn.Linear(hidden[0], in_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax ``Dense``'s init for every layer in module order; the norms'
        scales 1 and biases 0."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                flax_dense_init_(m, generator)
            elif isinstance(m, FullBatchNorm):
                nn.init.ones_(m.scale)
                nn.init.zeros_(m.bias)

    def encode(self, x: torch.Tensor, drop: Optional[Callable] = None) -> torch.Tensor:
        """The latent; ``drop`` applies dropout after each norm (training)."""
        for lin, norm in zip(self.enc_layers, self.enc_norms):
            x = norm(F.gelu(lin(x), approximate="tanh"))
            if drop is not None:
                x = drop(x)
        return self.enc_out(x)

    def forward(self, x: torch.Tensor, drop: Optional[Callable] = None):
        """``(z, x_hat, cell-type logits, batch logits, phase scores)``."""
        z = self.encode(x, drop)
        x_hat = torch.relu(self.dec2(torch.relu(self.dec1(z))))
        a = self.n_cell_types
        b = a + self.n_batches
        return z, x_hat, z[:, :a], z[:, a:b], z[:, b:b + self.n_phases]


def jae_loss(net: _JAE, x, ct, phase, has_labels: bool,
             drop: Optional[Callable] = None) -> torch.Tensor:
    """A batch's loss (counterpart: the ``loss_fn`` of ``_train_epoch``,
    :97-110)."""
    _, x_hat, ct_logits, b_logits, ph_pred = net(x, drop)
    loss = 0.7 * torch.mean((x_hat - x) ** 2)
    if has_labels:
        loss = loss + 0.2 * F.cross_entropy(ct_logits, ct)
    if b_logits.shape[1] > 1:
        loss = loss + 0.05 * (-torch.log_softmax(b_logits, -1).mean(-1)).mean()
    if ph_pred.shape[1]:
        loss = loss + 0.05 * torch.mean((ph_pred - phase) ** 2)
    return loss


class JAEWrapper(BaseRegressionMethod):
    """JAE (counterpart: :74). ``args`` is the reference's namespace, unused
    as in JAX. ``device="auto"`` is the card."""

    _DISPLAY_ATTRS = ("z_dim",)

    @staticmethod
    def preprocessing_pipeline(log_level: str = "INFO"):
        """The ``SetConfig`` of a ``MuData`` of ``mod1`` and ``mod2``: both
        modalities' ``X`` the features, mod1's ``obs["cell_type"]`` the labels
        (counterpart: jae.py:85)."""
        return joint_embedding_config(log_level)

    def __init__(self, args=None, z_dim: int = 61, seed: int = 0, device="auto"):
        self.z_dim, self.seed = z_dim, seed
        self.device = resolve_device(device)
        self.net: Optional[_JAE] = None
        self.history: List[Dict[str, float]] = []  # per epoch: epoch, loss, seconds

    def _make_net(self, in_dim: int, n_ct: int, n_b: int, n_phases: int) -> _JAE:
        """A new net with its init drawn from ``seed``, on the device."""
        net = _JAE(in_dim, self.z_dim, n_ct, n_b, n_phases)
        net.reset_parameters(torch.Generator().manual_seed(self.seed))
        return net.to(self.device)

    def _mask(self, shape, generator: torch.Generator) -> torch.Tensor:
        """One dropout layer's keep mask for one step (true with probability
        1 - DROPOUT), on the device."""
        return torch.rand(shape, generator=generator, device=self.device) >= DROPOUT

    def fit(self, x_mod1, x_mod2, cell_type=None, batch_label=None, phase_score=None,
            epochs: int = 200, lr: float = 1e-4, batch_size: int = 64):
        """Adam over each epoch's wrap-padded batches (counterpart: :125-165):
        cell types in ``np.unique``'s sorted order, ``max + 1`` batches,
        phase scores zeros when not given."""
        dev = self.device
        x = torch.from_numpy(np.concatenate([np.asarray(x_mod1, np.float32),
                                             np.asarray(x_mod2, np.float32)], axis=1)).to(dev)
        n = x.shape[0]
        has_labels = cell_type is not None
        if has_labels:
            names, ct = np.unique(np.asarray(cell_type), return_inverse=True)
            n_ct = len(names)
        else:
            ct, n_ct = np.zeros(n, np.int64), 0
        if batch_label is not None:
            b = np.unique(np.asarray(batch_label), return_inverse=True)[1]
            n_b = int(b.max()) + 1
        else:
            n_b = 0
        phase = (np.asarray(phase_score, np.float32) if phase_score is not None
                 else np.zeros((n, 2), np.float32))
        self.net = net = self._make_net(x.shape[1], n_ct, n_b, phase.shape[1])
        ct = torch.from_numpy(ct.astype(np.int64)).to(dev)
        phase = torch.from_numpy(phase).to(dev)
        opt = torch.optim.Adam(net.parameters(), lr=lr)
        order_gen = torch.Generator().manual_seed(self.seed)
        mask_gen = torch.Generator(device=dev).manual_seed(self.seed)
        drop = lambda h: inverted_dropout(h, self._mask(h.shape, mask_gen), DROPOUT)  # noqa: E731
        clock, losses = EpochClock(dev), []
        for _ in range(epochs):
            clock.tick()
            step_losses = []
            for idx in epoch_batches(order_gen, n, min(batch_size, n)).to(dev):
                opt.zero_grad(set_to_none=True)
                loss = jae_loss(net, x[idx], ct[idx], phase[idx], has_labels, drop)
                loss.backward()
                opt.step()
                step_losses.append(loss.detach())
            losses.append(torch.stack(step_losses).mean())
        clock.tick()
        self.history = [{"epoch": e, "loss": float(l), "seconds": s}
                        for e, (l, s) in enumerate(zip(losses, clock.seconds()))]
        for h in self.history[::50]:
            logger.info("JAE epoch %d, loss %.5f", h["epoch"], h["loss"])
        self._x = x
        return self

    @torch.no_grad()
    def predict(self, x_mod1=None, x_mod2=None) -> np.ndarray:
        """The latent of the whole input (the training input by default)."""
        if x_mod1 is None:
            x = self._x
        else:
            x = torch.from_numpy(np.concatenate([np.asarray(x_mod1, np.float32),
                                                 np.asarray(x_mod2, np.float32)],
                                                axis=1)).to(self.device)
        return self.net.encode(x).cpu().numpy()

    def score(self, x, y, *, score_func=None, return_pred: bool = False,
              metric: str = "clustering", batch=None, **kwargs):
        """k-means NMI of the embedding against ``y`` (``"clustering"``) or
        the scIB suite's ``final_scores`` (``"openproblems"``) (counterpart:
        :190)."""
        return score_embedding(self.predict(), y, metric=metric, batch=batch, device=self.device,
                               return_pred=return_pred, **kwargs)


# the reference's name for the inner model (counterpart: :207)
JAE = _JAE


def random_classification_loss(y_pred, nb_batches) -> torch.Tensor:
    """Cross-entropy of ``y_pred``'s softmax (+ 1e-7) against the uniform
    distribution over ``len(nb_batches)`` classes, the batch adversary's
    target (counterpart: :210)."""
    y_pred = torch.as_tensor(y_pred)
    n = np.asarray(nb_batches).shape[0]
    return (-(torch.log(torch.softmax(y_pred, -1) + 1e-7)) * (1.0 / n)).sum(-1).mean()


__all__ = ["JAE", "JAEWrapper", "jae_loss", "random_classification_loss"]
