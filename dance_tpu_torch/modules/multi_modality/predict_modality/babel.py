"""BABEL: two autoencoders whose latents cross, so that each modality is
decoded from either encoder: counts through a negative-binomial decoder,
the second modality through a dense one.

Counterpart: dance_tpu/modules/multi_modality/predict_modality/babel.py
(``_Babel`` :30, ``BabelWrapper`` :63-251, ``Exp``, ``ClippedSoftplus`` and
``recursive_to_device`` :254-290). The loss is the NB likelihood of the
counts decoded from both latents, the MSE of the second modality decoded
from both, and 0.1 times the MSE between the latents (:95-102). The
encoders see ``log1p`` of the counts; the NB decoder scales its softmax by
each cell's library. An epoch visits every training cell in wrap-padded
batches (:func:`~dance_tpu_torch.utils.batch.epoch_batches`, JAX's layout:
the reference's loader gives a short last batch instead), one Adam step a
batch. With ``val_ratio > 0`` the held-out cells' RMSE of the cross-modal
prediction selects the best epoch's weights (a strictly lower RMSE) and
stops the fit once ``epoch > earlystop`` and ``epoch - best_epoch >=
earlystop`` (:140-176). ``fit`` keeps the weights of an earlier fit (:208).

Where this differs from the JAX package: the weights come from a CPU
``torch.Generator`` seeded with ``seed`` and the batch orders from another
(parity tests copy the flax weights in,
:func:`dance_tpu_torch.utils.params.babel_flax_to_torch`, and hand JAX's
orders over through a patched ``epoch_batches``); the epochs are a loop that
reads the validation RMSE once an epoch (JAX runs them in one
``while_loop``); ``history`` records each epoch's loss, validation RMSE and
seconds. No TPU kernel is on this path: float32 GEMMs and elementwise
passes.

Under ``fit_distributed`` each rank holds its rows of the train and
held-out cells; every rank walks the same batches, computes the loss of
the batch's cells it holds as its share of the batch, and the gradients are
summed over ``dp``; the held-out squared errors are summed over the ranks,
so every rank selects the same epoch.
"""

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from dance_tpu_torch.modules.multi_modality.configs import predict_modality_config
from dance_tpu_torch.modules.base import BaseRegressionMethod, resolve_score_func
from dance_tpu_torch.nn.vae import NBDecoder, reset_linears
from dance_tpu_torch.nn.zinb_ae import MLPStack
from dance_tpu_torch.parallel.mesh import RowShard, to_device
from dance_tpu_torch.settings import logger
from dance_tpu_torch.utils import EpochClock, resolve_device
from dance_tpu_torch.utils.batch import epoch_batches
from dance_tpu_torch.utils.loss import nb_nll
from dance_tpu_torch.utils.optim import best_state


class _Babel(nn.Module):
    """Two ``MLPStack`` encoders (2 hidden, hidden), an NB decoder of the
    counts and a dense decoder of the second modality (counterpart: :30)."""

    def __init__(self, dim1: int, dim2: int, hidden: int = 64):
        super().__init__()
        self.enc1 = MLPStack(dim1, (hidden * 2, hidden))
        self.enc2 = MLPStack(dim2, (hidden * 2, hidden))
        self.dec1 = NBDecoder(hidden, (hidden,), dim1)
        self.dec2_stack = MLPStack(hidden, (hidden,))
        self.dec2_out = nn.Linear(hidden, dim2)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_linears(self, generator)

    def dec2(self, z: torch.Tensor) -> torch.Tensor:
        return self.dec2_out(self.dec2_stack(z))

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, lib1: torch.Tensor):
        """The four decodings ``{"11", "21", "12", "22"}`` (source, target
        modality) and both latents."""
        z1 = self.enc1(torch.log1p(x1))
        z2 = self.enc2(x2)
        out = {"11": self.dec1(z1, lib1), "21": self.dec1(z2, lib1),
               "12": self.dec2(z1), "22": self.dec2(z2)}
        return out, z1, z2


def babel_loss(net: _Babel, x1: torch.Tensor, x2: torch.Tensor,
               lib1: torch.Tensor) -> torch.Tensor:
    """NB ×2 + MSE ×2 + 0.1 · latent MSE (counterpart: the ``loss_fn`` of
    ``_train_epoch``, :95-102); ``lib1`` is (n, 1)."""
    out, z1, z2 = net(x1, x2, lib1)
    return (nb_nll(x1, *out["11"]) + nb_nll(x1, *out["21"])
            + torch.mean((out["12"] - x2) ** 2) + torch.mean((out["22"] - x2) ** 2)
            + 0.1 * torch.mean((z1 - z2) ** 2))


class BabelWrapper(BaseRegressionMethod):
    """BABEL for modality prediction (counterpart: :63). ``device="auto"`` is
    the card."""

    _DISPLAY_ATTRS = ("hidden",)

    @staticmethod
    def preprocessing_pipeline(log_level: str = "INFO"):
        """The ``SetConfig`` of a ``MuData`` of ``mod1`` and ``mod2``: mod1's
        ``X`` the features, mod2's ``X`` the labels (counterpart: babel.py:78)."""
        return predict_modality_config(log_level)

    def __init__(self, args=None, dim_in: int = 0, dim_out: int = 0, hidden: int = 64,
                 device="auto", seed: int = 0):
        self.dim_in, self.dim_out, self.hidden, self.seed = dim_in, dim_out, hidden, seed
        self.device = resolve_device(device)
        self.net: Optional[_Babel] = None
        self.history: List[Dict[str, float]] = []  # per epoch: epoch, loss, val, seconds

    def _make_net(self, dim1: int, dim2: int) -> _Babel:
        """A new net with its init drawn from ``seed``, on the device."""
        net = _Babel(dim1, dim2, self.hidden)
        net.reset_parameters(torch.Generator().manual_seed(self.seed))
        return net.to(self.device)

    @torch.no_grad()
    def _cross(self, x1: torch.Tensor) -> torch.Tensor:
        """The second modality decoded from the counts' latent."""
        return self.net.dec2(self.net.enc1(torch.log1p(x1)))

    def fit(self, x_train, y_train, val_ratio: float = 0.15, epochs: int = 100,
            lr: float = 1e-3, batch_size: int = 64, earlystop: int = 20):
        """Adam on :func:`babel_loss` (counterpart: :178-232). ``x_train``
        holds counts; with more than 20 cells, the last ``int(n * val_ratio)``
        of a permutation from ``default_rng(seed)`` are held out for the
        best-epoch selection and the early stop; ``val_ratio=0`` trains on
        every cell with no selection."""
        x1_all = np.asarray(x_train, np.float32)
        x2_all = np.asarray(y_train, np.float32)
        n = x1_all.shape[0]
        n_val = int(n * val_ratio) if n > 20 else 0
        perm = np.random.default_rng(self.seed).permutation(n)
        tr, va = perm[:n - n_val or None], perm[n - n_val:]
        dev = self.device

        def on_device(a):  # this rank's rows in a data-parallel fit (:201-204)
            return to_device(np.ascontiguousarray(a), device=dev)

        x1, x2 = on_device(x1_all[tr]), on_device(x2_all[tr])
        shard, vshard = RowShard.of(len(tr)), RowShard.of(n_val)
        lib1 = x1.sum(1, keepdim=True)
        if self.net is None:
            self.net = self._make_net(x1.shape[1], x2.shape[1])
        net = self.net
        opt = torch.optim.Adam(net.parameters(), lr=lr)
        gen = torch.Generator().manual_seed(self.seed)
        bs = min(batch_size, len(tr))
        xv1, xv2 = (on_device(x1_all[va]), on_device(x2_all[va])) if n_val else (None, None)
        best_val, best_epoch, best = np.inf, 0, best_state(net)
        clock, rows = EpochClock(dev), []
        for epoch in range(epochs):
            clock.tick()
            losses = []
            for idx in epoch_batches(gen, len(tr), bs).to(dev):
                pos, loc = shard.split(idx)
                opt.zero_grad(set_to_none=True)
                loss = (babel_loss(net, x1[loc], x2[loc], lib1[loc])
                        if pos is None or len(pos) else None)
                losses.append(shard.step(loss, net.parameters(), shard.share(pos, len(idx))))
                opt.step()
            val = None
            if n_val:
                # the held-out RMSE (counterpart: ``_val_rmse``, :117), its
                # squared errors summed over the ranks
                r = vshard.real
                sq = vshard.sum(((self._cross(xv1[:r]) - xv2[:r]) ** 2).sum())
                val = float(torch.sqrt(sq / (n_val * xv2.shape[1])))
                if val < best_val:
                    best_val, best_epoch, best = val, epoch, best_state(net)
            rows.append((epoch, torch.stack(losses).mean(), val))
            if n_val and epoch > earlystop and epoch - best_epoch >= earlystop:
                logger.info("BABEL early stopped at epoch %d (val RMSE %.5f)", epoch, best_val)
                break
        clock.tick()
        self.history = [{"epoch": e, "loss": float(l), "val": v, "seconds": s}
                        for (e, l, v), s in zip(rows, clock.seconds())]
        if n_val:
            net.load_state_dict(best)
            logger.info("BABEL best val RMSE %.5f at epoch %d (%d epochs run)", best_val,
                        best_epoch, len(rows))
        self.best_val, self.best_epoch = best_val, best_epoch
        for h in self.history[::20]:
            logger.info("BABEL epoch %d, loss %.5f", h["epoch"], h["loss"])
        return self

    def predict(self, x) -> np.ndarray:
        """The second modality decoded from the counts' latent."""
        return self._cross(torch.from_numpy(np.asarray(x, np.float32)).to(self.device)).cpu() \
            .numpy()

    def score(self, x, y, *, score_func=None, return_pred: bool = False, **kwargs):
        """RMSE of :meth:`predict` by default."""
        pred = self.predict(x)
        s = resolve_score_func(score_func or "rmse")(np.asarray(y), pred)
        return (s, pred) if return_pred else s


# --------------------------------------------------------------------------
# reference-named helpers (counterpart: :254-290)
# --------------------------------------------------------------------------


class Exp:
    """``exp`` clamped to [``minimum``, ``maximum``] (counterpart: :254,
    DCA's values); callable on tensors."""

    def __init__(self, minimum: float = 1e-5, maximum: float = 1e6):
        self.min_value, self.max_value = minimum, maximum

    def __call__(self, x) -> torch.Tensor:
        return torch.clamp(torch.exp(torch.as_tensor(x)), self.min_value, self.max_value)

    forward = __call__


class ClippedSoftplus:
    """``softplus(beta x) / beta`` (``x`` itself past ``threshold``) clamped to
    [``minimum``, ``maximum``] (counterpart: :268); softplus as
    ``logaddexp(x, 0)``, as ``jax.nn.softplus`` computes it."""

    def __init__(self, beta: float = 1, threshold: float = 20, minimum: float = 1e-4,
                 maximum: float = 1e3):
        self.beta, self.threshold = beta, threshold
        self.min_value, self.max_value = minimum, maximum

    def __call__(self, x) -> torch.Tensor:
        x = torch.as_tensor(x)
        bx = self.beta * x
        sp = torch.where(bx > self.threshold, x, torch.logaddexp(bx, torch.zeros_like(bx))
                         / self.beta)
        return torch.clamp(sp, self.min_value, self.max_value)

    forward = __call__


def recursive_to_device(t, device="auto"):
    """Tensors of a nested dict / list / tuple moved to ``device`` (the card
    unless the CPU is named), other leaves as they are (counterpart: :287)."""
    device = resolve_device(device)
    if isinstance(t, torch.Tensor):
        return t.to(device)
    if isinstance(t, dict):
        return {k: recursive_to_device(v, device) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(recursive_to_device(v, device) for v in t)
    return t


__all__ = ["BabelWrapper", "ClippedSoftplus", "Exp", "babel_loss", "recursive_to_device"]
