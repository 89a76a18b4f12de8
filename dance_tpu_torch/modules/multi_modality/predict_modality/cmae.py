"""CMAE: two autoencoders whose latents are aligned by an MSE term and by a
discriminator that learns to tell the first modality's latent from the
second's, with cross-modal translation.

Counterpart: dance_tpu/modules/multi_modality/predict_modality/cmae.py
(``_CMAENet`` :28, ``_Disc`` :63, ``CMAE`` :72-218, ``get_model_list``,
``weights_init`` and ``get_scheduler`` :221-266). Every minibatch takes the
discriminator's Adam step first (the first modality's latent labelled 0,
the second's 1), then the generator's step against the updated
discriminator (:150-153): ``recon · (MSE₁₁ + MSE₂₂) + trans · (MSE₁₂ +
MSE₂₁) + adv · BCE(D(z₁), 1) + align · MSE(z₁, z₂)``, with the reference's
weight names ``recon_x_w``, ``trans_w``, ``gan_w`` and ``super_w`` (:84-89).
An epoch is ``n // batch_size`` batches of a shuffle, the partial one
dropped (:139-145). ``fit`` starts from new weights every call.

Where this differs from the JAX package: the weights come from a CPU
``torch.Generator`` seeded with ``seed`` (the generator's, then the
discriminator's) and the batch orders from another (parity tests copy the
flax weights in, :func:`dance_tpu_torch.utils.params.cmae_flax_to_torch`,
and hand JAX's orders over through a patched ``epoch_batches_dropped``);
``checkpoint_directory`` gets ``gen_{epochs:08d}.pt``, a ``torch.save`` of
``{"gen": <generator state_dict>, "dis": <discriminator state_dict>}`` (the
port's format; JAX pickles its parameter trees into ``.pt.pkl``);
``history`` records each epoch's mean losses and seconds. No TPU kernel is
on this path.

Under ``fit_distributed`` each rank holds its rows of both modalities;
every rank walks the same batches, each of the two steps computes the loss
of the batch's cells the rank holds as its share, and the gradients are
summed over ``dp``; rank 0 writes the checkpoint.
"""

import math
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from dance_tpu_torch.modules.multi_modality.configs import predict_modality_config
from dance_tpu_torch.modules.base import BaseRegressionMethod, resolve_score_func
from dance_tpu_torch.nn.gnn import truncated_normal_
from dance_tpu_torch.nn.vae import reset_linears
from dance_tpu_torch.nn.zinb_ae import MLPStack
from dance_tpu_torch.parallel.mesh import RowShard, is_writer, to_device
from dance_tpu_torch.settings import logger
from dance_tpu_torch.utils import EpochClock, resolve_device
from dance_tpu_torch.utils.batch import epoch_batches_dropped
from dance_tpu_torch.utils.loss import binary_ce_logits


class _CMAENet(nn.Module):
    """The two autoencoders, each an ``MLPStack((hidden,))`` and a ``Dense``
    out of either side of the ``z_dim`` latent (counterpart: :28)."""

    def __init__(self, dim1: int, dim2: int, z_dim: int = 32, hidden: int = 128):
        super().__init__()
        self.enc1, self.enc1_out = MLPStack(dim1, (hidden,)), nn.Linear(hidden, z_dim)
        self.enc2, self.enc2_out = MLPStack(dim2, (hidden,)), nn.Linear(hidden, z_dim)
        self.dec1, self.dec1_out = MLPStack(z_dim, (hidden,)), nn.Linear(hidden, dim1)
        self.dec2, self.dec2_out = MLPStack(z_dim, (hidden,)), nn.Linear(hidden, dim2)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_linears(self, generator)

    def encode1(self, x):
        return self.enc1_out(self.enc1(x))

    def encode2(self, x):
        return self.enc2_out(self.enc2(x))

    def decode1(self, z):
        return self.dec1_out(self.dec1(z))

    def decode2(self, z):
        return self.dec2_out(self.dec2(z))

    def forward(self, x1, x2):
        """``(r1, r2, t12, t21, z1, z2)``: reconstructions, translations, latents."""
        z1, z2 = self.encode1(x1), self.encode2(x2)
        return self.decode1(z1), self.decode2(z2), self.decode2(z1), self.decode1(z2), z1, z2


class _Disc(nn.Module):
    """``Dense(hidden)`` ReLU ``Dense(1)`` -> one logit a row (counterpart: :63;
    flax's ``Dense_0`` and ``Dense_1``)."""

    def __init__(self, z_dim: int, hidden: int = 64):
        super().__init__()
        self.hidden, self.out = nn.Linear(z_dim, hidden), nn.Linear(hidden, 1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_linears(self, generator)

    def forward(self, z):
        return self.out(torch.relu(self.hidden(z))).squeeze(-1)


def cmae_disc_loss(net: _CMAENet, disc: _Disc, x1, x2) -> torch.Tensor:
    """The discriminator's loss, the latents held constant (counterpart:
    ``_disc_step``, :120): BCE(D(z₁), 0) + BCE(D(z₂), 1)."""
    with torch.no_grad():
        z1, z2 = net.encode1(x1), net.encode2(x2)
    d1, d2 = disc(z1), disc(z2)
    return binary_ce_logits(d1, torch.zeros_like(d1)) + binary_ce_logits(d2, torch.ones_like(d2))


def cmae_gen_loss(net: _CMAENet, disc: _Disc, x1, x2, w: Dict[str, float]) -> torch.Tensor:
    """The generator's loss against ``disc`` (counterpart: ``_gen_step``, :98)."""
    r1, r2, t12, t21, z1, z2 = net(x1, x2)
    recon = torch.mean((r1 - x1) ** 2) + torch.mean((r2 - x2) ** 2)
    trans = torch.mean((t12 - x2) ** 2) + torch.mean((t21 - x1) ** 2)
    d_out = disc(z1)  # z1 should pass for the second modality's latent
    adv = binary_ce_logits(d_out, torch.ones_like(d_out))
    align = torch.mean((z1 - z2) ** 2)
    return w["recon"] * recon + w["trans"] * trans + w["adv"] * adv + w["align"] * align


class CMAE(BaseRegressionMethod):
    """CMAE for modality prediction (counterpart: :72). ``device="auto"`` is
    the card."""

    _DISPLAY_ATTRS = ("z_dim", "hidden")

    @staticmethod
    def preprocessing_pipeline(log_level: str = "INFO"):
        """The ``SetConfig`` of a ``MuData`` of ``mod1`` and ``mod2``: mod1's
        ``X`` the features, mod2's ``X`` the labels (counterpart: cmae.py:92)."""
        return predict_modality_config(log_level)

    def __init__(self, hyperparameters=None, dim1: int = 0, dim2: int = 0, z_dim: int = 32,
                 hidden: int = 128, seed: int = 0, device="auto"):
        self.hyper = hyperparameters or {}
        self.z_dim, self.hidden, self.seed = z_dim, hidden, seed
        self.device = resolve_device(device)
        # the reference's weight names -> the loss terms (cmae.py:84-89)
        self.loss_weights = {"recon": float(self.hyper.get("recon_x_w", 1.0)),
                             "trans": float(self.hyper.get("trans_w", 1.0)),
                             "adv": float(self.hyper.get("gan_w", 0.1)),
                             "align": float(self.hyper.get("super_w", 0.5))}
        self.net: Optional[_CMAENet] = None
        self.disc: Optional[_Disc] = None
        self.history: List[Dict[str, float]] = []  # per epoch: epoch, g_loss, d_loss, seconds

    def _make_nets(self, dim1: int, dim2: int):
        """A new generator and discriminator, drawn in that order from one
        generator seeded with ``seed``, on the device."""
        gen = torch.Generator().manual_seed(self.seed)
        net, disc = _CMAENet(dim1, dim2, self.z_dim, self.hidden), _Disc(self.z_dim)
        net.reset_parameters(gen)
        disc.reset_parameters(gen)
        return net.to(self.device), disc.to(self.device)

    def fit(self, x_train, y_train, epochs: int = 200, lr: float = 1e-3, batch_size: int = 64,
            checkpoint_directory: Optional[str] = None):
        """Alternating Adam steps, discriminator then generator, on each
        whole batch of every epoch's shuffle (counterpart: :160-201)."""
        dev = self.device
        # this rank's rows in a data-parallel fit (cmae.py:167-168)
        x1 = to_device(np.asarray(x_train, np.float32), device=dev)
        x2 = to_device(np.asarray(y_train, np.float32), device=dev)
        shard = RowShard.of(len(x_train))
        self.net, self.disc = net, disc = self._make_nets(x1.shape[1], x2.shape[1])
        g_opt = torch.optim.Adam(net.parameters(), lr=lr)
        d_opt = torch.optim.Adam(disc.parameters(), lr=lr)
        order_gen = torch.Generator().manual_seed(self.seed)
        bs = min(batch_size, shard.n)
        clock, rows = EpochClock(dev), []
        for _ in range(epochs):
            clock.tick()
            g_losses, d_losses = [], []
            for idx in epoch_batches_dropped(order_gen, shard.n, bs).to(dev):
                pos, loc = shard.split(idx)
                share = shard.share(pos, len(idx))
                mine = pos is None or len(pos) > 0
                bx1, bx2 = x1[loc], x2[loc]
                d_opt.zero_grad(set_to_none=True)
                d_loss = cmae_disc_loss(net, disc, bx1, bx2) if mine else None
                d_losses.append(shard.step(d_loss, disc.parameters(), share))
                d_opt.step()
                # the generator's backward also fills the discriminator's
                # gradients, which its next step sets to None first
                g_opt.zero_grad(set_to_none=True)
                g_loss = cmae_gen_loss(net, disc, bx1, bx2, self.loss_weights) if mine else None
                g_losses.append(shard.step(g_loss, net.parameters(), share))
                g_opt.step()
            rows.append((torch.stack(g_losses).mean(), torch.stack(d_losses).mean()))
        clock.tick()
        self.history = [{"epoch": e, "g_loss": float(g), "d_loss": float(d), "seconds": s}
                        for e, ((g, d), s) in enumerate(zip(rows, clock.seconds()))]
        for h in self.history[::50]:
            logger.info("CMAE epoch %d, G %.5f D %.5f", h["epoch"], h["g_loss"], h["d_loss"])
        if checkpoint_directory is not None and is_writer(shard.mesh):
            os.makedirs(checkpoint_directory, exist_ok=True)
            path = os.path.join(checkpoint_directory, f"gen_{epochs:08d}.pt")
            torch.save({"gen": net.state_dict(), "dis": disc.state_dict()}, path)
            logger.info("CMAE checkpoint written to %s", path)
        return self

    @torch.no_grad()
    def predict(self, x) -> np.ndarray:
        """The second modality translated from the first."""
        x1 = torch.from_numpy(np.asarray(x, np.float32)).to(self.device)
        return self.net.decode2(self.net.encode1(x1)).cpu().numpy()

    @torch.no_grad()
    def encode(self, x, modality: int = 1) -> np.ndarray:
        """The latent of modality ``modality`` (1 or 2)."""
        x = torch.from_numpy(np.asarray(x, np.float32)).to(self.device)
        return (self.net.encode1 if modality == 1 else self.net.encode2)(x).cpu().numpy()

    def score(self, x, y, *, score_func=None, return_pred: bool = False, **kwargs):
        """RMSE of :meth:`predict` by default."""
        pred = self.predict(x)
        s = resolve_score_func(score_func or "rmse")(np.asarray(y), pred)
        return (s, pred) if return_pred else s


# --------------------------------------------------------------------------
# reference-named helpers (counterpart: :221-266)
# --------------------------------------------------------------------------


def get_model_list(dirname: str, key: str) -> Optional[str]:
    """The last, by name, of the files in ``dirname`` whose names hold ``key``
    and ``.pt`` (counterpart: :221); None without one."""
    if not os.path.exists(dirname):
        return None
    models = [os.path.join(dirname, f) for f in os.listdir(dirname)
              if os.path.isfile(os.path.join(dirname, f)) and key in f and ".pt" in f]
    return sorted(models)[-1] if models else None


def _fan_in_normal(scale: float):
    """flax's ``variance_scaling(scale, "fan_in", "truncated_normal")`` on a
    torch weight (out, in)."""
    return lambda w, generator=None: truncated_normal_(w, math.sqrt(scale / w.shape[1]),
                                                       generator)


_INITS = {
    "gaussian": lambda w, generator=None: nn.init.normal_(w, 0.0, 0.02, generator=generator),
    "xavier": lambda w, generator=None: nn.init.xavier_normal_(w, generator=generator),
    "kaiming": _fan_in_normal(2.0),
    "orthogonal": lambda w, generator=None: nn.init.orthogonal_(w, generator=generator),
    "default": _fan_in_normal(1.0),
}


def weights_init(init_type: str = "gaussian") -> Callable:
    """The initialiser of a reference name, as an in-place function of a
    torch weight and an optional generator (counterpart: :236, which returns
    flax's initialiser of the same name: normal(0.02), Xavier normal,
    He (kaiming) truncated normal, orthogonal, lecun truncated normal)."""
    if init_type not in _INITS:
        raise AssertionError(f"Unsupported initialization: {init_type}")
    return _INITS[init_type]


def get_scheduler(hyperparameters: dict, iterations: int = -1) -> Callable[[int], float]:
    """The learning rate as a function of the step count, as the optax
    schedule of the reference's hyperparameters (counterpart: :254):
    ``lr_policy`` None or ``"constant"`` gives ``lr`` (1e-4 by default),
    ``"step"`` gives ``lr · gamma^(count // step_size)`` (torch's StepLR)."""
    policy = hyperparameters.get("lr_policy")
    lr = hyperparameters.get("lr", 1e-4)
    if policy is None or policy == "constant":
        return lambda count: lr
    if policy == "step":
        step, gamma = hyperparameters["step_size"], hyperparameters.get("gamma", 0.1)
        return lambda count: lr * gamma ** (count // step)
    raise NotImplementedError(f"learning rate policy [{policy}] is not implemented")


__all__ = ["CMAE", "cmae_disc_loss", "cmae_gen_loss", "get_model_list", "get_scheduler",
           "weights_init"]
