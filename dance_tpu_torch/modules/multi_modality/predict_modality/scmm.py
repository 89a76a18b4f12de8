"""scMM: a mixture-of-experts multimodal VAE. Each modality has a Gaussian
encoder; every latent is decoded through both decoders, the counts' by a
negative-binomial decoder and the second modality's by a Gaussian one, so
that decoding the second modality from the first's latent is the
prediction.

Counterpart: dance_tpu/modules/multi_modality/predict_modality/scmm.py
(``_MMVAENet`` :28-81, ``MMVAE`` :84-192, ``Constants``,
``protein_preprocessing``, ``atac_preprocessing`` and ``rna_preprocessing``
:196-225). The encoders see ``log1p(x / max(library, 1) · 1e4)`` of the
counts and ``log1p(max(x₂, 0))`` of the second modality (:54-64). With
``reference_protocol=True`` the log-variance is pinned as the reference
architecture pins it, ``2 log(softmax(clip(lv, ±12)) · z_dim + 1e-6)``
(:39-46). The loss is the NB likelihood of the counts decoded from both
latents, the MSE of the second modality decoded from both, plus 1e-3 times
both Gaussian KLs. An epoch is ``n // batch_size`` batches of a shuffle,
the partial one dropped, one Adam step a batch with fresh normals for each
latent. ``predict`` decodes the first modality's mean latent, with no
noise; ``encode`` gives a modality's mean latent. ``fit`` keeps the weights
of an earlier fit (:157).

Where this differs from the JAX package: the weights come from a CPU
``torch.Generator`` seeded with ``seed``, the batch orders from another and
the normals from a generator on the device through :meth:`MMVAE._noise`
(JAX draws one key a step and splits it; parity tests copy the flax weights
in, :func:`dance_tpu_torch.utils.params.mmvae_flax_to_torch`, and hand
JAX's orders and normals over through a patched ``epoch_batches_dropped``
and ``_noise``); ``history`` records each epoch's mean loss and seconds. No
TPU kernel is on this path.

Under ``fit_distributed`` each rank holds its rows of both modalities;
every rank walks the same batches and draws each batch's normals whole,
computes the loss of the batch's cells it holds as its share, and the
gradients are summed over ``dp``.
"""

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dance_tpu_torch.modules.multi_modality.configs import predict_modality_config
from dance_tpu_torch.modules.base import BaseRegressionMethod, resolve_score_func
from dance_tpu_torch.nn.vae import (GaussianDecoder, GaussianEncoder, NBDecoder, gaussian_kl,
                                    reparameterize, reset_linears)
from dance_tpu_torch.parallel.mesh import RowShard, to_device
from dance_tpu_torch.settings import logger
from dance_tpu_torch.utils import EpochClock, resolve_device
from dance_tpu_torch.utils.batch import epoch_batches_dropped
from dance_tpu_torch.utils.loss import nb_nll


class _MMVAENet(nn.Module):
    """Two Gaussian encoders, an NB decoder of the counts and a Gaussian
    decoder of the second modality (counterpart: :28); ``ref_logvar`` pins
    the log-variance (:39)."""

    def __init__(self, dim1: int, dim2: int, z_dim: int = 16, hidden: Sequence[int] = (128,),
                 ref_logvar: bool = False):
        super().__init__()
        self.ref_logvar = ref_logvar
        self.enc1 = GaussianEncoder(dim1, hidden, z_dim)
        self.enc2 = GaussianEncoder(dim2, hidden, z_dim)
        self.dec1 = NBDecoder(z_dim, hidden, dim1)
        self.dec2 = GaussianDecoder(z_dim, hidden, dim2)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_linears(self, generator)

    def _pin(self, lv: torch.Tensor) -> torch.Tensor:
        """The reference's posterior scale ``softmax(lv) · z_dim + eta`` as a
        log-variance, or ``lv`` itself."""
        if not self.ref_logvar:
            return lv
        lv = torch.clamp(lv, -12, 12)
        return 2.0 * torch.log(torch.softmax(lv, dim=-1) * lv.shape[-1] + 1e-6)

    @staticmethod
    def enc_in1(x1: torch.Tensor) -> torch.Tensor:
        """Counts scaled to a library of 1e4, then ``log1p``."""
        lib = torch.clamp(x1.sum(1, keepdim=True), min=1.0)
        return torch.log1p(x1 / lib * 1e4)

    @staticmethod
    def enc_in2(x2: torch.Tensor) -> torch.Tensor:
        return torch.log1p(torch.clamp(x2, min=0.0))

    def encode(self, x: torch.Tensor, modality: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(mu, logvar)`` of a modality's encoder on its transformed input,
        the log-variance unpinned."""
        if modality == 1:
            return self.enc1(self.enc_in1(x))
        return self.enc2(self.enc_in2(x))

    def forward(self, x1, x2, noise: Tuple[torch.Tensor, torch.Tensor]):
        """The four decodings ``{"11", "21", "12", "22"}`` of the latents
        sampled with the standard normals ``noise`` (one per modality), and
        each modality's ``(mu, logvar)``."""
        mu1, lv1 = self.encode(x1, 1)
        mu2, lv2 = self.encode(x2, 2)
        lv1, lv2 = self._pin(lv1), self._pin(lv2)
        z1 = reparameterize(mu1, lv1, noise[0])
        z2 = reparameterize(mu2, lv2, noise[1])
        lib1 = x1.sum(1, keepdim=True)
        out = {"11": self.dec1(z1, lib1), "21": self.dec1(z2, lib1),
               "12": self.dec2(z1), "22": self.dec2(z2)}
        return out, (mu1, lv1), (mu2, lv2)

    def cross_predict(self, x1: torch.Tensor) -> torch.Tensor:
        """The second modality decoded from the first's mean latent."""
        return self.dec2(self.encode(x1, 1)[0])


def mmvae_loss(net: _MMVAENet, x1, x2, noise) -> torch.Tensor:
    """NB ×2 + MSE ×2 + 1e-3 · (KL₁ + KL₂) (counterpart: the ``loss_fn`` of
    ``_train_epoch``, :116-124)."""
    out, (mu1, lv1), (mu2, lv2) = net(x1, x2, noise)
    ll = (nb_nll(x1, *out["11"]) + nb_nll(x1, *out["21"])
          + torch.mean((out["12"] - x2) ** 2) + torch.mean((out["22"] - x2) ** 2))
    return ll + 1e-3 * (gaussian_kl(mu1, lv1) + gaussian_kl(mu2, lv2))


class MMVAE(BaseRegressionMethod):
    """scMM for modality prediction (counterpart: :84). ``params`` is the
    reference's argument namespace, unused as in JAX. ``device="auto"`` is
    the card."""

    _DISPLAY_ATTRS = ("z_dim",)

    @staticmethod
    def preprocessing_pipeline(log_level: str = "INFO"):
        """The ``SetConfig`` of a ``MuData`` of ``mod1`` and ``mod2``: mod1's
        ``X`` the features, mod2's ``X`` the labels (counterpart: scmm.py:101)."""
        return predict_modality_config(log_level)

    def __init__(self, subtask: str = "", params=None, z_dim: int = 16, seed: int = 0,
                 reference_protocol: bool = False, device="auto"):
        self.subtask, self.z_dim, self.seed = subtask, z_dim, seed
        self.reference_protocol = reference_protocol
        self.device = resolve_device(device)
        self.net: Optional[_MMVAENet] = None
        self.history: List[Dict[str, float]] = []  # per epoch: epoch, loss, seconds

    def _make_net(self, dim1: int, dim2: int) -> _MMVAENet:
        """A new net with its init drawn from ``seed``, on the device."""
        net = _MMVAENet(dim1, dim2, self.z_dim, ref_logvar=self.reference_protocol)
        net.reset_parameters(torch.Generator().manual_seed(self.seed))
        return net.to(self.device)

    def _noise(self, shape, generator: torch.Generator) -> torch.Tensor:
        """Standard normals for one latent of one step, on the device."""
        return torch.randn(shape, generator=generator, device=self.device)

    def fit(self, x_train, y_train, epochs: int = 100, lr: float = 1e-3, batch_size: int = 64):
        """Adam on :func:`mmvae_loss` over every whole batch of each epoch's
        shuffle (counterpart: :153-168)."""
        dev = self.device
        # this rank's rows in a data-parallel fit (scmm.py:152-153)
        x1 = to_device(np.asarray(x_train, np.float32), device=dev)
        x2 = to_device(np.asarray(y_train, np.float32), device=dev)
        shard = RowShard.of(len(x_train))
        if self.net is None:
            self.net = self._make_net(x1.shape[1], x2.shape[1])
        net = self.net
        opt = torch.optim.Adam(net.parameters(), lr=lr)
        order_gen = torch.Generator().manual_seed(self.seed)
        noise_gen = torch.Generator(device=dev).manual_seed(self.seed)
        bs = min(batch_size, shard.n)
        shape = (bs, self.z_dim)
        clock, losses = EpochClock(dev), []
        for _ in range(epochs):
            clock.tick()
            step_losses = []
            for idx in epoch_batches_dropped(order_gen, shard.n, bs).to(dev):
                pos, loc = shard.split(idx)
                noise = (self._noise(shape, noise_gen), self._noise(shape, noise_gen))
                opt.zero_grad(set_to_none=True)
                loss = (mmvae_loss(net, x1[loc], x2[loc], tuple(shard.take(e, pos) for e in noise))
                        if pos is None or len(pos) else None)
                step_losses.append(shard.step(loss, net.parameters(), shard.share(pos, bs)))
                opt.step()
            losses.append(torch.stack(step_losses).mean())
        clock.tick()
        self.history = [{"epoch": e, "loss": float(l), "seconds": s}
                        for e, (l, s) in enumerate(zip(losses, clock.seconds()))]
        for h in self.history[::20]:
            logger.info("scMM epoch %d, loss %.5f", h["epoch"], h["loss"])
        return self

    @torch.no_grad()
    def predict(self, x) -> np.ndarray:
        """The second modality decoded from the first's mean latent."""
        x1 = torch.from_numpy(np.asarray(x, np.float32)).to(self.device)
        return self.net.cross_predict(x1).cpu().numpy()

    @torch.no_grad()
    def encode(self, x, modality: int = 1) -> np.ndarray:
        """The mean latent of modality ``modality`` (1 or 2)."""
        x = torch.from_numpy(np.asarray(x, np.float32)).to(self.device)
        return self.net.encode(x, modality)[0].cpu().numpy()

    def score(self, x, y, *, score_func=None, return_pred: bool = False, **kwargs):
        """RMSE of :meth:`predict` by default."""
        pred = self.predict(x)
        s = resolve_score_func(score_func or "rmse")(np.asarray(y), pred)
        return (s, pred) if return_pred else s


# --------------------------------------------------------------------------
# reference-named helpers (counterpart: :196-225)
# --------------------------------------------------------------------------


class Constants:
    """Numeric constants (counterpart: :196)."""

    eta = 1e-6
    eps = 1e-7
    log2 = math.log(2)
    log2pi = math.log(2 * math.pi)
    logceilc = 88
    logfloorc = -104


def protein_preprocessing(t1) -> torch.Tensor:
    """Centred log-ratio of protein counts: ``log1p`` of the counts over each
    cell's geometric mean of its nonzero counts (counterpart: :208)."""
    t1 = torch.as_tensor(t1, dtype=torch.float32)
    t0 = torch.where(t1 == 0, torch.ones_like(t1), t1)
    geo = torch.exp(torch.log(t0).sum(1) / torch.clamp((t1 > 0).sum(1), min=1))
    return torch.log1p(t1 / geo[:, None])


def atac_preprocessing(t1) -> torch.Tensor:
    """ATAC counts binarised: 1 where positive (counterpart: :218)."""
    t1 = torch.as_tensor(t1)
    return torch.where(t1 > 0, torch.ones_like(t1), t1)


def rna_preprocessing(t1):
    """The counts as they are, as the reference's placeholder (counterpart: :223)."""
    return t1


__all__ = ["Constants", "MMVAE", "atac_preprocessing", "mmvae_loss", "protein_preprocessing",
           "rna_preprocessing"]
