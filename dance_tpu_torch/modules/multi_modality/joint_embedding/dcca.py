"""DCCA: one VAE per modality, trained in alternating cycles in which the
frozen model's latent pulls on the training model's through an
attention-transfer loss. The joint embedding is both latent means side by
side.

Counterpart: dance_tpu/modules/multi_modality/joint_embedding/dcca.py
(``_MLP`` :31, ``_ModalityVAE`` :43-97, ``_gaussian_kl`` :100,
``_make_attention`` :105-128, ``DCCA`` :131-331). A modality VAE is a
ReLU + dropout encoder (:class:`~dance_tpu_torch.nn.mlp.DropoutMLP`), mean
and log-variance heads, the reparameterised latent, a decoder stack and a
likelihood head: negative binomial or ZINB (the mean ``exp(log_sf) ·
softmax(dec_scale)``, the dispersion ``exp(clip(·, ±15))``, the dropout
probability a sigmoid), or Bernoulli (a sigmoid, clipped to [1e-7, 1 −
1e-7] in the likelihood). A phase minimises the mean over cells of the
negative log-likelihood, ``min(1, epoch / 10)`` times the Gaussian KL and,
with attention, ``sf`` times the attention loss against the frozen model's
latent (``sf2`` while modality 1 trains, ``sf1`` while modality 2 does),
with a fresh AdamW (decay 5e-4 on every weight) a phase. The frozen model's
latent, mean and log-variance are computed once a phase, in evaluation
mode. Cycle 0 trains modality 1 alone; cycle 1 modality 2 without, then
with attention; later even cycles modality 1 and odd cycles modality 2,
with attention. ``batch_size=None`` is one full-batch step an epoch;
otherwise each epoch walks the wrap-padded shuffle
(:func:`~dance_tpu_torch.utils.batch.epoch_batches`).

Where this differs from the JAX package: the weights come from a CPU
``torch.Generator`` seeded with ``seed`` (parity tests copy the flax
weights in, :func:`dance_tpu_torch.utils.params.dcca_flax_to_torch`), the
batch orders from another CPU generator, the latent's normals and the
dropout masks from a generator on the device through :meth:`DCCA._noise`
and :meth:`DCCA._mask` (tests hand JAX's over); the phases are Python
loops; ``history`` records every epoch's phase, loss and seconds. No TPU
kernel is on this path.
"""

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dance_tpu_torch.modules.multi_modality.configs import joint_embedding_config
from dance_tpu_torch.modules.base import BaseRegressionMethod
from dance_tpu_torch.nn.mlp import DropoutMLP, inverted_dropout
from dance_tpu_torch.nn.vae import reset_linears
from dance_tpu_torch.settings import logger
from dance_tpu_torch.utils import EpochClock, resolve_device
from dance_tpu_torch.utils import loss as L
from dance_tpu_torch.utils.batch import epoch_batches
from dance_tpu_torch.utils.metrics import score_embedding
from dance_tpu_torch.utils.optim import adamw

LIKELIHOODS = ("NB", "ZINB", "Bernoulli")


class _ModalityVAE(nn.Module):
    """One modality's VAE (counterpart: :43). flax's names: ``encoder``,
    ``fc_mean``, ``fc_logvar``, ``decoder``, ``dec_scale``, and
    ``dec_disp`` (NB, ZINB) and ``dec_drop`` (ZINB)."""

    def __init__(self, input_dim: int, hidden: Sequence[int], z_dim: int,
                 likelihood: str = "NB"):
        super().__init__()
        if likelihood not in LIKELIHOODS:
            raise ValueError(f"likelihood must be one of {LIKELIHOODS}, got {likelihood!r}")
        self.likelihood = likelihood
        self.encoder = DropoutMLP(input_dim, hidden)
        self.fc_mean = nn.Linear(hidden[-1], z_dim)
        self.fc_logvar = nn.Linear(hidden[-1], z_dim)
        self.decoder = DropoutMLP(z_dim, tuple(reversed(hidden)))
        self.dec_scale = nn.Linear(hidden[0], input_dim)
        if likelihood in ("NB", "ZINB"):
            self.dec_disp = nn.Linear(hidden[0], input_dim)
        if likelihood == "ZINB":
            self.dec_drop = nn.Linear(hidden[0], input_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax ``Dense``'s init for every layer, in module order."""
        reset_linears(self, generator)

    def encode(self, x: torch.Tensor, drop: Optional[Callable] = None):
        h = self.encoder(x, drop)
        return self.fc_mean(h), self.fc_logvar(h), h

    def forward(self, x: torch.Tensor, log_sf: torch.Tensor, noise: Optional[torch.Tensor] = None,
                drop: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
        """The outputs of the counterpart's ``__call__``: the latent is
        ``mean + exp(logvar / 2) · noise`` when standard normals ``noise``
        are given, the mean otherwise; ``drop`` applies dropout (training)."""
        mean, logvar, hidden = self.encode(x, drop)
        z = mean if noise is None else mean + torch.exp(0.5 * logvar) * noise
        h = self.decoder(z, drop)
        out = {"mean": mean, "logvar": logvar, "latent": z, "hidden": hidden}
        if self.likelihood in ("NB", "ZINB"):
            out["scale_x"] = torch.exp(log_sf)[:, None] * torch.softmax(self.dec_scale(h), dim=1)
            out["disp"] = torch.exp(torch.clamp(self.dec_disp(h), -15, 15))
            if self.likelihood == "ZINB":
                out["dropout"] = torch.sigmoid(self.dec_drop(h))
        else:
            out["scale_x"] = torch.sigmoid(self.dec_scale(h))
        return out

    def nll(self, out: Dict[str, torch.Tensor], x_raw: torch.Tensor) -> torch.Tensor:
        """The negative log-likelihood of each cell, summed over features."""
        if self.likelihood == "NB":
            return L.nb_nll(x_raw, out["scale_x"], out["disp"], reduce=False).sum(1)
        if self.likelihood == "ZINB":
            return L.zinb_nll(x_raw, out["scale_x"], out["disp"], out["dropout"],
                              reduce=False).sum(1)
        p = torch.clamp(out["scale_x"], 1e-7, 1 - 1e-7)
        return -(x_raw * torch.log(p) + (1 - x_raw) * torch.log1p(-p)).sum(1)


def _gaussian_kl(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(N(mean, exp(logvar)) || N(0, 1)) per cell (counterpart: :100)."""
    return 0.5 * torch.sum(torch.exp(logvar) + mean ** 2 - 1.0 - logvar, dim=1)


def _make_attention(name: Optional[str]) -> Callable:
    """The attention-transfer loss ``name`` as a function of the training
    model's outputs, the frozen model's latent and its (mean, logvar): a
    value per cell or a scalar (counterpart: :105-128). Anything else than
    the seven names, ``None`` included, is ``"Eucli"``."""
    if name == "NST":
        return lambda out, z_pre, stats: L.NSTLoss().nst_loss(
            out["latent"][:, :, None], z_pre[:, :, None])
    if name == "FT":
        return lambda out, z_pre, stats: L.FactorTransfer()(
            out["latent"][:, :, None, None], z_pre[:, :, None, None])
    if name == "SL":
        return lambda out, z_pre, stats: L.Similarity.similarity_loss(out["latent"], z_pre)
    if name == "CC":
        return lambda out, z_pre, stats: L.Correlation()(out["latent"], z_pre)
    if name == "AT":
        return lambda out, z_pre, stats: L.Attention()(out["latent"], z_pre)
    if name == "KL_div":
        return lambda out, z_pre, stats: L.KL_diver()(out["mean"], out["logvar"], *stats)
    if name == "L1":
        return lambda out, z_pre, stats: L.L1_dis()(out["latent"], z_pre)
    return lambda out, z_pre, stats: L.Eucli_dis()(out["latent"], z_pre)


def dcca_loss(net: _ModalityVAE, x, x_raw, log_sf, kl_weight: float, noise,
              attention: Optional[Callable] = None, frozen=None, sf_att: float = 1.0,
              drop: Optional[Callable] = None) -> torch.Tensor:
    """One phase's loss on a batch (counterpart: the ``loss_fn`` of
    ``_phase_epoch``, :203-210): the mean over cells of NLL + ``kl_weight``
    · KL, plus ``sf_att`` times ``attention(out, z_pre, (mean, logvar))`` of
    the ``frozen`` model's ``(z_pre, mean, logvar)`` when given."""
    out = net(x, log_sf, noise, drop)
    loss = net.nll(out, x_raw) + kl_weight * _gaussian_kl(out["mean"], out["logvar"])
    if attention is not None:
        z_pre, mean_pre, logvar_pre = frozen
        loss = loss + sf_att * attention(out, z_pre, (mean_pre, logvar_pre))
    return torch.mean(loss)


class DCCA(BaseRegressionMethod):
    """DCCA (counterpart: :131). The constructor takes the reference's
    arguments; of them the first encoder widths (``layer_e_1``,
    ``layer_e_2``), the latent sizes, the likelihoods, ``cycle``,
    ``attention_loss`` and ``droprate`` are used, as in JAX. ``z_dim`` sets
    both latents; ``sf1``/``sf2`` scale the attention. ``device="auto"`` is
    the card."""

    _DISPLAY_ATTRS = ("z_dim", "cycle", "type_1", "type_2")

    @staticmethod
    def preprocessing_pipeline(log_level: str = "INFO"):
        """The ``SetConfig`` of a ``MuData`` of ``mod1`` and ``mod2``: both
        modalities' ``X`` the features, mod1's ``obs["cell_type"]`` the labels
        (counterpart: dcca.py:165)."""
        return joint_embedding_config(log_level)

    def __init__(self, layer_e_1=(128,), hidden1_1: int = 128, Zdim_1: int = 16,
                 layer_d_1=(128,), hidden2_1: int = 128, layer_e_2=(128,),
                 hidden1_2: int = 128, Zdim_2: int = 16, layer_d_2=(128,),
                 hidden2_2: int = 128, args=None, ground_truth1=None,
                 Type_1: str = "NB", Type_2: str = "Bernoulli", cycle: int = 1,
                 attention_loss: Optional[str] = "Eucli", droprate: float = 0.1, *,
                 z_dim: Optional[int] = None, sf1: float = 2.0, sf2: float = 1.0,
                 seed: int = 0, device="auto"):
        self.z_dim = z_dim or Zdim_1
        self.z_dim2 = Zdim_2 if z_dim is None else z_dim
        self.hidden1 = tuple(layer_e_1) or (128,)
        self.hidden2 = tuple(layer_e_2) or (128,)
        self.type_1, self.type_2 = Type_1, Type_2
        self.cycle = cycle
        self.attention_loss = attention_loss
        self._attn = _make_attention(attention_loss)
        self.droprate = droprate
        self.sf1, self.sf2 = sf1, sf2
        self.seed = seed
        self.device = resolve_device(device)
        self.net1: Optional[_ModalityVAE] = None
        self.net2: Optional[_ModalityVAE] = None
        # per epoch: phase, modality, attention, epoch, loss, seconds
        self.history: List[Dict[str, float]] = []

    def _make_nets(self, dim1: int, dim2: int) -> Tuple[_ModalityVAE, _ModalityVAE]:
        """Both VAEs with their init drawn from one CPU generator seeded with
        ``seed`` (modality 1 first), on the device."""
        gen = torch.Generator().manual_seed(self.seed)
        nets = (_ModalityVAE(dim1, self.hidden1, self.z_dim, self.type_1),
                _ModalityVAE(dim2, self.hidden2, self.z_dim2, self.type_2))
        for net in nets:
            net.reset_parameters(gen)
        return tuple(net.to(self.device) for net in nets)

    def _noise(self, shape, generator: torch.Generator) -> torch.Tensor:
        """Standard normals for the latent of one step, on the device."""
        return torch.randn(shape, generator=generator, device=self.device)

    def _mask(self, shape, generator: torch.Generator) -> torch.Tensor:
        """A dropout layer's keep mask for one step (true with probability 1 -
        droprate), on the device."""
        return torch.rand(shape, generator=generator, device=self.device) >= self.droprate

    def _dropout(self, generator: torch.Generator) -> Optional[Callable]:
        if self.droprate == 0:
            return None
        return lambda x: inverted_dropout(x, self._mask(x.shape, generator), self.droprate)

    def _modality(self, which: int):
        if which == 1:
            return self.net1, self._x1, self._xr1, self._lsf1
        return self.net2, self._x2, self._xr2, self._lsf2

    @torch.no_grad()
    def _latent(self, which: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Modality ``which``'s (latent, mean, logvar), in evaluation mode
        (counterpart: :216)."""
        net, x, _, log_sf = self._modality(which)
        out = net(x, log_sf)
        return out["latent"], out["mean"], out["logvar"]

    def _run_phase(self, phase: int, which: int, use_attention: bool, epochs: int, lr: float,
                   order_gen: torch.Generator, noise_gen: torch.Generator,
                   anneal_epoch: int = 10) -> float:
        """One phase: ``epochs`` epochs of modality ``which``'s VAE with a
        fresh AdamW (counterpart: :223-248). Returns the last epoch's loss."""
        net, x, x_raw, log_sf = self._modality(which)
        frozen = self._latent(2 if which == 1 else 1) if use_attention else None
        attention = self._attn if use_attention else None
        sf_att = self.sf2 if which == 1 else self.sf1
        drop = self._dropout(noise_gen)
        opt = adamw(net, lr, weight_decay=5e-4)
        n, z_dim = x.shape[0], net.fc_mean.out_features
        clock, losses = EpochClock(self.device), []
        for epoch in range(1, epochs + 1):
            clock.tick()
            kl_weight = min(1.0, epoch / anneal_epoch)
            batches = ([None] if self._batch_size is None else
                       epoch_batches(order_gen, n, self._batch_size).to(self.device))
            step_losses = []
            for idx in batches:
                take = (lambda a: a) if idx is None else (lambda a: a[idx])
                rows = n if idx is None else len(idx)
                opt.zero_grad(set_to_none=True)
                loss = dcca_loss(net, take(x), take(x_raw), take(log_sf), kl_weight,
                                 self._noise((rows, z_dim), noise_gen), attention,
                                 None if frozen is None else tuple(take(f) for f in frozen),
                                 sf_att, drop)
                loss.backward()
                opt.step()
                step_losses.append(loss.detach())
            losses.append(torch.stack(step_losses).mean())
        clock.tick()
        self.history += [{"phase": phase, "modality": which, "attention": use_attention,
                          "epoch": e, "loss": float(l), "seconds": s}
                         for e, (l, s) in enumerate(zip(losses, clock.seconds()), 1)]
        return self.history[-1]["loss"]

    def fit(self, x_mod1, x_mod2, x_mod1_raw=None, x_mod2_raw=None, *, epochs: int = 100,
            lr1: float = 1e-2, lr2: float = 1e-2, first: str = "RNA",
            batch_size: Optional[int] = None):
        """The cycles (counterpart: :251-305). The raw counts default to
        ``expm1(max(x1, 0))`` and ``x2 > 0``; each modality's log library
        size is ``log(max(Σ raw, 1))``. ``first`` is the reference's
        argument, unused as in JAX."""
        dev = self.device
        self._batch_size = batch_size
        x1 = torch.from_numpy(np.ascontiguousarray(x_mod1, np.float32)).to(dev)
        x2 = torch.from_numpy(np.ascontiguousarray(x_mod2, np.float32)).to(dev)
        xr1 = (torch.from_numpy(np.ascontiguousarray(x_mod1_raw, np.float32)).to(dev)
               if x_mod1_raw is not None else torch.expm1(torch.clamp(x1, min=0.0)))
        xr2 = (torch.from_numpy(np.ascontiguousarray(x_mod2_raw, np.float32)).to(dev)
               if x_mod2_raw is not None else (x2 > 0).to(torch.float32))
        self._x1, self._x2, self._xr1, self._xr2 = x1, x2, xr1, xr2
        self._lsf1 = torch.log(torch.clamp(xr1.sum(1), min=1.0))
        self._lsf2 = torch.log(torch.clamp(xr2.sum(1), min=1.0))
        self.net1, self.net2 = self._make_nets(x1.shape[1], x2.shape[1])
        order_gen = torch.Generator().manual_seed(self.seed)
        noise_gen = torch.Generator(device=dev).manual_seed(self.seed)
        self.history = []
        phases = [(1, False, lr1)]
        for used_cycle in range(1, self.cycle + 1):
            if used_cycle == 1:
                phases.append((2, False, lr2))
                if self.attention_loss is not None:
                    phases.append((2, True, lr2))
            elif used_cycle % 2 == 0:
                phases.append((1, True, lr1))
            else:
                phases.append((2, True, lr2))
        for phase, (which, use_attention, lr) in enumerate(phases):
            loss = self._run_phase(phase, which, use_attention, epochs, lr, order_gen, noise_gen)
            logger.info("DCCA phase %d (modality %d, attention %s) done, loss %.5f", phase, which,
                        use_attention, loss)
        return self

    def predict(self, x_mod1=None, x_mod2=None) -> np.ndarray:
        """The joint embedding: both latent means side by side (counterpart:
        :307). New inputs replace the training ones, with log library sizes
        of 0, as in JAX."""
        if x_mod1 is not None:
            self._x1 = torch.from_numpy(np.ascontiguousarray(x_mod1, np.float32)).to(self.device)
            self._x2 = torch.from_numpy(np.ascontiguousarray(x_mod2, np.float32)).to(self.device)
            self._lsf1 = torch.zeros(self._x1.shape[0], device=self.device)
            self._lsf2 = torch.zeros(self._x2.shape[0], device=self.device)
        return torch.cat([self._latent(1)[1], self._latent(2)[1]], dim=1).cpu().numpy()

    def score(self, x, y, *, score_func=None, return_pred: bool = False,
              metric: str = "clustering", batch=None, **kwargs):
        """k-means NMI of the embedding against ``y`` (``"clustering"``) or
        the scIB suite's ``final_scores`` (``"openproblems"``) (counterpart:
        :318)."""
        return score_embedding(self.predict(), y, metric=metric, batch=batch, device=self.device,
                               return_pred=return_pred, **kwargs)


__all__ = ["DCCA", "dcca_loss"]
