"""scMVAE: a multimodal VAE whose joint posterior is the product of the two
modalities' Gaussian experts and an N(0, I) prior expert, with a Gaussian
mixture prior on the latent and library-size latents for the count
modalities.

Counterpart: dance_tpu/modules/multi_modality/joint_embedding/scmvae.py
(the helpers :38-82, ``_GaussianHead`` :97, ``_ZINBDecoder`` :116,
``_PlainDecoder`` :134, ``_scMVAENet`` :153-282, ``scMVAE`` :285-521,
``ProductOfExperts``, ``prior_expert`` and ``build_multi_layers``
:524-540). The encoders see ``log(max(x, 1e-7) + 1)`` (``log_variational``).
The counts (modality 1) are decoded by a ZINB head with the mean
``exp(library) · softmax(·)``; the second modality by a Bernoulli, Poisson
(``"Possion"``, JAX's spelling), Gaussian or ZINB head. A shared stack maps
the latent to the decoders' inputs by ``model`` 0-3 (:220-234). The GMM
prior's weights are logits and its variances log-variances
(``get_gamma``, ``gmm_kl``, :256-282). The loss is the mean over cells of
``scale_factor · ZINB₁ + NLL₂ + KL(library₁) [+ KL(library₂)] + kl_weight ·
KL_z``, KL_z the GMM ELBO term or, with ``penality="Gaussian"``, the KL to
N(0, I). ``_normal_kl`` feeds ``exp(logvar)`` to the Normal's *scale*, as
the reference does (:74-82): kept so.

The protocol (:391-494): ``init_gmm_params`` fits a diagonal Gaussian
mixture (:class:`~dance_tpu_torch.ops.mixture.GaussianMixture`, the port's
counterpart of sklearn's, ``reg_covar=1e-4``) to the posterior means of the
initial weights and sets ``mu_c``, ``logvar_c`` and ``pi_logit`` from it;
then AdamW (optax's: decay 1e-6 on every weight, eps 0.01) over the
wrap-padded batches of 64, the rate before epoch ``e`` (from 1)
``max(lr · 0.9^(e // adjust_epoch), final_rate)``, the KL weight ``min(1,
e / anneal_epoch)``, and the weights of the epoch with the lowest mean
training loss kept at the end.

Where this differs from the JAX package: the weights come from a CPU
``torch.Generator`` seeded with ``seed`` (parity tests copy the flax
weights in, :func:`dance_tpu_torch.utils.params.scmvae_flax_to_torch`), the
batch orders from another, the normals and dropout masks from a generator
on the device through :meth:`scMVAE._noise` and :meth:`scMVAE._mask`
(tests hand JAX's over); the mixture's k-means start is the port's, not
sklearn's; the epochs are a Python loop that reads each epoch's loss back
for the best-state choice; ``history`` records each epoch's loss, rate, KL
weight and seconds. No TPU kernel is on this path.
"""

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dance_tpu_torch.modules.multi_modality.configs import joint_embedding_config
from dance_tpu_torch.modules.base import BaseRegressionMethod
from dance_tpu_torch.nn.mlp import DropoutMLP, inverted_dropout
from dance_tpu_torch.nn.mlp import buildNetwork as build_multi_layers  # noqa: F401
from dance_tpu_torch.nn.vae import reset_linears
from dance_tpu_torch.ops.mixture import GaussianMixture
from dance_tpu_torch.settings import logger
from dance_tpu_torch.utils import EpochClock, resolve_device
from dance_tpu_torch.utils.batch import epoch_batches
from dance_tpu_torch.utils.loss import GMM_loss, zinb_nll
from dance_tpu_torch.utils.metrics import score_embedding
from dance_tpu_torch.utils.optim import adamw, best_state, set_learning_rate

TYPES = ("Bernoulli", "Gaussian", "Gaussian1", "Possion", "ZINB")


def product_of_experts(mus: torch.Tensor, logvars: torch.Tensor,
                       eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """The product of the Gaussian experts stacked on the first axis:
    ``(mu, logvar)`` (counterpart: :38)."""
    precision = 1.0 / (torch.exp(logvars) + eps)
    total = torch.sum(precision, dim=0)
    return torch.sum(mus * precision, dim=0) / total, torch.log(1.0 / total)


def calculate_log_library_size(counts) -> Tuple[np.ndarray, np.ndarray]:
    """The mean and variance of the cells' log library sizes (in float64),
    broadcast to (n, 1) float32 arrays (counterpart: :47)."""
    lib = np.log(np.maximum(np.asarray(counts).sum(1), 1e-7).astype(np.float64))
    n = len(lib)
    return (np.full((n, 1), lib.mean(), np.float32), np.full((n, 1), lib.var(), np.float32))


def _log_library(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`calculate_log_library_size` in float32 on ``x``'s device, as
    JAX's ``fit`` computes it (:458-462)."""
    lib = torch.log(torch.clamp(x.sum(1), min=1e-7))
    shape = (x.shape[0], 1)
    return lib.mean().expand(shape), lib.var(unbiased=False).expand(shape)


def _bernoulli_nll(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-cell binary cross-entropy (counterpart: :57)."""
    return -torch.sum(x * torch.log(p + 1e-8) + (1 - x) * torch.log(1 - p + 1e-8), dim=1)


def _poisson_nll(rate: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-cell Poisson negative log-likelihood (counterpart: :63)."""
    return torch.sum(rate - x * torch.log(rate + 1e-10) + torch.lgamma(x + 1.0), dim=1)


def _masked_mse(pred: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-cell squared error where ``x`` is nonzero (counterpart: :69)."""
    return torch.sum(((pred - x) * torch.sign(x)) ** 2, dim=1)


def _normal_kl(mu1, logstd1_like, mu2, var2) -> torch.Tensor:
    """KL(N(mu1, s1) || N(mu2, sqrt(var2))) per cell with ``s1 =
    exp(logstd1_like)``: the reference passes ``exp(logvar)`` as the scale
    (counterpart: :74)."""
    s1 = torch.exp(logstd1_like)
    s2 = torch.sqrt(var2)
    return torch.sum(torch.log(s2 / (s1 + 1e-12) + 1e-12)
                     + (s1 ** 2 + (mu1 - mu2) ** 2) / (2 * s2 ** 2) - 0.5, dim=1)


def _width(in_dim: int, hidden: Sequence[int]) -> int:
    return hidden[-1] if len(hidden) else in_dim


class _GaussianHead(nn.Module):
    """An encoder stack then the ``mu`` and ``logvar`` heads (counterpart:
    :97; flax's ``_MLP_0``, ``Dense_0``, ``Dense_1``)."""

    def __init__(self, in_dim: int, hidden: Sequence[int], z_dim: int):
        super().__init__()
        self.mlp = DropoutMLP(in_dim, hidden)
        self.mu = nn.Linear(_width(in_dim, hidden), z_dim)
        self.logvar = nn.Linear(_width(in_dim, hidden), z_dim)

    def forward(self, x, noise: Optional[torch.Tensor] = None, drop: Optional[Callable] = None):
        """``(mu, logvar, z)``: ``z = mu + exp(logvar / 2) · noise`` with
        standard normals ``noise``, ``mu`` without."""
        h = self.mlp(x, drop)
        mu, logvar = self.mu(h), self.logvar(h)
        return mu, logvar, mu if noise is None else mu + torch.exp(0.5 * logvar) * noise


class _ZINBDecoder(nn.Module):
    """``(softmax, exp(library) · softmax, exp(clip(·, ±15)), sigmoid)``
    heads (counterpart: :116; flax's ``_MLP_0`` when ``hidden``,
    ``Dense_0``-``Dense_2`` -> ``scale``, ``disp``, ``dropout``)."""

    def __init__(self, in_dim: int, hidden: Sequence[int], out_dim: int):
        super().__init__()
        self.mlp = DropoutMLP(in_dim, hidden) if len(hidden) else None
        width = _width(in_dim, hidden)
        self.scale = nn.Linear(width, out_dim)
        self.disp = nn.Linear(width, out_dim)
        self.dropout = nn.Linear(width, out_dim)

    def forward(self, z, library, drop: Optional[Callable] = None):
        h = z if self.mlp is None else self.mlp(z, drop)
        normalized = torch.softmax(self.scale(h), dim=1)
        return (normalized, torch.exp(library) * normalized,
                torch.exp(torch.clamp(self.disp(h), -15, 15)), torch.sigmoid(self.dropout(h)))


class _PlainDecoder(nn.Module):
    """A Bernoulli / Gaussian1 (sigmoid), Gaussian (softmax) or Poisson
    (ReLU) head (counterpart: :134; flax's ``_MLP_0``, ``Dense_0`` ->
    ``out``)."""

    def __init__(self, in_dim: int, hidden: Sequence[int], out_dim: int,
                 out_type: str = "Bernoulli"):
        super().__init__()
        self.out_type = out_type
        self.mlp = DropoutMLP(in_dim, hidden) if len(hidden) else None
        self.out = nn.Linear(_width(in_dim, hidden), out_dim)

    def forward(self, z, drop: Optional[Callable] = None):
        raw = self.out(z if self.mlp is None else self.mlp(z, drop))
        if self.out_type in ("Bernoulli", "Gaussian1"):
            return torch.sigmoid(raw)
        if self.out_type == "Gaussian":
            return torch.softmax(raw, dim=1)
        return torch.relu(raw)


class _scMVAENet(nn.Module):
    """The experts, the library encoders, the shared stack, the decoders
    and the GMM prior's ``pi_logit`` (K,), ``mu_c`` and ``logvar_c`` (D, K)
    (counterpart: :153)."""

    def __init__(self, dim1: int, dim2: int, z_dim: int = 16, hidden1=(128,), hidden2=(128,),
                 hidden_l=(128,), decoder_share=(128, 256), share_hidden: int = 128,
                 dec1_hidden=(128,), dec2_hidden=(128,), type2: str = "Bernoulli",
                 n_centroids: int = 19, model: int = 2, log_variational: bool = True):
        super().__init__()
        if type2 not in TYPES:
            raise ValueError(f"Type must be one of {TYPES}, got {type2!r}")
        self.type2, self.model, self.share_hidden = type2, model, share_hidden
        self.log_variational = log_variational
        self.enc1 = _GaussianHead(dim1, hidden1, z_dim)
        self.enc2 = _GaussianHead(dim2, hidden2, z_dim)
        self.enc_l1 = _GaussianHead(dim1, hidden_l, 1)
        self.share = DropoutMLP(z_dim, decoder_share) if len(decoder_share) else None
        width = _width(z_dim, decoder_share)
        in1, in2 = {0: (width, width), 1: (share_hidden, width - share_hidden),
                    2: (z_dim + share_hidden, width - share_hidden),
                    3: (z_dim + width, width)}[model] if len(decoder_share) else (z_dim, z_dim)
        self.dec1 = _ZINBDecoder(in1, dec1_hidden, dim1)
        if type2 == "ZINB":
            self.enc_l2 = _GaussianHead(dim2, hidden_l, 1)
            self.dec2 = _ZINBDecoder(in2, dec2_hidden, dim2)
        else:
            self.dec2 = _PlainDecoder(in2, dec2_hidden, dim2, type2)
        self.pi_logit = nn.Parameter(torch.zeros(n_centroids))
        self.mu_c = nn.Parameter(torch.zeros(z_dim, n_centroids))
        self.logvar_c = nn.Parameter(torch.zeros(z_dim, n_centroids))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax ``Dense``'s init for every layer in module order; the GMM
        prior's parameters 0, as flax initialises them."""
        reset_linears(self, generator)
        for p in (self.pi_logit, self.mu_c, self.logvar_c):
            nn.init.zeros_(p)

    def _prep(self, x: torch.Tensor) -> torch.Tensor:
        return torch.log(torch.clamp(x, min=1e-7) + 1) if self.log_variational else x

    def posterior(self, x1, x2, drop: Optional[Callable] = None):
        """The product of the prior expert and both modalities' experts:
        ``(mean_z, logvar_z)``."""
        mu1, lv1, _ = self.enc1(self._prep(x1), drop=drop)
        mu2, lv2, _ = self.enc2(self._prep(x2), drop=drop)
        zeros = torch.zeros_like(mu1)
        return product_of_experts(torch.stack([zeros, mu1, mu2]),
                                  torch.stack([zeros, lv1, lv2]))

    def forward(self, x1, x2, noise: Optional[Sequence[torch.Tensor]] = None,
                drop: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
        """The counterpart's outputs. ``noise`` holds the standard normals of
        the latent, of library 1 and, for a ZINB second modality, of library
        2; without it every latent is its mean. ``drop`` applies dropout."""
        nz, nl1, nl2 = (None, None, None) if noise is None else (tuple(noise) + (None,))[:3]
        mean_z, logvar_z = self.posterior(x1, x2, drop)
        z = mean_z if nz is None else mean_z + torch.exp(0.5 * logvar_z) * nz
        mean_l1, logvar_l1, lib1 = self.enc_l1(self._prep(x1), nl1, drop)
        if self.share is not None:
            latents = self.share(z, drop)
            s = self.share_hidden
            latent_1, latent_2 = {0: (latents, latents),
                                  1: (latents[:, :s], latents[:, s:]),
                                  2: (torch.cat([z, latents[:, :s]], 1), latents[:, s:]),
                                  3: (torch.cat([z, latents], 1), latents)}[self.model]
        else:
            latent_1 = latent_2 = z
        norm1, recon1, disp1, drop1 = self.dec1(latent_1, lib1, drop)
        out = dict(mean_z=mean_z, logvar_z=logvar_z, latent_z=z, norm_x1=norm1, recon_x1=recon1,
                   disper_x=disp1, dropout_rate=drop1, mean_l=mean_l1, logvar_l=logvar_l1,
                   library=lib1)
        if self.type2 == "ZINB":
            mean_l2, logvar_l2, lib2 = self.enc_l2(self._prep(x2), nl2, drop)
            norm2, recon2, disp2, drop2 = self.dec2(latent_2, lib2, drop)
            out.update(norm_x2=norm2, recon_x2=recon2, disper_x2=disp2, dropout_rate_2=drop2,
                       mean_l2=mean_l2, logvar_l2=logvar_l2, library2=lib2)
        else:
            out["recon_x2"] = self.dec2(latent_2, drop)
        return out

    def embed(self, x1, x2) -> torch.Tensor:
        return self.posterior(x1, x2)[0]

    def get_gamma(self, z: torch.Tensor) -> torch.Tensor:
        """The GMM responsibilities p(c | z) (counterpart: :256)."""
        pi = torch.softmax(self.pi_logit, 0)
        var_c = torch.exp(self.logvar_c)
        log_pdf = -torch.sum(0.5 * torch.log(2 * math.pi * var_c)[None]
                             + (z[:, :, None] - self.mu_c[None]) ** 2 / (2 * var_c[None]), dim=1)
        p_c_z = torch.exp(torch.log(pi)[None] + log_pdf) + 1e-10
        return p_c_z / torch.sum(p_c_z, dim=1, keepdim=True)

    def gmm_kl(self, z, mean_z, logvar_z) -> torch.Tensor:
        """The GMM ELBO's KL term per cell (counterpart: :267): ``GMM_loss``
        on this prior's weights and variances."""
        c_params = (self.mu_c, torch.exp(self.logvar_c), torch.softmax(self.pi_logit, 0)[None])
        return GMM_loss(self.get_gamma(z), c_params, (mean_z, logvar_z))


def elbo_terms(net: _scMVAENet, x1, x2, lib1, lib2, noise=None, drop=None,
               penality: str = "GMM"):
    """Per cell: ``(ZINB₁, NLL₂, KL(library₁), KL(library₂), KL_z)``
    (counterpart: ``_elbo_terms``, :332). ``lib1``/``lib2`` are the (mean,
    variance) pairs of :func:`calculate_log_library_size`."""
    out = net(x1, x2, noise, drop)
    loss1 = zinb_nll(x1, out["recon_x1"], out["disper_x"], out["dropout_rate"],
                     reduce=False).sum(1)
    if net.type2 == "ZINB":
        loss2 = zinb_nll(x2, out["recon_x2"], out["disper_x2"], out["dropout_rate_2"],
                         reduce=False).sum(1)
        kl_l2 = _normal_kl(out["mean_l2"], out["logvar_l2"], *lib2)
    else:
        if net.type2 == "Bernoulli":
            loss2 = _bernoulli_nll(out["recon_x2"], x2)
        elif net.type2 == "Possion":
            loss2 = _poisson_nll(out["recon_x2"], x2)
        else:
            loss2 = _masked_mse(out["recon_x2"], x2)
        kl_l2 = torch.zeros_like(loss1)
    kl_l1 = _normal_kl(out["mean_l"], out["logvar_l"], *lib1)
    if penality == "GMM":
        kl_z = net.gmm_kl(out["latent_z"], out["mean_z"], out["logvar_z"])
    else:
        kl_z = _normal_kl(out["mean_z"], out["logvar_z"], torch.zeros_like(out["mean_z"]),
                          torch.ones_like(out["mean_z"]))
    return loss1, loss2, kl_l1, kl_l2, kl_z


def scmvae_loss(net: _scMVAENet, x1, x2, lib1, lib2, kl_weight: float, scale_factor: float,
                noise=None, drop=None, penality: str = "GMM") -> torch.Tensor:
    """A batch's loss: the mean over cells of ``scale_factor · ZINB₁ + NLL₂
    + KL(library₁) + KL(library₂) + kl_weight · KL_z`` (counterpart: the
    ``loss_fn`` of ``_epoch``, :374-379)."""
    l1, l2, kl1, kl2, klz = elbo_terms(net, x1, x2, lib1, lib2, noise, drop, penality)
    return torch.mean(scale_factor * l1 + l2 + kl1 + kl2 + kl_weight * klz)


class scMVAE(BaseRegressionMethod):
    """scMVAE-PoE (counterpart: :285). The constructor takes the reference's
    layer lists (each list's first entry is its input width) or the compact
    keywords ``z_dim``/``seed``; ``device="auto"`` is the card."""

    _DISPLAY_ATTRS = ("z_dim", "Type", "penality", "n_centroids")

    @staticmethod
    def preprocessing_pipeline(log_level: str = "INFO"):
        """The ``SetConfig`` of a ``MuData`` of ``mod1`` and ``mod2``: both
        modalities' ``X`` the features, mod1's ``obs["cell_type"]`` the labels
        (counterpart: scmvae.py:322)."""
        return joint_embedding_config(log_level)

    def __init__(self, encoder_1=None, hidden_1=None, Z_DIMS: int = 16, decoder_share=None,
                 share_hidden: int = 128, decoder_1=None, hidden_2=None, encoder_l=None,
                 hidden3=None, encoder_2=None, hidden_4=None, encoder_l1=None, hidden3_1=None,
                 decoder_2=None, hidden_5=None, drop_rate: float = 0.1,
                 log_variational: bool = True, Type: str = "Bernoulli", device="auto",
                 n_centroids: int = 19, penality: str = "GMM", model: int = 2, *,
                 z_dim: Optional[int] = None, seed: int = 0, **kwargs):
        self.z_dim = z_dim or Z_DIMS
        self.hidden1 = tuple(encoder_1[1:]) if encoder_1 else (128,)
        self.hidden2 = tuple(encoder_2[1:]) if encoder_2 else (128,)
        self.hidden_l = tuple(encoder_l[1:]) if encoder_l else (128,)
        self.decoder_share = tuple(decoder_share[1:]) if decoder_share else (128, 256)
        self.share_hidden = share_hidden
        self.dec1_hidden = tuple(decoder_1[1:]) if decoder_1 else (128,)
        self.dec2_hidden = tuple(decoder_2[1:]) if decoder_2 else (128,)
        self.Type = Type
        self.n_centroids = n_centroids
        self.penality = penality
        self.model = model
        self.log_variational = log_variational
        self.droprate = drop_rate
        self.seed = seed
        self.device = resolve_device(device)
        self.net: Optional[_scMVAENet] = None
        self.gmm: Optional[GaussianMixture] = None
        self.history: List[Dict[str, float]] = []  # per epoch: epoch, loss, lr, kl_weight, seconds

    def _make_net(self, dim1: int, dim2: int) -> _scMVAENet:
        """A new net with its init drawn from ``seed``, on the device."""
        net = _scMVAENet(dim1, dim2, self.z_dim, self.hidden1, self.hidden2, self.hidden_l,
                         self.decoder_share, self.share_hidden, self.dec1_hidden,
                         self.dec2_hidden, self.Type, self.n_centroids, self.model,
                         self.log_variational)
        net.reset_parameters(torch.Generator().manual_seed(self.seed))
        return net.to(self.device)

    def _noise(self, shape, generator: torch.Generator) -> torch.Tensor:
        """Standard normals for one latent of one step, on the device."""
        return torch.randn(shape, generator=generator, device=self.device)

    def _mask(self, shape, generator: torch.Generator) -> torch.Tensor:
        """A dropout layer's keep mask for one step, on the device."""
        return torch.rand(shape, generator=generator, device=self.device) >= self.droprate

    def _binarize(self, x2: torch.Tensor) -> torch.Tensor:
        return (x2 > 0).to(torch.float32) if self.Type == "Bernoulli" else x2

    def _inputs(self, x_mod1, x_mod2):
        x1 = torch.from_numpy(np.ascontiguousarray(x_mod1, np.float32)).to(self.device)
        x2 = torch.from_numpy(np.ascontiguousarray(x_mod2, np.float32)).to(self.device)
        return x1, self._binarize(x2)

    @torch.no_grad()
    def init_gmm_params(self, x1=None, x2=None):
        """Fit the Gaussian mixture to the current posterior means and set
        the prior from it: ``mu_c = means.T``, ``logvar_c = log(cov.T)``,
        ``pi_logit = log(weights + 1e-8)``, each cast to float32 first
        (counterpart: :420-439). The fitted mixture is kept as ``gmm``."""
        if x1 is None:
            x1, x2 = self._x1, self._x2
        z = self.net.embed(x1, x2)
        self.gmm = GaussianMixture(self.n_centroids, reg_covar=1e-4,
                                   random_state=self.seed).fit(z)
        net = self.net
        net.mu_c.copy_(self.gmm.means_.T.float())
        net.logvar_c.copy_(torch.log(self.gmm.covariances_.T.float()))
        net.pi_logit.copy_(torch.log(self.gmm.weights_.float() + 1e-8))

    def fit(self, x_mod1, x_mod2, epochs: int = 200, lr: float = 1e-3, *, batch_size: int = 64,
            weight_decay: float = 1e-6, eps: float = 0.01, anneal_epoch: int = 200,
            final_rate: float = 1e-4, scale_factor: float = 4.0, adjust_epoch: int = 10):
        """The GMM warm start, then the epochs (counterpart: :441-494).
        ``x_mod1`` is the raw counts; ``x_mod2`` is binarised for the
        Bernoulli decoder."""
        dev = self.device
        x1, x2 = self._inputs(x_mod1, x_mod2)
        lib1 = _log_library(x1)
        lib2 = _log_library(x2) if self.Type == "ZINB" else lib1
        n, bs = x1.shape[0], min(batch_size, x1.shape[0])
        self.net = net = self._make_net(x1.shape[1], x2.shape[1])
        self._x1, self._x2 = x1, x2
        if self.penality == "GMM":
            self.init_gmm_params()
        opt = adamw(net, lr, weight_decay=weight_decay, eps=eps)
        order_gen = torch.Generator().manual_seed(self.seed)
        noise_gen = torch.Generator(device=dev).manual_seed(self.seed)
        drop = None if self.droprate == 0 else (lambda h: inverted_dropout(
            h, self._mask(h.shape, noise_gen), self.droprate))
        shapes = [(bs, self.z_dim), (bs, 1)] + ([(bs, 1)] if self.Type == "ZINB" else [])
        clock, self.history = EpochClock(dev), []
        best_loss, best = math.inf, None
        for e in range(1, epochs + 1):
            clock.tick()
            rate = max(lr * 0.9 ** (e // adjust_epoch), final_rate)
            set_learning_rate(opt, rate)
            kl_weight = min(1.0, e / anneal_epoch)
            step_losses = []
            for idx in epoch_batches(order_gen, n, bs).to(dev):
                noise = [self._noise(shape, noise_gen) for shape in shapes]
                opt.zero_grad(set_to_none=True)
                loss = scmvae_loss(net, x1[idx], x2[idx], (lib1[0][idx], lib1[1][idx]),
                                   (lib2[0][idx], lib2[1][idx]), kl_weight, scale_factor, noise,
                                   drop, self.penality)
                loss.backward()
                opt.step()
                step_losses.append(loss.detach())
            epoch_loss = float(torch.stack(step_losses).mean())
            if epoch_loss < best_loss:
                best_loss, best = epoch_loss, best_state(net)
            self.history.append({"epoch": e, "loss": epoch_loss, "lr": rate,
                                 "kl_weight": kl_weight})
        clock.tick()
        for h, s in zip(self.history, clock.seconds()):
            h["seconds"] = s
        if best is not None:
            net.load_state_dict(best)
        self.best_loss = best_loss
        for h in self.history[49::50]:
            logger.info("scMVAE epoch %d, loss %.5f", h["epoch"], h["loss"])
        return self

    @torch.no_grad()
    def predict(self, x_mod1=None, x_mod2=None) -> np.ndarray:
        """The joint embedding: the posterior mean (the training inputs by
        default; new ones binarised for the Bernoulli decoder)."""
        x1, x2 = (self._x1, self._x2) if x_mod1 is None else self._inputs(x_mod1, x_mod2)
        return self.net.embed(x1, x2).cpu().numpy()

    def score(self, x, y, *, score_func=None, return_pred: bool = False,
              metric: str = "clustering", batch=None, **kwargs):
        """k-means NMI of the embedding against ``y`` (``"clustering"``) or
        the scIB suite's ``final_scores`` (``"openproblems"``) (counterpart:
        :508)."""
        return score_embedding(self.predict(), y, metric=metric, batch=batch, device=self.device,
                               return_pred=return_pred, **kwargs)


class ProductOfExperts:
    """:func:`product_of_experts` as the reference's callable (counterpart: :524)."""

    def __call__(self, mu, logvar, eps: float = 1e-8):
        return product_of_experts(torch.as_tensor(mu), torch.as_tensor(logvar), eps=eps)

    forward = __call__


def prior_expert(size) -> Tuple[torch.Tensor, torch.Tensor]:
    """The N(0, I) prior expert's mean and log-variance (counterpart: :534)."""
    return torch.zeros(size), torch.zeros(size)


__all__ = ["ProductOfExperts", "build_multi_layers", "calculate_log_library_size",
           "elbo_terms", "prior_expert", "product_of_experts", "scMVAE", "scmvae_loss"]
