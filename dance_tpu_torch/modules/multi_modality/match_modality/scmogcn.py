"""scMoGNN for modality matching: each modality's cells are propagated over
its cell-feature graph into a stack of per-hop embeddings, a learned softmax
mixes the hops, two MLP encoders map the mixes to L2-normalised embeddings
trained with a CLIP-style symmetric cross-entropy over the in-batch
similarity logits (plus cross- and self-reconstruction losses), and the test
cells are matched by batch-separated bipartite matching.

Counterpart: dance_tpu/modules/multi_modality/match_modality/scmogcn.py
(``propagation_layer_combination`` :36, ``expression_propagation`` :53,
``ScMoGCN`` :89, ``_match_train_step`` :156, ``_match_train_run`` :187,
``ScMoGCNWrapper`` :258-398). The propagation's products are
:func:`~dance_tpu_torch.ops.sparse.csr_matmat` and ``csr_rmatmat`` (XLA
segment sums in JAX, outside Pallas): this path reaches no TPU kernel.

Where this differs from the JAX package, on purpose:

- The port's :class:`ScMoGCN` also holds the two hop-mixing logits ``wt1``
  and ``wt2``, which JAX keeps beside the flax params
  (:func:`~dance_tpu_torch.utils.params.scmogcn_match_flax_to_torch` maps
  them).
- Random draws are torch's: the initial weights (flax's init, from a CPU
  generator seeded with ``seed``), each epoch's shuffle of the training
  cells (a CPU generator, so the card and the CPU draw the same batches) and
  the dropout masks (a generator on the device). The validation split is
  JAX's: numpy's ``default_rng(seed)``, bit for bit. Tests hand JAX's
  orders over through :meth:`ScMoGCNWrapper._epoch_order`.
- Dropout follows JAX's protocol, not the reference's: a training step
  draws one mask per dropout layer and applies the decoders' masks to both
  their passes, the cross-modal prediction and the reconstruction, as JAX
  hands one dropout key to ``encode`` and both ``decode`` calls
  (:163-173). The reference draws independent masks for the two passes.
- The fit is a Python loop that reads the validation accuracy once an
  epoch (JAX runs the whole fit as one ``while_loop``); the selection
  rule, a strictly better validation score, and the stop rule,
  ``epoch - best_epoch >= early_stopping``, are JAX's.
"""

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F
from torch import nn

from dance_tpu_torch.modules.multi_modality.match_modality.base import MatchingScoreMixin
from dance_tpu_torch.nn.gnn import flax_dense_init_
from dance_tpu_torch.ops.sparse import csr_from_scipy, csr_matmat, csr_rmatmat
from dance_tpu_torch.settings import logger
from dance_tpu_torch.utils import EpochClock, resolve_device
from dance_tpu_torch.utils.metrics import batch_separated_bipartite_matching
from dance_tpu_torch.utils.optim import adamw, best_state


def propagation_layer_combination(X, Y, idx, wt1, wt2, from_logits: bool = True):
    """The hop stacks ``X`` (hops, cells, d1) and ``Y`` mixed at the cells
    ``idx`` by the softmax of ``wt1`` and ``wt2`` (their raw values with
    ``from_logits=False``) (counterpart: :36)."""
    if from_logits:
        wt1 = torch.softmax(wt1, -1)
    x = 0
    for i in range(wt1.shape[0]):
        x = x + wt1[i] * X[i][idx]
    if from_logits:
        wt2 = torch.softmax(wt2, -1)
    y = 0
    for i in range(wt2.shape[0]):
        y = y + wt2[i] * Y[i][idx]
    return x, y


def _std_guarded(h: torch.Tensor) -> torch.Tensor:
    """Global standardisation, with a unit scale where the mean is 0 (JAX's
    ``std_guarded``: population deviation, ddof 0, over the whole matrix)."""
    mean = h.mean()
    scale = torch.where(mean != 0, h.std(correction=0), torch.ones_like(mean))
    return (h - mean) / scale.clamp(min=1e-12)


def _std(h: torch.Tensor) -> torch.Tensor:
    return (h - h.mean()) / h.std(correction=0).clamp(min=1e-12)


def expression_propagation(x, *, layers: int = 4, alpha: float = 0.5, beta: float = 0.5,
                           device="auto") -> List[torch.Tensor]:
    """Per-hop cell embeddings over the cell-feature graph of ``x`` (cells x
    features) (counterpart: :53, the reference's ``cell_feature_propagation``).
    Features start one-hot, cells at zero; each hop convolves both ways
    (``A`` and ``Aᵀ`` as weighted sums), standardises globally and mixes with
    the previous hop by ``alpha`` (features) and ``beta`` (cells). Returns
    the cell embeddings of hops 2 .. ``layers``, ``layers - 1`` tensors of
    shape (cells, features) on ``device`` (the card unless the CPU is
    named)."""
    device = resolve_device(device)
    a = csr_from_scipy(sp.csr_matrix(np.asarray(x, np.float32))).to(device)
    n_cells, n_feat = a.shape
    h_feat = torch.eye(n_feat, device=device)
    h_cell = torch.zeros((n_cells, n_feat), device=device)
    hcell = []
    for _ in range(layers):
        h1_feat = _std_guarded(csr_rmatmat(a, h_cell))
        h1_cell = _std_guarded(csr_matmat(a, h_feat))
        h_feat = _std(h_feat * alpha + h1_feat * (1 - alpha))
        h_cell = _std(h_cell * beta + h1_cell * (1 - beta))
        hcell.append(h_cell)
    return hcell[1:]


# the reference's name (match_modality/scmogcn.py:41)
cell_feature_propagation = expression_propagation


class ScMoGCN(nn.Module):
    """The four MLP stacks (counterpart: :89): encoders of modality 1 and 2
    with L2-normalised outputs, decoders from the latent to modality 1 and
    2. ``layers`` holds, per stack, ``(in, out[, dropout])`` per layer; every
    layer but the last is followed by the tanh GELU (flax's ``gelu``) and its
    dropout. ``n_hops`` sizes the hop-mixing logits ``wt1`` and ``wt2``
    (zeros), which JAX keeps beside the flax params."""

    def __init__(self, layers: Sequence[Sequence[Sequence]], temp: float = 1.0,
                 n_hops: int = 3):
        super().__init__()
        self.temp = temp
        self.stacks = nn.ModuleList(nn.ModuleList(nn.Linear(s[0], s[1]) for s in shape)
                                    for shape in layers)
        # dropout rate after each layer (0.0 where there is none)
        self.rates = [[float(s[2]) if len(s) == 3 and i < len(shape) - 1 else 0.0
                       for i, s in enumerate(shape)] for shape in layers]
        self.wt1 = nn.Parameter(torch.zeros(n_hops))
        self.wt2 = nn.Parameter(torch.zeros(n_hops))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's ``Dense`` init for every layer; the hop logits at zero."""
        for stack in self.stacks:
            for lin in stack:
                flax_dense_init_(lin, generator)
        nn.init.zeros_(self.wt1)
        nn.init.zeros_(self.wt2)

    def draw_masks(self, n: int, generator: torch.Generator) -> List[List]:
        """One keep mask (n, width) per dropout layer of every stack, None
        where a layer drops nothing, drawn on the generator's device."""
        dev = generator.device
        return [[None if rate == 0.0 else
                 torch.rand((n, lin.out_features), generator=generator, device=dev) >= rate
                 for rate, lin in zip(rates, stack)]
                for rates, stack in zip(self.rates, self.stacks)]

    def _run(self, j: int, h: torch.Tensor, masks=None) -> torch.Tensor:
        stack = self.stacks[j]
        for i, lin in enumerate(stack):
            h = lin(h)
            if i < len(stack) - 1:
                h = F.gelu(h, approximate="tanh")
                if masks is not None and masks[j][i] is not None:
                    keep = 1.0 - self.rates[j][i]
                    h = torch.where(masks[j][i], h / keep, torch.zeros((), device=h.device))
        return h

    def encode(self, m1, m2, masks=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both encoders, each row divided by its norm (no epsilon, as
        ``jnp.linalg.norm`` in JAX)."""
        e1, e2 = self._run(0, m1, masks), self._run(1, m2, masks)
        return (e1 / torch.linalg.norm(e1, dim=-1, keepdim=True),
                e2 / torch.linalg.norm(e2, dim=-1, keepdim=True))

    def decode(self, e1, e2, masks=None) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._run(2, e1, masks), self._run(3, e2, masks)

    def logits(self, e1, e2) -> torch.Tensor:
        return e1 @ e2.T * math.exp(self.temp)

    def forward(self, m1, m2) -> torch.Tensor:
        return self.logits(*self.encode(m1, m2))


def symmetric_contrastive_loss(logits: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of the rows and of the columns against the diagonal, the
    CLIP objective (counterpart: ``_symmetric_contrastive_loss``, :141)."""
    labels = torch.arange(logits.shape[0], device=logits.device)
    return F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)


def match_loss(net: ScMoGCN, H1, H2, idx, aux: int, masks=None) -> torch.Tensor:
    """The training loss at the cells ``idx`` (counterpart: the ``loss_fn`` of
    ``_match_train_step``, :159-179): one encoder pass feeds the logits and
    both decode directions; with ``aux > 0`` the cross-modal prediction and
    reconstruction MSEs join the contrastive loss. ``masks`` from
    :meth:`ScMoGCN.draw_masks` (None: no dropout), the decoders' shared by
    both of their passes."""
    X, Y = propagation_layer_combination(H1, H2, idx, net.wt1, net.wt2)
    e1, e2 = net.encode(X, Y, masks)
    loss = symmetric_contrastive_loss(net.logits(e1, e2))
    if aux > 0:
        pred1, pred2 = net.decode(e2, e1, masks)
        rec1, rec2 = net.decode(e1, e2, masks)
        loss2 = ((pred1 - X) ** 2).mean() + ((pred2 - Y) ** 2).mean()
        loss3 = ((rec1 - X) ** 2).mean() + ((rec2 - Y) ** 2).mean()
        loss = loss + loss2 + loss3
    return loss


def match_train_step(net: ScMoGCN, opt: torch.optim.Optimizer, H1, H2, idx, aux: int,
                     masks=None) -> torch.Tensor:
    """One step of ``opt`` (optax's ``adamw``, :func:`~dance_tpu_torch.utils.optim.adamw`)
    on :func:`match_loss` (counterpart: ``_match_train_step``,
    :156); returns the loss, detached."""
    opt.zero_grad(set_to_none=True)
    loss = match_loss(net, H1, H2, idx, aux, masks)
    loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def match_val_score(net: ScMoGCN, H1, H2, idx) -> torch.Tensor:
    """Matching accuracy of the cells ``idx`` among themselves, forward and
    backward averaged, on the device (counterpart: ``_match_val_score``, :247)."""
    X, Y = propagation_layer_combination(H1, H2, idx, net.wt1, net.wt2)
    logits = net(X, Y)
    lab = torch.arange(idx.shape[0], device=logits.device)
    return ((logits.argmax(1) == lab).float().mean()
            + (logits.argmax(0) == lab).float().mean()) / 2


class ScMoGCNWrapper(MatchingScoreMixin):
    """scMoGNN modality matching (counterpart: :258). ``device="auto"`` is
    the card."""

    _DEFAULT_METRIC = "acc"
    _DISPLAY_ATTRS = ("latent_dim", "prop_layers")

    def __init__(self, args=None, layers=None, temp: float = 1.0, latent_dim: int = 64,
                 prop_layers: int = 4, learning_rate: float = 6e-4, auxiliary_loss: int = 1,
                 seed: int = 0, device="auto"):
        if args is not None:
            prop_layers = getattr(args, "layers", prop_layers)
            learning_rate = getattr(args, "learning_rate", learning_rate)
            auxiliary_loss = int(getattr(args, "auxiliary_loss", auxiliary_loss))
            seed = getattr(args, "seed", seed)
        self.layers_spec = layers
        self.temp = temp
        self.latent_dim = latent_dim
        self.prop_layers = prop_layers
        self.learning_rate = learning_rate
        self.auxiliary_loss = auxiliary_loss
        self.seed = seed
        self.device = resolve_device(device)
        self.net: Optional[ScMoGCN] = None
        self.history: List[Dict[str, float]] = []  # per epoch: epoch, loss, val, seconds

    def _default_layers(self, d1: int, d2: int):
        """The reference cite-task stacks (example scmogcn.py:57-64), the
        hidden width ``4 * latent_dim`` within [32, 512] (counterpart: :282)."""
        h = min(512, max(32, 4 * self.latent_dim))
        L = self.latent_dim
        return (((d1, h, 0.25), (h, h, 0.25), (h, L)),
                ((d2, h, 0.2), (h, h, 0.2), (h, L)),
                ((L, h, 0.2), (h, d1)),
                ((L, h, 0.2), (h, d2)))

    def _make_net(self, d1: int, d2: int) -> ScMoGCN:
        """A new net with flax's init drawn from ``seed``, on the device."""
        spec = self.layers_spec or self._default_layers(d1, d2)
        net = ScMoGCN(spec, temp=self.temp, n_hops=self.prop_layers - 1)
        net.reset_parameters(torch.Generator().manual_seed(self.seed))
        return net.to(self.device)

    def _epoch_order(self, epoch: int, train_idx: np.ndarray, n: int,
                     generator: torch.Generator) -> np.ndarray:
        """The first ``n`` training cells of the epoch's shuffle (JAX:
        ``jax.random.permutation`` of ``fold_in(key, epoch)``, :201)."""
        return train_idx[torch.randperm(len(train_idx), generator=generator)[:n].numpy()]

    def fit(self, x_mod1, x_mod2, x_mod1_test=None, x_mod2_test=None, epochs: int = 2000,
            batch_size: int = 4096, early_stopping: int = 20, alpha: float = 0.5,
            beta: float = 0.5):
        """Contrastive fit (counterpart: :292). The test cells, where given,
        join the propagation graphs but no training batch. The last
        ``batch_size`` training cells of a seeded shuffle are the validation
        block, whose matching accuracy picks the best epoch and stops the fit
        ``early_stopping`` epochs after it; the best epoch's weights are
        kept."""
        x1 = np.asarray(x_mod1, np.float32)
        x2 = np.asarray(x_mod2, np.float32)
        train_size = len(x1)
        if x_mod1_test is not None:
            x1 = np.concatenate([x1, np.asarray(x_mod1_test, np.float32)])
            x2 = np.concatenate([x2, np.asarray(x_mod2_test, np.float32)])
        self.train_size = train_size
        kw = dict(layers=self.prop_layers, alpha=alpha, beta=beta, device=self.device)
        self.feat_mod1 = H1 = torch.stack(expression_propagation(x1, **kw))  # (L-1, N, d1)
        self.feat_mod2 = H2 = torch.stack(expression_propagation(x2, **kw))
        self.net = net = self._make_net(H1.shape[2], H2.shape[2])
        opt = adamw(net, self.learning_rate)
        # the reference's split: a permutation of the training cells, the last bs validate
        bs = min(batch_size, max(2, math.floor(train_size / 2)))
        idx = np.random.default_rng(self.seed).permutation(train_size)
        train_idx, val_idx = idx[:-bs], idx[-bs:]
        n_steps = max(1, len(train_idx) // bs)
        self.split = {"train": train_idx, "valid": val_idx}
        val_dev = torch.as_tensor(val_idx).to(self.device)
        order_gen = torch.Generator().manual_seed(self.seed)
        mask_gen = torch.Generator(device=self.device).manual_seed(self.seed)
        best_val, best_epoch, best = -math.inf, 0, best_state(net)
        clock, self.history = EpochClock(self.device), []
        for epoch in range(epochs):
            clock.tick()
            net.train()
            order = torch.as_tensor(self._epoch_order(epoch, train_idx, n_steps * bs, order_gen))
            order = order.to(self.device).view(n_steps, bs)
            losses = [match_train_step(net, opt, H1, H2, order[s], self.auxiliary_loss,
                                       net.draw_masks(bs, mask_gen)) for s in range(n_steps)]
            net.eval()
            val = float(match_val_score(net, H1, H2, val_dev))
            if val > best_val:
                best_val, best_epoch, best = val, epoch, best_state(net)
            self.history.append({"epoch": epoch, "loss": torch.stack(losses).mean(), "val": val})
            if epoch - best_epoch >= early_stopping:
                break
        clock.tick()
        for h, s in zip(self.history, clock.seconds()):
            h["loss"], h["seconds"] = float(h["loss"]), s
        net.load_state_dict(best)
        net.eval()
        if len(self.history) < epochs:
            logger.info("scMoGNN-match early stopped at epoch %d", len(self.history) - 1)
        logger.info("scMoGNN-match best val %.4f at epoch %d (%d epochs, final loss %.5f)",
                    best_val, best_epoch, len(self.history), self.history[-1]["loss"])
        self.best_val, self.best_epoch = best_val, best_epoch
        self.wt = [net.wt1.detach(), net.wt2.detach()]
        return self

    # -- inference (counterpart: :353-398) -----------------------------------
    def _combine(self, idx):
        idx = torch.as_tensor(np.asarray(idx)).to(self.device)
        return propagation_layer_combination(self.feat_mod1, self.feat_mod2, idx,
                                             self.net.wt1, self.net.wt2)

    @torch.no_grad()
    def predict(self, idx, enhance: bool = False, batch1=None, batch2=None,
                threshold_quantile: float = 0.95) -> np.ndarray:
        """The matching logits of the cells ``idx`` (n, n), or with
        ``enhance`` the 0/1 matrix of batch-separated bipartite matching of
        their embeddings, within the batch labels ``batch1[idx]`` (all one
        batch when ``batch1`` is None)."""
        m1, m2 = self._combine(idx)
        if not enhance:
            return self.net(m1, m2).cpu().numpy()
        e1, e2 = self.net.encode(m1, m2)
        idx = np.asarray(idx)
        if batch1 is None:
            batch1 = np.zeros(len(idx), dtype=int)
            batch2 = np.zeros(len(idx), dtype=int)
        else:
            batch1, batch2 = np.asarray(batch1)[idx], np.asarray(batch2)[idx]
        return batch_separated_bipartite_matching(batch1, batch2, e1.cpu().numpy(),
                                                  e2.cpu().numpy(), threshold_quantile)

    def score(self, idx, labels1=None, labels2=None, labels_matrix=None, enhance: bool = False,
              batch1=None, batch2=None, threshold_quantile: float = 0.95) -> float:
        """Matching accuracy of the cells ``idx``: the logits' argmax against
        ``labels2`` (forward) and ``labels1`` (backward), averaged; with
        ``enhance``, the bipartite matching's hits on ``labels_matrix`` per
        cell."""
        if not enhance:
            logits = self.predict(idx)
            backward = float((logits.argmax(0) == np.asarray(labels1)).mean())
            forward = float((logits.argmax(1) == np.asarray(labels2)).mean())
            return (forward + backward) / 2
        matrix = self.predict(idx, enhance, batch1, batch2, threshold_quantile)
        labels_matrix = np.asarray(labels_matrix)
        return float((matrix * labels_matrix).sum() / labels_matrix.shape[0])

    def predict_matching(self, x1=None, x2=None, batch1=None, batch2=None,
                         threshold_quantile: float = 0.995) -> np.ndarray:
        """The matching matrix of the fitted test block (of the training
        cells when the fit had none)."""
        idx = np.arange(self.train_size, self.feat_mod1.shape[1])
        if len(idx) == 0:
            idx = np.arange(self.train_size)
        return self.predict(idx, enhance=True, batch1=batch1, batch2=batch2,
                            threshold_quantile=threshold_quantile)


__all__ = ["ScMoGCN", "ScMoGCNWrapper", "adamw", "cell_feature_propagation",
           "expression_propagation", "match_loss", "match_train_step", "match_val_score",
           "propagation_layer_combination", "symmetric_contrastive_loss"]
