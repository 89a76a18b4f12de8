"""DeepImpute: an ensemble of small networks, each predicting one block of
target genes from its predictor genes.

Counterpart: dance_tpu/modules/single_modality/imputation/deepimpute.py
(``_SubNet`` :31-47, ``preprocessing_pipeline`` :81-111, ``_pad_layout``
:113-126, ``_pregather`` :129-142, the epochs :144-192, ``fit`` :194-274,
the early-stopping protocols :276-426, ``predict`` :428-441). Each subnet is
Linear -> ReLU -> dropout -> Linear -> softplus; the ensemble trains as one
model, its subnets' weights stacked on a leading axis and every layer one
batched product (``torch.baddbmm``), as JAX's vmapped ``dot_general``. The
predictor lists are padded to the longest with **gene 0** (so a short
subnet's padded inputs read gene 0's column, as in JAX), the target lists
with gene 0 under a zero loss mask. The training loss is the mean over
subnets of each one's masked wMSE (squared errors weighted by the true
expression, over the mask's count), so each subnet's gradient is scaled by
1 / n_ens before Adam.

Two early-stopping protocols, as in JAX:

- the default: a 95 / 5 split (none at 20 cells or fewer, or patience 0),
  wrap-padded batches reshuffled every epoch, flax's default init
  (lecun-normal kernels, zero biases), the mean wMSE on the validation
  cells, the best weights kept, and a stop after ``patience`` epochs in a
  row without a new best;
- ``reference_protocol=True``, the reference's own: a 90 / 10 split, a short
  last batch (:func:`~dance_tpu_torch.utils.batch.epoch_batches_masked`),
  ``torch.nn.Linear``'s default init, gradients that **accumulate** across
  batches and epochs (the reference never zeroes them), each subnet's plain
  validation MSE, its weights saved whenever that equals its best, a
  patience counter that never resets, and subnets that stop one by one (a
  stopped subnet's weights are put back after each step while the shared
  Adam state goes on).

Where this differs from the JAX package: the epochs are loops that read the
validation loss once per epoch (JAX folds them into one scan); the weights
are drawn at each ``fit`` from a CPU ``torch.Generator`` seeded with
``seed``, the batch orders from another and the dropout masks from a
generator on the device. Parity tests copy the flax weights in
(:func:`dance_tpu_torch.utils.params.deepimpute_flax_to_torch`, through a
patched :meth:`DeepImpute._make_net`) and JAX's batch orders. ``history``
records each epoch's mean training loss, validation loss and seconds.
:func:`deepimpute_preprocess` is the array front of ``preprocessing_pipeline``:
it runs the pipeline on a matrix wrapped in a ``Data``. The pipeline draws
``GeneHoldout``'s blocks from ``seed`` too, where JAX's leaves them unseeded.

Under ``fit_distributed`` (deepimpute.py:237-242) each rank holds its rows
of the train and validation cells; every rank walks the same batches and
draws each batch's dropout uniforms whole, computes the wMSE numerators of
the batch's cells it holds over the whole batch's mask counts, and the
gradients are summed over ``dp``; the validation losses sum numerators and
counts over the ranks, so every rank takes the same early-stopping
decisions.
"""

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from dance_tpu_torch.modules.base import (BaseRegressionMethod, dense32, row_positions,
                                          wrap_matrix)
from dance_tpu_torch.nn.gnn import flax_dropout, truncated_normal_
from dance_tpu_torch.parallel.mesh import RowShard, to_device
from dance_tpu_torch.settings import logger
from dance_tpu_torch.transforms.filter import FilterCellsScanpy, FilterGenesScanpy
from dance_tpu_torch.transforms.gene_holdout import GeneHoldout
from dance_tpu_torch.transforms.interface import AnnDataTransform
from dance_tpu_torch.transforms.mask import CellwiseMaskData, entry_masks
from dance_tpu_torch.transforms.misc import Compose, SaveRaw, SetConfig
from dance_tpu_torch.utils import EpochClock, resolve_device
from dance_tpu_torch.utils.batch import epoch_batches, epoch_batches_masked


class _SubNet(nn.Module):
    """``n_ens`` subnets stacked: ``w1`` (n_ens, in, hidden), ``b1`` (n_ens,
    hidden), ``w2`` (n_ens, hidden, out), ``b2`` (n_ens, out), each
    subnet computing ``softplus(relu(x @ w1 + b1) @ w2 + b2)`` with dropout
    after the ReLU (counterpart: deepimpute.py:31, one subnet there)."""

    def __init__(self, n_ens: int, in_dim: int, out_dim: int, hidden_dim: int = 256,
                 dropout: float = 0.2):
        super().__init__()
        self.dropout = dropout
        self.w1 = nn.Parameter(torch.empty(n_ens, in_dim, hidden_dim))
        self.b1 = nn.Parameter(torch.empty(n_ens, hidden_dim))
        self.w2 = nn.Parameter(torch.empty(n_ens, hidden_dim, out_dim))
        self.b2 = nn.Parameter(torch.empty(n_ens, out_dim))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None,
                         torch_init: bool = False):
        """flax ``Dense``'s default init per subnet (a truncated lecun-normal
        kernel, a zero bias), or with ``torch_init`` ``nn.Linear``'s (kernel
        and bias U(±1/sqrt(fan_in))), subnet by subnet."""
        for i in range(self.w1.shape[0]):
            for w, b in ((self.w1, self.b1), (self.w2, self.b2)):
                bound = 1.0 / math.sqrt(w.shape[1])
                if torch_init:
                    nn.init.uniform_(w[i], -bound, bound, generator=generator)
                    nn.init.uniform_(b[i], -bound, bound, generator=generator)
                else:
                    truncated_normal_(w[i], bound, generator)
                    b[i].zero_()

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                batch: Optional[Tuple[Optional[torch.Tensor], int]] = None):
        """``x`` (n_ens, n, in) -> (n_ens, n, out); dropout only with a
        ``generator`` (training). With ``batch = (pos, size)`` the rows of
        ``x`` are the positions ``pos`` of a batch of ``size`` rows, and the
        dropout uniforms are drawn for the whole batch and cut to them."""
        h = torch.relu(torch.baddbmm(self.b1[:, None], x, self.w1))
        h = flax_dropout(h, self.dropout, generator, batch, dim=1)
        out = torch.baddbmm(self.b2[:, None], h, self.w2)
        # jax.nn.softplus is logaddexp(x, 0)
        return torch.logaddexp(out, torch.zeros((), dtype=out.dtype, device=out.device))


# the reference's name for the inner model (deepimpute.py:41)
NeuralNetworkModel = _SubNet


def _wmse_terms(pred, y, m):
    """Per subnet: the squared errors weighted by ``y``, summed, and the
    mask's count (the wMSE is their ratio, the count at least 1)."""
    return (y * m * (y - pred) ** 2).sum((1, 2)), m.sum((1, 2))


def _wmse(pred, y, m) -> torch.Tensor:
    """Per subnet: the wMSE of one batch, as a single fit takes it."""
    num, count = _wmse_terms(pred, y, m)
    return num / torch.clamp(count, min=1.0)


def _mse_terms(pred, y, m):
    """Per subnet: the masked squared errors, summed, and the mask's count
    (the reference's validation loss is their ratio)."""
    return (m * (pred - y) ** 2).sum((1, 2)), m.sum((1, 2))


class DeepImpute(BaseRegressionMethod):
    """DeepImpute (counterpart: deepimpute.py:55). ``predictors[i]`` and
    ``targets[i]`` are the gene indices of subnet ``i`` (the output of
    :func:`deepimpute_preprocess`)."""

    _DISPLAY_ATTRS = ("sub_outputdim", "hidden_dim", "dropout")

    def __init__(self, predictors, targets, dataset: str = "", sub_outputdim: int = 512,
                 hidden_dim: int = 256, dropout: float = 0.2, seed: int = 1, gpu: int = -1,
                 reference_protocol: bool = False, device="auto"):
        # dataset and gpu keep the reference's signature
        self.predictors = [np.asarray(p) for p in predictors]
        self.targets = [np.asarray(t) for t in targets]
        self.sub_outputdim = sub_outputdim
        self.hidden_dim = hidden_dim
        self.dropout = dropout
        self.seed = seed
        self.reference_protocol = reference_protocol
        self.device = resolve_device(device)
        self.net: Optional[_SubNet] = None
        self.history: List[Dict[str, float]] = []  # per epoch: epoch, loss, val, seconds
        self.stopped = None  # reference protocol: the subnets that stopped

    def _pad_layout(self):
        """Predictor and target indices padded with 0 to rectangles, and the
        targets' mask (counterpart: deepimpute.py:113)."""
        p_max = max(len(p) for p in self.predictors)
        t_max = max(len(t) for t in self.targets)
        n_ens = len(self.targets)
        pred_idx = np.zeros((n_ens, p_max), np.int64)
        targ_idx = np.zeros((n_ens, t_max), np.int64)
        targ_mask = np.zeros((n_ens, t_max), np.float32)
        for i, (p, t) in enumerate(zip(self.predictors, self.targets)):
            pred_idx[i, :len(p)] = p
            targ_idx[i, :len(t)] = t
            targ_mask[i, :len(t)] = 1
        return pred_idx, targ_idx, targ_mask

    def _make_net(self, p_max: int, t_max: int) -> _SubNet:
        """A new ensemble with its init drawn from ``seed``, on the device."""
        net = _SubNet(len(self.targets), p_max, t_max, self.hidden_dim, self.dropout)
        net.reset_parameters(torch.Generator().manual_seed(self.seed), self.reference_protocol)
        return net.to(self.device)

    def _pregather(self, X: torch.Tensor, Y=None, M=None):
        """The per-subnet views (n_ens, n, p_max / t_max) of the predictors,
        the targets and the loss mask, the targets' padding folded into the
        mask (counterpart: deepimpute.py:129)."""
        pred_idx, targ_idx, targ_mask = self._idx
        xp = X[:, pred_idx].permute(1, 0, 2).contiguous()
        if Y is None:
            return xp
        yt = Y[:, targ_idx].permute(1, 0, 2).contiguous()
        mt = M[:, targ_idx].permute(1, 0, 2) * targ_mask[:, None, :]
        return xp, yt, mt

    @staticmethod
    def preprocessing_pipeline(min_cells: float = 0.1, n_top: int = 5, sub_outputdim: int = 512,
                               mask: bool = True, distr: str = "exp", mask_rate: float = 0.1,
                               seed: Optional[int] = 1, log_level: str = "INFO") -> Compose:
        """Genes expressed in at least ``min_cells`` cells (a float in (0, 1)
        a ratio of the gene count, as JAX resolves it), cells with a count,
        the counts kept (``SaveRaw``), ``log1p``, the target blocks of
        ``sub_outputdim`` genes and their ``n_top`` predictors
        (``GeneHoldout``, drawn from ``seed``), and the entry masks with a
        test mask (``CellwiseMaskData``, unless ``mask`` is off)
        (counterpart: deepimpute.py:81-109)."""
        transforms = [
            FilterGenesScanpy(min_cells=min_cells),
            FilterCellsScanpy(min_counts=1),
            SaveRaw(),
            AnnDataTransform("sc.pp.log1p"),
            GeneHoldout(n_top=n_top, batch_size=sub_outputdim, random_state=seed),
        ]
        if mask:
            transforms.extend([
                CellwiseMaskData(distr=distr, mask_rate=mask_rate, seed=seed,
                                 add_test_mask=True),
                SetConfig({"feature_channel": [None, None, "targets", "predictors",
                                               "train_mask", "valid_mask", "test_mask"],
                           "feature_channel_type": ["X", "raw_X", "uns", "uns",
                                                    "layers", "layers", "layers"],
                           "label_channel": [None, None],
                           "label_channel_type": ["X", "raw_X"]}),
            ])
        else:
            transforms.append(SetConfig({
                "feature_channel": [None, None, "targets", "predictors"],
                "feature_channel_type": ["X", "raw_X", "uns", "uns"],
                "label_channel": [None, None],
                "label_channel_type": ["X", "raw_X"]}))
        return Compose(*transforms, log_level=log_level)

    def fit(self, X, Y, mask=None, batch_size: int = 64, lr: float = 1e-3, n_epochs: int = 100,
            patience: int = 5, train_idx=None):
        """Train a new ensemble (counterpart: deepimpute.py:194) to predict
        ``Y`` from ``X`` on the entries where ``mask`` is set (all without
        one), on the cells ``train_idx`` (all without)."""
        X, Y = (np.asarray(a.toarray() if sp.issparse(a) else a, np.float32) for a in (X, Y))
        mask = np.ones_like(X) if mask is None else np.asarray(mask, np.float32)
        if train_idx is not None:
            sel = np.asarray(train_idx)
            X, Y, mask = X[sel], Y[sel], mask[sel]
        dev = self.device
        pred_idx, targ_idx, targ_mask = self._pad_layout()
        if pred_idx.shape[1] == 0:
            raise ValueError("no subnet has a predictor gene: one target block holds every "
                             "gene (fewer genes than sub_outputdim)")
        self._idx = tuple(torch.from_numpy(a).to(dev) for a in (pred_idx, targ_idx, targ_mask))
        self.net = net = self._make_net(pred_idx.shape[1], targ_idx.shape[1])
        opt = torch.optim.Adam(net.parameters(), lr=lr)

        n = X.shape[0]
        perm = np.random.default_rng(self.seed).permutation(n)
        if self.reference_protocol:
            n_val = n - int(n * 0.9) if patience else 0
            tr_sel, val_sel = perm[:int(n * 0.9)], perm[int(n * 0.9):]
        else:
            n_val = max(int(0.05 * n), 1) if n > 20 and patience else 0
            val_sel, tr_sel = perm[:n_val], perm[n_val:]

        def views(sel):
            return self._pregather(*(to_device(np.ascontiguousarray(a[sel]), device=dev)
                                     for a in (X, Y, mask)))

        train, val = views(tr_sel), (views(val_sel) if n_val else None)
        # this rank's rows in a data-parallel fit (deepimpute.py:237-242)
        self._shards = (RowShard.of(len(tr_sel)), RowShard.of(n_val))
        bs = min(batch_size, len(tr_sel))
        order_gen = torch.Generator().manual_seed(self.seed)
        drop_gen = torch.Generator(device=dev).manual_seed(self.seed)
        # JAX's no-validation path runs the default epochs in either protocol
        reference = self.reference_protocol and val is not None

        def epoch():
            return self._train_epoch(opt, train, order_gen, drop_gen, bs, accumulate=reference)

        if reference:
            self._fit_reference(epoch, val, n_epochs, patience)
        else:
            self._fit_default(epoch, val, n_epochs, patience)
        return self

    def _train_epoch(self, opt, train, order_gen, drop_gen, bs: int,
                     accumulate: bool) -> torch.Tensor:
        """One pass over wrap-padded batches, one Adam step on each
        (counterpart: deepimpute.py:144); with ``accumulate`` (the reference
        protocol) the last batch is short, masked, and the gradients are
        never zeroed, so each step applies the sum of every gradient so far
        (deepimpute.py:358). In a data-parallel fit each rank computes the
        wMSE numerators of the batch's cells it holds, with their dropout
        uniforms cut from the whole batch's, over the whole batch's mask
        counts, and the gradients are summed over ``dp``."""
        xp, yt, mt = train
        shard, params = self._shards[0], list(self.net.parameters())
        if accumulate:
            idx, rows_mask = epoch_batches_masked(order_gen, shard.n, bs)
        else:
            idx = epoch_batches(order_gen, shard.n, bs)
            rows_mask = torch.ones(idx.shape)
        losses = []
        for rows, rm in zip(idx.to(xp.device), rows_mask.to(xp.device)):
            pos, loc = shard.split(rows)
            bm = mt[:, loc] * RowShard.take(rm, pos)[None, :, None]
            pred = self.net(xp[:, loc], drop_gen, (pos, len(rows)))
            num, count = _wmse_terms(pred, yt[:, loc], bm)
            loss = (num / torch.clamp(shard.sum(count), min=1.0)).mean()
            acc = [p.grad for p in params] if accumulate else [None] * len(params)
            opt.zero_grad(set_to_none=True)
            losses.append(shard.step(loss, params))
            for p, a in zip(params, acc):
                if a is not None:
                    p.grad = p.grad + a
            opt.step()
        return torch.stack(losses).mean()

    @torch.no_grad()
    def _val(self, val, terms) -> torch.Tensor:
        """Per subnet, the ratio of ``terms`` over the validation cells (of
        every rank: numerators and mask counts summed over ``dp``)."""
        xp, yt, mt = val
        shard = self._shards[1]
        r = shard.real
        num, count = terms(self.net(xp)[:, :r], yt[:, :r], mt[:, :r])
        return shard.sum(num) / torch.clamp(shard.sum(count), min=1.0)

    def _fit_default(self, epoch_fn, val, n_epochs: int, patience: int):
        """The default protocol (counterpart: deepimpute.py:276): the best
        weights on the mean validation wMSE (the initial ones until an epoch
        improves on infinity), a stop after ``patience`` epochs in a row
        without a new best; every epoch without validation."""
        net, clock, rows = self.net, EpochClock(self.device), []
        best_val, counter = math.inf, 0
        best = {k: p.detach().clone() for k, p in net.state_dict().items()}
        for epoch in range(n_epochs):
            clock.tick()
            loss, v = epoch_fn(), None
            if val is not None:
                v = float(self._val(val, _wmse_terms).mean())
                if v < best_val:
                    best_val, counter = v, 0
                    best = {k: p.detach().clone() for k, p in net.state_dict().items()}
                else:
                    counter += 1
            rows.append((epoch, loss, v))
            if val is not None and counter >= patience:
                logger.info("DeepImpute early stopped at epoch %d (val wMSE %.6f)", epoch,
                            best_val)
                break
        clock.tick()
        if val is not None:
            net.load_state_dict(best)
        self._history(rows, clock)

    def _fit_reference(self, epoch_fn, val, n_epochs: int, patience: int):
        """The reference protocol (counterpart: deepimpute.py:314): per
        subnet its weights saved whenever its plain validation MSE is at or
        below its best, a patience counter that never resets, and a stop per
        subnet, whose weights are then put back after every epoch."""
        net, dev, clock, rows = self.net, self.device, EpochClock(self.device), []
        n_ens = net.w1.shape[0]
        params = list(net.parameters())
        best_val = torch.full((n_ens,), math.inf, device=dev)
        best = [p.detach().clone() for p in params]
        counter = torch.zeros(n_ens, dtype=torch.long, device=dev)
        stopped = torch.zeros(n_ens, dtype=torch.bool, device=dev)
        for epoch in range(n_epochs):
            clock.tick()
            before = [p.detach().clone() for p in params]
            loss = epoch_fn()
            with torch.no_grad():
                for p, old in zip(params, before):
                    p.copy_(torch.where(_per_subnet(stopped, p), old, p))
            v = self._val(val, _mse_terms)
            active = ~stopped
            improved = (v <= best_val) & active
            with torch.no_grad():
                for b, p in zip(best, params):
                    b.copy_(torch.where(_per_subnet(improved, p), p, b))
            best_val = torch.where(improved, v, best_val)
            counter = torch.where(active & ~improved, counter + 1, counter)
            stopped = stopped | (counter >= patience)
            rows.append((epoch, loss, float(v.mean())))
            if bool(stopped.all()):  # every later epoch would change nothing
                break
        clock.tick()
        with torch.no_grad():
            for p, b in zip(params, best):
                p.copy_(b)
        self.stopped = stopped.cpu().numpy()
        logger.info("DeepImpute (reference protocol) %d/%d subnets early stopped; mean best "
                    "val MSE %.6f", int(self.stopped.sum()), n_ens, float(best_val.mean()))
        self._history(rows, clock)

    def _history(self, rows, clock: EpochClock):
        self.history = [{"epoch": e, "loss": float(l), "val": v, "seconds": s}
                        for (e, l, v), s in zip(rows, clock.seconds())]
        for h in self.history[::20]:
            logger.info("DeepImpute epoch %d, wMSE %.6f", h["epoch"], h["loss"])

    @torch.no_grad()
    def predict(self, X_test, mask=None, test_idx=None, predict_raw: bool = False):
        """Every target block predicted from its predictors in ``X_test``
        (times ``mask`` when given), on the cells ``test_idx`` (all
        without); the other columns as they are; ``expm1`` of all with
        ``predict_raw`` (counterpart: deepimpute.py:428)."""
        X = np.asarray(X_test.toarray() if sp.issparse(X_test) else X_test, np.float32)
        if test_idx is not None:
            X = X[np.asarray(test_idx)]
        if mask is not None:
            m = np.asarray(mask)
            X = X * (m[np.asarray(test_idx)] if test_idx is not None else m)
        preds = self.net(self._pregather(torch.from_numpy(np.ascontiguousarray(X))
                                         .to(self.device))).cpu().numpy()
        out = X.copy()
        for i, t in enumerate(self.targets):
            out[:, t] = preds[i, :, :len(t)]
        return np.expm1(out) if predict_raw else out


def _per_subnet(flags: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A (n_ens,) flag shaped to broadcast over a stacked parameter."""
    return flags.reshape((-1,) + (1,) * (leaf.ndim - 1))


class DeepImputeInputs(NamedTuple):
    """What :func:`deepimpute_preprocess` returns: ``x`` the log features,
    ``x_raw`` the counts (``SaveRaw``), the subnets' ``targets`` and
    ``predictors``, the entry masks, and the kept ``cells``, ``genes``
    (indices) and ``gene_names``."""

    x: np.ndarray
    x_raw: np.ndarray
    targets: List[np.ndarray]
    predictors: List[np.ndarray]
    train_mask: np.ndarray
    valid_mask: np.ndarray
    test_mask: np.ndarray
    cells: np.ndarray
    genes: np.ndarray
    gene_names: np.ndarray


def deepimpute_preprocess(counts, gene_names: Sequence, seed: Optional[int] = 1, *,
                          min_cells: float = 0.1, sub_outputdim: int = 512, n_top: int = 5,
                          mask: bool = True, distr: str = "exp",
                          mask_rate: float = 0.1) -> DeepImputeInputs:
    """:meth:`DeepImpute.preprocessing_pipeline` on raw ``counts`` (cells x
    genes, numpy or scipy, taken as float32) named ``gene_names``, wrapped in
    a ``Data``, for a caller that holds a matrix. Without ``mask`` the train
    mask is all ones and the others empty."""
    names = np.asarray(gene_names)
    if names.shape != (counts.shape[1],):
        raise ValueError(f"{names.size} gene names for {counts.shape[1]} genes")
    data = wrap_matrix(counts)
    DeepImpute.preprocessing_pipeline(min_cells=min_cells, n_top=n_top,
                                      sub_outputdim=sub_outputdim, mask=mask, distr=distr,
                                      mask_rate=mask_rate, seed=seed, log_level="WARNING")(data)
    adata = data.data
    genes = row_positions(adata.var_names)
    return DeepImputeInputs(dense32(adata.X), dense32(adata.raw.X), adata.uns["targets"],
                            adata.uns["predictors"], *entry_masks(data),
                            row_positions(adata.obs_names), genes, names[genes])


__all__ = ["DeepImpute", "DeepImputeInputs", "NeuralNetworkModel", "deepimpute_preprocess"]
