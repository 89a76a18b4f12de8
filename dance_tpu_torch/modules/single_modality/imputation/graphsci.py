"""GraphSCI: a gene-graph VAE and an expression autoencoder trained jointly
for imputation.

Counterpart: dance_tpu/modules/single_modality/imputation/graphsci.py
(``_BatchNorm`` :29, ``_GNNModel`` :41, ``_AEModel`` :85, ``_GraphSCINet``
:125, ``graphsci_loss`` :147, ``GraphSCI`` :188-340, ``preprocessing_pipeline``
:207-229). Three graph convolutions over the normalised gene-gene graph take
each gene's expression across cells to a mean and a log-std head and sample
a reconstructed gene adjacency ``z_adj``; the autoencoder mixes the
expression through it (``relu(x (z_adj W) + b)``), encodes with two
full-batch-normed layers and decodes the ZINB mean, dispersion and dropout.
The loss is the weighted cross-entropy of ``z_adj``'s rows against the
graph, the masked ZINB NLL of the raw counts and a KL-like term; full batch,
AdamW. The gene graph goes dense where
:func:`~dance_tpu_torch.ops.bsr.choose_adj_format` (no reorder) says so and
CSR otherwise, never BSR, as in JAX (:286-291): its aggregation operand is
genes x cells, so a dense graph is one cuBLAS product a layer. GraphSCI
runs no TPU kernel.

Where this differs from the JAX package:

- The weights are drawn at the first ``fit`` from a CPU ``torch.Generator``
  seeded with ``seed`` (a later ``fit`` goes on from the trained weights, as
  in JAX); parity tests copy the flax weights in
  (:func:`dance_tpu_torch.utils.params.graphsci_flax_to_torch`) by patching
  :meth:`GraphSCI._make_net`.
- The standard-normal noise of ``z_adj``'s sample and the dropout masks
  come from a generator on the device seeded with ``seed``; ``predict``
  draws its noise from one seeded with 0, as JAX samples from ``key(0)``.
  The noise is an argument of :meth:`_GraphSCINet.forward`, drawn by
  :meth:`GraphSCI._noise`, so that a test can hand in JAX's. JAX's
  ``_GNNModel`` draws its three dropout masks from one key; here each is
  drawn anew.
- The epochs are a loop; JAX runs them as one compiled scan. ``history``
  records each epoch's loss and seconds, ``fmt`` the graph's format.
- :func:`graphsci_preprocess` is the array front of
  ``preprocessing_pipeline``: it runs the pipeline on a matrix wrapped in a
  ``Data``.
"""

import hashlib
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from dance_tpu_torch.graph import Graph
from dance_tpu_torch.modules.base import BaseRegressionMethod, wrap_matrix
from dance_tpu_torch.modules.single_modality.imputation.magic import imputation_arrays
from dance_tpu_torch.nn.gnn import flax_dense_init_, flax_dropout
from dance_tpu_torch.nn.mlp import FullBatchNorm as _BatchNorm
from dance_tpu_torch.ops.bsr import choose_adj_format
from dance_tpu_torch.ops.segment import spmm
from dance_tpu_torch.ops.sparse import csr_from_scipy, dense_adj_from_scipy
from dance_tpu_torch.settings import logger
from dance_tpu_torch.transforms.filter import FilterCellsScanpy, FilterGenesScanpy
from dance_tpu_torch.transforms.graph.feature_feature_graph import FeatureFeatureGraph
from dance_tpu_torch.transforms.interface import AnnDataTransform
from dance_tpu_torch.transforms.mask import CellwiseMaskData
from dance_tpu_torch.transforms.misc import Compose, SaveRaw, SetConfig
from dance_tpu_torch.utils import EpochClock, resolve_device


class _GNNModel(nn.Module):
    """Three graph convolutions ``Ã (h W) + b`` over the normalised gene
    graph, tanh then relu, then the mean and the log-std heads, and the
    sample ``z_adj = mean + exp(clip(log_std, -10, 4)) noise`` (counterpart:
    graphsci.py:41). ``w1``/``b1`` ... are flax's raw parameters, ``x @ w``."""

    def __init__(self, in_feats: int, out_feats: int, n_hidden1: int = 256,
                 n_hidden2: int = 256):
        super().__init__()
        shapes = {"1": (in_feats, n_hidden1), "2": (n_hidden1, n_hidden2),
                  "_mean": (n_hidden2, out_feats), "_log_std": (n_hidden2, out_feats)}
        for name, shape in shapes.items():
            setattr(self, f"w{name}", nn.Parameter(torch.empty(shape)))
            setattr(self, f"b{name}", nn.Parameter(torch.zeros(shape[1])))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's ``glorot_uniform`` weights and zero biases."""
        for name, p in self.named_parameters():
            if name.startswith("w"):
                nn.init.xavier_uniform_(p, generator=generator)
            else:
                nn.init.zeros_(p)

    def forward(self, adj, feat: torch.Tensor, noise: torch.Tensor, dropout: float = 0.0,
                dropout_gen: Optional[torch.Generator] = None):
        """``(z_adj, z_adj_log_std, z_adj_mean)``."""
        def dp(h):
            return flax_dropout(h, dropout, dropout_gen)

        h = torch.tanh(spmm(adj, dp(feat) @ self.w1) + self.b1)
        h = torch.relu(spmm(adj, dp(h) @ self.w2) + self.b2)
        hd = dp(h)
        z_mean = spmm(adj, hd @ self.w_mean) + self.b_mean
        z_log_std = spmm(adj, hd @ self.w_log_std) + self.b_log_std
        z_adj = z_mean + torch.exp(torch.clamp(z_log_std, -10.0, 4.0)) * noise
        return z_adj, z_log_std, z_mean


class _AEModel(nn.Module):
    """The MultiplyLayer ``relu(x (z_adj W) + b)``, two Dense + full-batch
    norm + relu layers, and the sigmoid, clamped-softplus and clamped-exp
    heads (counterpart: graphsci.py:85). ``mul_fc`` has no bias; ``mul_bias``
    is its own parameter, as in flax."""

    def __init__(self, in_feats: int, n_hidden1: int = 256, n_hidden2: int = 256):
        super().__init__()
        self.mul_fc = nn.Linear(in_feats, in_feats, bias=False)
        self.mul_bias = nn.Parameter(torch.zeros(in_feats))
        self.enc1 = nn.Linear(in_feats, n_hidden1)
        self.enc2 = nn.Linear(n_hidden1, n_hidden2)
        self.bn1 = _BatchNorm(n_hidden1)
        self.bn2 = _BatchNorm(n_hidden2)
        self.dec_pi = nn.Linear(n_hidden2, in_feats)
        self.dec_disp = nn.Linear(n_hidden2, in_feats)
        self.dec_mean = nn.Linear(n_hidden2, in_feats)

    def forward(self, x: torch.Tensor, z_adj: torch.Tensor, size_factors: torch.Tensor,
                dropout: float = 0.0, dropout_gen: Optional[torch.Generator] = None):
        """``(x_exp, mean, disp, pi)``, ``x_exp`` the mean times the size factors."""
        def dp(h):
            return flax_dropout(h, dropout, dropout_gen)

        h = torch.relu(dp(x) @ self.mul_fc(z_adj) + self.mul_bias)
        h = torch.relu(self.bn1(self.enc1(dp(h))))
        h = torch.relu(self.bn2(self.enc2(dp(h))))
        pi = torch.sigmoid(self.dec_pi(h))
        disp = torch.clamp(nn.functional.softplus(self.dec_disp(h)), 1e-4, 1e4)
        mean = torch.clamp(torch.exp(self.dec_mean(h)), 1e-5, 1e6)
        return mean * size_factors[:, None], mean, disp, pi


class _GraphSCINet(nn.Module):
    """The GNN and the autoencoder, one joint forward (counterpart:
    graphsci.py:125); ``n_cells`` is the GNN's input width."""

    def __init__(self, n_genes: int, n_cells: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.gnn = _GNNModel(n_cells, n_genes)
        self.ae = _AEModel(n_genes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's init: the GNN's glorot weights, ``Dense`` defaults, norms at 1, 0."""
        self.gnn.reset_parameters(generator)
        for layer in self.ae.modules():
            if isinstance(layer, nn.Linear):
                flax_dense_init_(layer, generator)
            elif isinstance(layer, _BatchNorm):
                nn.init.ones_(layer.scale)
                nn.init.zeros_(layer.bias)
        nn.init.zeros_(self.ae.mul_bias)

    def forward(self, adj, gene_feat: torch.Tensor, x: torch.Tensor, sf: torch.Tensor,
                noise: torch.Tensor, dropout_gen: Optional[torch.Generator] = None):
        """``(z_adj, z_adj_log_std, z_adj_mean, x_exp, mean, disp, pi)``;
        dropout only with a generator (training)."""
        p = self.dropout if dropout_gen is not None else 0.0
        z_adj, z_log_std, z_mean = self.gnn(adj, gene_feat, noise, p, dropout_gen)
        return (z_adj, z_log_std, z_mean) + self.ae(x, z_adj, sf, p, dropout_gen)


def graphsci_loss(batch_raw, adj_orig, z_adj, z_adj_log_std, z_adj_mean, mean, disp, pi,
                  size_factors, mask, le=1.0, la=1.0, ke=1.0, ka=1.0):
    """The objective, term for term (counterpart: graphsci.py:147): the
    soft-target cross-entropy of ``z_adj``'s rows against the 0/1 graph with
    per-gene ``pos_weight`` and the ``norm_adj`` scale (``loss_adj``), the
    masked ZINB NLL of the raw counts (``loss_exp``), ``kl = ka kl_adj - ke
    kl_exp`` with ``kl_exp`` the masked reconstruction MSE. Returns
    ``(loss_adj, loss_exp, log_lik, kl, log_lik - kl)``."""
    eps = 1e-10
    n = adj_orig.shape[0]
    pos_weight = (n ** 2 - adj_orig.sum(1)) / adj_orig.sum(1).clamp(min=eps)
    norm_adj = n * n / ((n * n - adj_orig.sum()) * 2).clamp(min=eps)
    logp = torch.log_softmax(z_adj, dim=-1)
    ce = -(pos_weight * adj_orig * logp).sum(-1)
    loss_adj = la * norm_adj * ce.mean()

    mean = mean * size_factors[:, None]
    disp = torch.clamp(disp, max=1e6)
    t1 = (torch.lgamma(disp + eps) + torch.lgamma(batch_raw + 1)
          - torch.lgamma(batch_raw + disp + eps))
    t2 = ((disp + batch_raw) * torch.log(1.0 + mean / (disp + eps))
          + batch_raw * (torch.log(disp + eps) - torch.log(mean + eps)))
    nb = t1 + t2
    zero_nb = torch.pow(disp / (disp + mean + eps), disp)
    zero_case = -torch.log(pi + (1 - pi) * zero_nb + eps)
    pointwise = torch.where(batch_raw < 1e-8, zero_case, nb)
    n_mask = mask.sum().clamp(min=1.0)
    loss_exp = le * (pointwise * mask).sum() / n_mask
    log_lik = loss_exp + loss_adj

    kl_adj = (0.5 / batch_raw.shape[0]) * torch.mean(torch.sum(
        1 + 2 * z_adj_log_std - torch.square(z_adj_mean)
        - torch.square(torch.exp(torch.clamp(z_adj_log_std, -10.0, 4.0))), 1))
    kl_exp = 0.5 / batch_raw.shape[1] * (((mean - batch_raw) ** 2) * mask).sum() / n_mask
    kl = ka * kl_adj - ke * kl_exp
    return loss_adj, loss_exp, log_lik, kl, log_lik - kl


class GraphSCI(BaseRegressionMethod):
    """GraphSCI (counterpart: graphsci.py:188). ``fit(g, x, x_raw, mask)``
    trains on the gene graph ``g`` (its ``ndata["feat"]`` the genes x cells
    features, else ``xᵀ``), the log features ``x``, the raw counts ``x_raw``
    and the train mask of the entries (the output of
    :func:`graphsci_preprocess`)."""

    _DISPLAY_ATTRS = ("n_epochs", "lr", "weight_decay")

    def __init__(self, num_cells: int, num_genes: int, dataset: str = "",
                 n_epochs: int = 100, lr: float = 1e-3, weight_decay: float = 1e-5,
                 dropout: float = 0.1, gpu: int = -1, seed: Optional[int] = 0,
                 device="auto"):
        # dataset and gpu keep the reference's signature; the device is ``device``
        self.num_cells = num_cells
        self.num_genes = num_genes
        self.n_epochs = n_epochs
        self.lr = lr
        self.weight_decay = weight_decay
        self.dropout = dropout
        self.seed = seed or 0
        self.device = resolve_device(device)
        self.net: Optional[_GraphSCINet] = None
        self.history: List[Dict[str, float]] = []  # per epoch: epoch, loss, seconds

    def _make_net(self, n_cells: int) -> _GraphSCINet:
        """A new network with flax's init drawn from ``seed``, on the device."""
        net = _GraphSCINet(self.num_genes, n_cells, self.dropout)
        net.reset_parameters(torch.Generator().manual_seed(self.seed))
        return net.to(self.device)

    def _noise(self, generator: torch.Generator) -> torch.Tensor:
        """The standard normals of one sample of ``z_adj`` (genes x genes)."""
        return torch.randn((self.num_genes, self.num_genes), generator=generator,
                           device=self.device)

    @staticmethod
    def preprocessing_pipeline(min_cells: float = 0.1, threshold: float = 0.3, mask: bool = True,
                               distr: str = "exp", mask_rate: float = 0.1,
                               seed: Optional[int] = None, log_level: str = "INFO") -> Compose:
        """Genes expressed in at least ``min_cells`` cells (a float in (0, 1)
        a ratio of the gene count, as JAX resolves it), cells with a count,
        the counts kept (``SaveRaw``), ``log1p``, the entry masks
        (``CellwiseMaskData``, unless ``mask`` is off) and the gene graph of
        the log features at ``threshold``, negative correlations kept, into
        ``uns["FeatureFeatureGraph"]`` (counterpart: graphsci.py:207-229)."""
        transforms = [
            FilterGenesScanpy(min_cells=min_cells),
            FilterCellsScanpy(min_counts=1),
            SaveRaw(),
            AnnDataTransform("sc.pp.log1p"),
        ]
        if mask:
            transforms.append(CellwiseMaskData(distr=distr, mask_rate=mask_rate, seed=seed))
        transforms.extend([
            FeatureFeatureGraph(threshold=threshold, positive_only=False),
            SetConfig({"feature_channel": ["FeatureFeatureGraph", None, "train_mask"]
                       if mask else ["FeatureFeatureGraph", None],
                       "feature_channel_type": ["uns", "X", "layers"] if mask
                       else ["uns", "X"],
                       "label_channel": [None, None],
                       "label_channel_type": ["X", "raw_X"]}),
        ])
        return Compose(*transforms, log_level=log_level)

    def fit(self, g: Graph, x, x_raw, mask=None, le=1.0, la=1.0, ke=1.0, ka=1.0):
        """Train ``n_epochs`` full-batch AdamW steps (counterpart:
        graphsci.py:262). The device inputs are cached on the graph's
        identity and the inputs' content, as in JAX."""
        x = np.asarray(x, np.float32)
        x_raw = np.asarray(x_raw, np.float32)
        loss_mask = np.asarray(mask, np.float32) if mask is not None else np.ones_like(x)
        dev = self.device
        h = hashlib.md5(np.ascontiguousarray(x))
        h.update(np.ascontiguousarray(x_raw))
        h.update(np.ascontiguousarray(loss_mask))
        cache_key = (id(g), g.adj.shape, g.adj.nnz, x.shape, str(dev), h.hexdigest())
        if getattr(self, "_fit_cache_key", None) != cache_key:
            self.fmt = ("dense" if choose_adj_format(g.adj, reorder=False, device=dev) == "dense"
                        else "csr")
            adj = (dense_adj_from_scipy if self.fmt == "dense" else csr_from_scipy)(g.adj)
            feat = g.ndata.get("feat")
            gene_feat = np.asarray(feat if feat is not None else x.T, np.float32)
            coo = sp.coo_matrix(g.adj)
            pos = coo.data > 0
            adj_target = torch.zeros(g.adj.shape, dtype=torch.float32, device=dev)
            adj_target[torch.from_numpy(coo.row[pos]).long().to(dev),
                       torch.from_numpy(coo.col[pos]).long().to(dev)] = 1.0
            counts = x_raw.sum(1)
            sf = (counts / np.median(counts)).astype(np.float32)
            tensors = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                       for a in (gene_feat, sf, x, x_raw, loss_mask)]
            self._fit_cache = (adj.to(dev), adj_target, *tensors)
            self._fit_cache_key = cache_key
        adj, adj_target, gene_feat, sf, xt, xrt, maskt = self._fit_cache
        self._cache = (adj, gene_feat, xt, sf)
        self._targets = (adj_target, xrt, maskt)
        logger.info("GraphSCI gene graph format: %s", self.fmt)

        if self.net is None:
            self.net = self._make_net(gene_feat.shape[1])
        net = self.net
        net.train()
        # optax adamw's decoupled decay, as torch's AdamW applies it
        opt = torch.optim.AdamW(net.parameters(), lr=self.lr, weight_decay=self.weight_decay)
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        clock, losses = EpochClock(dev), []
        for epoch in range(self.n_epochs):
            clock.tick()
            opt.zero_grad(set_to_none=True)
            loss = self._loss(self._noise(gen), gen, le, la, ke, ka)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
            if epoch % 50 == 0:
                logger.info("GraphSCI epoch %d, loss %.6f", epoch, float(losses[-1]))
        clock.tick()
        values = torch.stack(losses).cpu().tolist() if losses else []
        self.history = [{"epoch": e, "loss": l, "seconds": s}
                        for e, (l, s) in enumerate(zip(values, clock.seconds()))]
        net.eval()
        return self

    def _loss(self, noise: torch.Tensor, gen: Optional[torch.Generator], le=1.0, la=1.0,
              ke=1.0, ka=1.0) -> torch.Tensor:
        """The training loss of the current weights on the fitted inputs
        under ``noise`` (counterpart: ``_step``'s ``loss_fn``,
        graphsci.py:234-241); dropout from ``gen``."""
        (adj, gene_feat, xt, sf), (adj_target, xrt, maskt) = self._cache, self._targets
        z_adj, z_log_std, z_mean, _, mean, disp, pi = self.net(adj, gene_feat, xt, sf, noise,
                                                               gen)
        return graphsci_loss(xrt, adj_target, z_adj, z_log_std, z_mean, mean, disp, pi, sf,
                             maskt, le, la, ke, ka)[-1]

    def predict(self, x=None, mask=None, log_space: bool = True) -> np.ndarray:
        """The imputed expression ``mean x size factor`` (through ``log1p``
        with ``log_space``, the scale of the log features); with ``mask``,
        the fitted features where ``mask`` is set and the imputation
        elsewhere (counterpart: graphsci.py:323)."""
        adj, gene_feat, xt, sf = self._cache
        noise = self._noise(torch.Generator(device=self.device).manual_seed(0))
        with torch.no_grad():
            x_exp = self.net(adj, gene_feat, xt, sf, noise)[3]
        imputed = x_exp.cpu().numpy()
        if log_space:
            imputed = np.log1p(imputed)
        if mask is not None:
            m = np.asarray(mask).astype(bool)
            out = xt.cpu().numpy().copy()
            out[~m] = imputed[~m]
            return out
        return imputed


# --------------------------------------------------------------------------
# preprocessing on arrays (counterpart: graphsci.py:207-229)
# --------------------------------------------------------------------------

class GraphSCIInputs(NamedTuple):
    """What :func:`graphsci_preprocess` returns: ``graph`` the gene graph
    (its ``ndata["feat"]`` = ``xᵀ``), ``x`` the log features, ``x_raw`` the
    counts (``SaveRaw``), the entry masks, ``cells`` and ``genes`` the
    indices kept."""

    graph: Graph
    x: np.ndarray
    x_raw: np.ndarray
    train_mask: np.ndarray
    valid_mask: np.ndarray
    test_mask: np.ndarray
    cells: np.ndarray
    genes: np.ndarray


def graphsci_preprocess(counts, seed: Optional[int] = None, *, min_cells: float = 0.1,
                        threshold: float = 0.3, mask: bool = True, distr: str = "exp",
                        mask_rate: float = 0.1) -> GraphSCIInputs:
    """:meth:`GraphSCI.preprocessing_pipeline` on raw ``counts`` (cells x
    genes, numpy or scipy, taken as float32) wrapped in a ``Data``, for a
    caller that holds a matrix. Without ``mask`` the train mask is all ones
    and the others empty."""
    data = wrap_matrix(counts)
    GraphSCI.preprocessing_pipeline(min_cells=min_cells, threshold=threshold, mask=mask,
                                    distr=distr, mask_rate=mask_rate, seed=seed,
                                    log_level="WARNING")(data)
    return GraphSCIInputs(data.data.uns["FeatureFeatureGraph"], *imputation_arrays(data))


__all__ = ["GraphSCI", "GraphSCIInputs", "graphsci_loss", "graphsci_preprocess"]
