"""DSTG: a semi-supervised two-layer GCN on the pseudo/real spot link graph.

Counterpart: dance_tpu/modules/spatial/cell_type_deconvo/dstg.py (``_GCN``
:30-41, ``DSTG`` :44-142, ``preprocessing_pipeline`` :58-72,
``split_mask_for_validation`` :145, ``masked_softmax_cross_entropy`` :163).
Pseudo-spots mixed from labelled reference cells carry their cell-type
portions; real spots are linked to them in a CCA embedding, and the GCN's
softmax over the linked graph predicts the real spots' portions. Full-graph
training: every epoch is one forward and backward of the whole graph and one
Adam (AdamW with ``weight_decay``) step on the masked cross-entropy. With
``use_bsr=True`` the graph is RCM-banded and tiled, and both aggregations
are the block-sparse SpMM (the CUDA kernel #1 on the card, forward and
``Aᵀḡ``); predictions are put back in the caller's order. ``use_bsr="auto"``
(the default, as in JAX) decides BSR or CSR by
:func:`~dance_tpu_torch.ops.bsr.resolve_use_bsr` on the graph; CSR off the
card.

Where this differs from the JAX package:

- The weights are drawn at each ``fit`` (as in JAX, whose output width is
  the labels') from a CPU ``torch.Generator`` seeded with ``seed``, and the
  dropout masks from a generator on the device; parity tests copy the flax
  weights in (:func:`dance_tpu_torch.utils.params.dstg_flax_to_torch`) by
  patching :meth:`DSTG._make_net`.
- ``history`` records each epoch's loss and seconds (read back once, after
  the last epoch; the loss is logged every 100 epochs, as in JAX).
- ``preprocessing_pipeline`` is JAX's step list with one difference, and
  :func:`dstg_preprocess` is its array front. JAX's pipeline does not run on
  a container of reference cells and spots: it takes the cell-type profile
  of the pseudo split, whose spots carry no type, finds no marker gene and
  fails at the PCA. The port's takes the profile of the reference cells
  (``CellTopicProfile.split_name`` is ``"ref"``) and then drops them
  (``RemoveSplit("ref")``), so that the PCA and the graph see the pseudo and
  real spots only. Its ``PseudoMixture`` also keeps the pseudo-spots'
  portions, which JAX's ``Data.append`` drops, and ``DSTGraph`` writes the
  graph in the container's cell order.
"""

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from dance_tpu_torch.data import AnnData, Data, Frame
from dance_tpu_torch.modules.base import BaseRegressionMethod
from dance_tpu_torch.nn.gnn import flax_dense_init_, flax_dropout
from dance_tpu_torch.ops.bsr import bsr_with_rcm, resolve_use_bsr, unpermute
from dance_tpu_torch.ops.segment import spmm
from dance_tpu_torch.ops.sparse import csr_from_scipy
from dance_tpu_torch.settings import logger
from dance_tpu_torch.transforms.cell_feature import CellPCA
from dance_tpu_torch.transforms.filter import FilterGenesMarker
from dance_tpu_torch.transforms.graph.dstg_graph import DSTGraph
from dance_tpu_torch.transforms.misc import Compose, RemoveSplit, SetConfig
from dance_tpu_torch.transforms.pseudobulk import CellTopicProfile, PseudoMixture
from dance_tpu_torch.utils import EpochClock, resolve_device


class _GCN(nn.Module):
    """dropout → Dense (no bias) → aggregate → relu → dropout → Dense (no
    bias) → aggregate → softmax (counterpart: dstg.py:30). ``dense_0`` and
    ``dense_1`` are flax's ``Dense_0`` and ``Dense_1``."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.dense_0 = nn.Linear(in_dim, hidden, bias=False)
        self.dense_1 = nn.Linear(hidden, out_dim, bias=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax ``Dense``'s lecun-normal kernels."""
        for layer in (self.dense_0, self.dense_1):
            flax_dense_init_(layer, generator)

    def forward(self, adj, x: torch.Tensor,
                dropout_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        h = flax_dropout(x, self.dropout, dropout_gen)
        h = torch.relu(spmm(adj, self.dense_0(h)))
        h = flax_dropout(h, self.dropout, dropout_gen)
        h = spmm(adj, self.dense_1(h))
        return torch.softmax(h, dim=-1)


class DSTG(BaseRegressionMethod):
    """DSTG (counterpart: dstg.py:44). ``fit((x, adj), y)`` trains on the
    features of every spot and the link graph; ``y`` holds the pseudo-spots'
    portions, and rows of zeros for the spots to predict."""

    _DISPLAY_ATTRS = ("nhid", "bias", "dropout")

    def __init__(self, nhid: int = 32, bias: bool = False, dropout: float = 0.0,
                 device="auto", seed: int = 0):
        self.nhid = nhid
        self.bias = bias  # kept for the reference's signature; the GCN has no bias, as in JAX
        self.dropout = dropout
        self.seed = seed
        self.device = resolve_device(device)
        self.net: Optional[_GCN] = None
        self.history: List[Dict[str, float]] = []  # per epoch: epoch, loss, seconds

    def _make_net(self, in_dim: int, out_dim: int) -> _GCN:
        """A new GCN with flax's init drawn from ``seed``, on the device."""
        net = _GCN(in_dim, self.nhid, out_dim, dropout=self.dropout)
        net.reset_parameters(torch.Generator().manual_seed(self.seed))
        return net.to(self.device)

    @staticmethod
    def preprocessing_pipeline(n_pseudo: int = 500, k_filter: int = 200, num_cc: int = 30,
                               log_level: str = "INFO", random_state: int = 0,
                               device="auto") -> Compose:
        """DSTG's preprocessing of a container of labelled reference cells
        (split ``"ref"``, types in ``obs["cellType"]``) and spots (split
        ``"test"``; :func:`deconvo_container`): ``n_pseudo`` pseudo-spots
        (split ``"pseudo"``, their portions in ``obsm["cell_type_portion"]``),
        the median profile of each type over the reference cells, its marker
        genes (log-FC 1.25), the reference cells dropped, then the
        ``min(num_cc, 50)``-d PCA of the spots and their link graph into
        ``obsp["DSTGraph"]`` (counterpart: dstg.py:58-72; JAX's ``n_top_genes``
        is unused there and has no port). The one difference from JAX's step list: the
        profile is of the reference cells, which are then dropped (see the
        module's notes). The PCA, the CCA and the kNN run on ``device``."""
        device = resolve_device(device)
        return Compose(
            PseudoMixture(n_pseudo=n_pseudo, random_state=random_state),
            CellTopicProfile(ct_select="auto", split_name="ref"),
            FilterGenesMarker(threshold=1.25),
            RemoveSplit(split_name="ref"),
            CellPCA(n_components=min(num_cc, 50), device=device),
            DSTGraph(k_filter=k_filter, num_cc=num_cc, device=device),
            SetConfig({"feature_channel": ["CellPCA", "DSTGraph"],
                       "feature_channel_type": ["obsm", "obsp"],
                       "label_channel": "cell_type_portion"}),
            log_level=log_level,
        )

    def fit(self, inputs, y, lr: float = 0.005, max_epochs: int = 300,
            weight_decay: float = 0.0, train_mask=None, use_bsr="auto", bsr_block: int = 128):
        """Train from new weights (counterpart: dstg.py:91). ``inputs`` is
        ``(x, adj)``: features of every spot and the scipy graph; the loss is
        the cross-entropy over ``train_mask`` (default: the rows of ``y``
        with a positive sum)."""
        x, adj = inputs
        adj = sp.csr_matrix(adj)
        use_bsr = resolve_use_bsr(use_bsr, adj, bsr_block, device=self.device)
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float32)
        train_mask = np.asarray(y.sum(1) > 0 if train_mask is None else train_mask)
        self._perm = None
        if use_bsr:
            self._perm, tiles = bsr_with_rcm(adj, block=bsr_block)
            self.adj = tiles.to(self.device)
            x, y, train_mask = x[self._perm], y[self._perm], train_mask[self._perm]
        else:
            self.adj = csr_from_scipy(adj).to(self.device)
        dev = self.device
        self.x = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        yt = torch.from_numpy(np.ascontiguousarray(y)).to(dev)
        mask = torch.from_numpy(train_mask.astype(np.float32)).to(dev)
        self.net = self._make_net(x.shape[1], y.shape[1])
        params = list(self.net.parameters())
        opt = (torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay) if weight_decay
               else torch.optim.Adam(params, lr=lr))
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        self.net.train()
        clock, losses = EpochClock(dev), []
        for epoch in range(max_epochs):
            clock.tick()
            opt.zero_grad(set_to_none=True)
            pred = self.net(self.adj, self.x, gen)
            ce = -(yt * torch.log(pred + 1e-10)).sum(1)
            loss = (ce * mask).sum() / mask.sum().clamp(min=1.0)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
            if epoch % 100 == 0:
                logger.info("DSTG epoch %d, CE %.5f", epoch, float(loss.detach()))
        clock.tick()
        values = torch.stack(losses).cpu().tolist() if losses else []
        self.history = [{"epoch": e, "loss": l, "seconds": s}
                        for e, (l, s) in enumerate(zip(values, clock.seconds()))]
        self.net.eval()
        return self

    def predict(self, x=None) -> np.ndarray:
        """The portions of every spot, in the caller's order (counterpart:
        dstg.py:128)."""
        with torch.no_grad():
            pred = self.net(self.adj, self.x).cpu().numpy()
        return unpermute(self._perm, pred)



def split_mask_for_validation(pseudo_train_mask, valid_ratio: float = 0.3,
                              random_seed=None):
    """Split a boolean mask's True entries into train and validation masks
    (counterpart: dstg.py:145): ``valid_ratio`` of them, drawn by
    ``np.random.default_rng(random_seed)``, move to the validation mask."""
    mask = np.asarray(pseudo_train_mask, dtype=bool)
    if not 0.0 <= valid_ratio <= 1.0:
        raise ValueError(f"valid_ratio must be in [0, 1], got {valid_ratio}")
    idx = np.flatnonzero(mask)
    rng = np.random.default_rng(random_seed)
    n_valid = int(round(len(idx) * valid_ratio))
    valid_mask = np.zeros_like(mask)
    valid_mask[rng.choice(idx, size=n_valid, replace=False)] = True
    return mask & ~valid_mask, valid_mask


def masked_softmax_cross_entropy(preds, labels, mask) -> torch.Tensor:
    """Softmax cross-entropy of logits ``preds`` against ``labels``, weighted by
    ``mask`` over its mean and averaged over every row (counterpart:
    dstg.py:163)."""
    preds = torch.as_tensor(preds)
    labels = torch.as_tensor(labels, dtype=preds.dtype)
    mask = torch.as_tensor(mask, dtype=preds.dtype)
    loss = -(labels * torch.log_softmax(preds, dim=-1)).sum(-1)
    mask = mask / mask.mean().clamp(min=1e-12)
    return torch.mean(loss * mask)


class DSTGInputs(NamedTuple):
    """What :func:`dstg_preprocess` gives :meth:`DSTG.fit`, spots ordered
    [pseudo; real]: ``x`` the PCA features, ``adj`` the link graph, ``y`` the
    pseudo-spots' portions over zeros for the real spots; ``cell_types``
    names ``y``'s columns, ``genes`` is the mask of the marker genes kept and
    ``seconds`` the wall time of each step (``mix``, ``markers``, ``pca``,
    ``graph``)."""

    x: np.ndarray
    adj: sp.csr_matrix
    y: np.ndarray
    cell_types: List[str]
    genes: np.ndarray
    seconds: Dict[str, float]


def deconvo_container(x_ref, ref_labels, x_spots=None, coords=None, gene_names=None) -> Data:
    """A container of reference cells and spots, as the deconvolution
    pipelines take it: the cells of ``x_ref`` (cells x genes, genes named
    ``gene_names``, or ``g0``, ``g1``, ... when None) as split ``"ref"``
    with their types in ``obs["cellType"]``, then the spots of ``x_spots``
    (none when None) as split ``"test"``, both as float32; with ``coords``,
    the spots' coordinates in ``obsm["spatial"]`` (zeros for the reference
    cells)."""
    def dense(x):
        return np.asarray(x.toarray() if sp.issparse(x) else x, np.float32)

    names = (gene_names if gene_names is not None else
             [f"g{i}" for i in range(x_ref.shape[1])])
    genes = Frame(index=[str(g) for g in names])
    ref = AnnData(dense(x_ref), obs=Frame({"cellType": np.asarray(ref_labels).astype(str)},
                                          index=[f"c{i}" for i in range(x_ref.shape[0])]),
                  var=genes)
    data = Data(ref, full_split_name="ref")
    if x_spots is None:
        return data
    spots = AnnData(dense(x_spots), obs=Frame(index=[f"s{i}" for i in range(x_spots.shape[0])]),
                    var=genes.copy())
    data.append(Data(spots), mode="new_split", new_split_name="test", join="outer")
    if coords is not None:
        data.data.obsm["spatial"] = np.concatenate([np.zeros((x_ref.shape[0], 2), np.float32),
                                                    np.asarray(coords, np.float32)])
    return data


def spot_order(data) -> np.ndarray:
    """The container rows of the pseudo-spots, then of the real spots: the
    order the deconvolution models take."""
    return np.concatenate([data.get_split_idx("pseudo", error_on_miss=True),
                           data.get_split_idx("test", error_on_miss=True)])


def dstg_preprocess(x_ref, ref_labels, x_spots, *, n_pseudo: int = 500, k_filter: int = 200,
                    num_cc: int = 30, random_state: int = 0, device="auto") -> DSTGInputs:
    """:meth:`DSTG.preprocessing_pipeline` on the reference cells ``x_ref``
    (cells x genes, labelled ``ref_labels``) and the spots ``x_spots``
    wrapped in a :func:`deconvo_container`, for a caller that holds
    matrices: ``n_pseudo`` pseudo-spots mixed from the reference cells, the
    marker genes of the reference cells' median profiles, then on those
    genes of the pseudo and real spots the ``min(num_cc, 50)``-d PCA and the
    link graph. The PCA, the CCA and the kNN run on ``device``. Returns the
    container's inputs in :func:`spot_order`."""
    data = deconvo_container(x_ref, ref_labels, x_spots)
    genes = np.asarray(data.data.var_names)
    pipe = DSTG.preprocessing_pipeline(n_pseudo=n_pseudo, k_filter=k_filter, num_cc=num_cc,
                                       log_level="WARNING", random_state=random_state,
                                       device=device)
    pipe(data)
    t = pipe.timings
    seconds = {"mix": t["PseudoMixture"],
               "markers": t["CellTopicProfile"] + t["FilterGenesMarker"] + t["RemoveSplit"],
               "pca": t["CellPCA"], "graph": t["DSTGraph"]}
    logger.info("DSTG preprocessing: %d pseudo + %d real spots, %d marker genes of %d",
                n_pseudo, x_spots.shape[0], data.shape[1], genes.size)
    order = spot_order(data)
    (x, adj), y = data.get_x(return_type="default"), data.get_y(return_type="default")
    return DSTGInputs(np.asarray(x)[order], sp.csr_matrix(adj)[order][:, order],
                      y.to_numpy()[order].astype(np.float32), list(y.columns),
                      np.isin(genes, data.data.var_names), seconds)


__all__ = ["DSTG", "DSTGInputs", "deconvo_container", "dstg_preprocess",
           "masked_softmax_cross_entropy", "split_mask_for_validation", "spot_order"]
