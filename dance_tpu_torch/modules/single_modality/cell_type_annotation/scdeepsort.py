"""scDeepSort: cell-type annotation on the weighted cell-gene bipartite graph.

Counterpart: dance_tpu/modules/single_modality/cell_type_annotation/scdeepsort.py
(``GNN`` :30-49, ``ScDeepSort`` :52-331). Full-graph training: the whole graph
lives on the device and every epoch is one forward/backward and one Adam step.
With ``use_bsr=True`` each AdaptiveSAGE layer is one block-sparse SpMM, run by
the hand-written CUDA kernel on the card (forward, and on the transposed tiles
for the backward); ``bsr_dtype=torch.bfloat16`` streams it in bf16 with
float32 sums. ``use_bsr="auto"`` (the default, as in JAX) takes the
format :func:`~dance_tpu_torch.ops.bsr.resolve_adj_format` picks for the
graph in its natural order: BSR, a dense off-diagonal (one cuBLAS product)
or CSR; CSR off the card.

Where this differs from the JAX package:

- With ``val_ratio=0`` the JAX ``fit`` returns the untrained initial weights
  (``best_params`` is only replaced under ``if num_val:``, scdeepsort.py:178-195).
  Here ``fit`` keeps the last weights when there is no validation split.
- ``fit_with_sampling``/``predict_sampled`` and the
  Data-container ``preprocessing_pipeline`` are not ported yet (ROADMAP).
- Weights are drawn from a ``torch.Generator`` seeded with ``seed``, not from
  ``jax.random``: the same seed gives other initial weights. Parity tests
  copy the flax weights in (:func:`dance_tpu_torch.utils.params.flax_to_torch`).

Under ``fit_distributed`` with ``dp > 1`` (CSR, as it defaults there) each
rank keeps its block rows of the adjacency as a
:class:`~dance_tpu_torch.parallel.sharded_graph.ShardedCSR` with the alpha
index, and its rows of the node features; the masked loss is this rank's
train cells over the global train count, the gradients are summed over
``dp``, and the validation reads the gathered logits, so every rank keeps
the same best weights and ``predict`` gives the same result on each. A
dropout above 0 draws each rank's masks from its own default generator.
"""

import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from dance_tpu_torch.graph import Graph
from dance_tpu_torch.modules.base import BaseClassificationMethod
from dance_tpu_torch.nn.gnn import AdaptiveSAGE
from dance_tpu_torch.ops.bsr import compute_dtype_of, resolve_adj_format
from dance_tpu_torch.ops.sparse import csr_from_scipy
from dance_tpu_torch.parallel.mesh import RowShard, active_dp_mesh, sync_grads
from dance_tpu_torch.parallel.sharded_graph import shard_csr
from dance_tpu_torch.settings import logger
from dance_tpu_torch.utils import resolve_device


class GNN(nn.Module):
    """AdaptiveSAGE stack with a shared ``alpha`` and a linear head
    (counterpart: scdeepsort.py:30-49). flax infers the input width; torch
    takes it as ``dim_in``."""

    def __init__(self, dim_in: int, dim_out: int, dim_hid: int, n_layers: int,
                 gene_num: int, dropout: float = 0.0,
                 bsr_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(gene_num + 2))
        self.layers = nn.ModuleList(
            AdaptiveSAGE(dim_in if i == 0 else dim_hid, dim_hid, dropout=dropout,
                         bsr_dtype=bsr_dtype)
            for i in range(n_layers))
        self.head = nn.Linear(dim_hid, dim_out)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's init: unit alpha, xavier-uniform kernels, zero biases."""
        nn.init.ones_(self.alpha)
        for layer in self.layers:
            layer.reset_parameters(generator)
        nn.init.xavier_uniform_(self.head.weight, generator=generator)
        nn.init.zeros_(self.head.bias)

    def forward(self, adj, x, gene_id, alpha_idx=None):
        for layer in self.layers:
            x = layer(adj, x, gene_id, self.alpha, alpha_idx=alpha_idx)
        return self.head(x)


class ScDeepSort(BaseClassificationMethod):
    """scDeepSort (counterpart: scdeepsort.py:52)."""

    _DISPLAY_ATTRS = ("dense_dim", "hidden_dim", "n_layers", "species", "tissue")

    def __init__(self, dim_in: int, dim_hid: int, num_layers: int, species: str = "",
                 tissue: str = "", *, dropout: float = 0, device="auto", seed: int = 0):
        self.dense_dim = dim_in
        self.hidden_dim = dim_hid
        self.n_layers = num_layers
        self.dropout = dropout
        self.species = species
        self.tissue = tissue
        self.seed = seed
        self.device = resolve_device(device)
        self.model: Optional[GNN] = None
        self.history: List[Dict[str, float]] = []  # per epoch: loss, val_acc, seconds

    def _device_graph(self, graph: Graph, fmt: str, bsr_block: int):
        """Adjacency (``fmt``: ``"bsr"``, ``"dense"`` or ``"csr"``), features,
        gene ids and alpha index on the device, cached across fits and
        predictions on the same graph (counterpart: scdeepsort.py:117-129)."""
        key = (id(graph), graph.adj.shape, graph.adj.nnz, fmt, bsr_block)
        if getattr(self, "_dev_cache_key", None) == key:
            return self._dev_cache
        feats = torch.from_numpy(np.asarray(graph.ndata["features"], np.float32)).to(self.device)
        gene_id = torch.from_numpy(np.asarray(graph.ndata["cell_id"], np.int64)).to(self.device)
        if fmt in ("bsr", "dense"):
            adj = graph.to_adaptive_bsr(block=bsr_block, dense=fmt == "dense", device=self.device)
            alpha_idx = None
        else:
            adj = csr_from_scipy(graph.adj).to(self.device)
            alpha_idx = AdaptiveSAGE.edge_alpha_index(adj.row_ids(), adj.indices, gene_id,
                                                      int(graph.info["num_genes"]))
        self._dev_cache_key, self._dev_cache = key, (adj, feats, gene_id, alpha_idx)
        return self._dev_cache

    def _sharded_graph(self, graph: Graph, mesh):
        """This rank's block rows of the adjacency as a :class:`ShardedCSR`
        carrying the alpha index, and its rows of the features and gene ids
        (not cached: a data-parallel fit builds them once)."""
        n_genes = int(graph.info["num_genes"])
        gene_id = np.asarray(graph.ndata["cell_id"], np.int64)
        full = csr_from_scipy(graph.adj)
        alpha_idx = AdaptiveSAGE.edge_alpha_index(full.row_ids(), full.indices,
                                                  torch.from_numpy(gene_id), n_genes)
        adj = shard_csr(graph.adj, mesh, edge_data={"alpha_idx": alpha_idx.numpy()},
                        device=self.device)
        shard = RowShard(graph.num_nodes, mesh)
        feats = shard.rows(np.asarray(graph.ndata["features"], np.float32), device=self.device)
        return adj, feats, shard.rows(gene_id, device=self.device), shard

    def fit(self, graph: Graph, labels, epochs: int = 300, lr: float = 1e-3,
            weight_decay: float = 0, val_ratio: float = 0.2, use_bsr="auto",
            bsr_block: int = 128, bsr_dtype=None):
        """Full-graph training with best-val weight selection (counterpart:
        scdeepsort.py:99-196). ``use_bsr=True`` runs AdaptiveSAGE through the
        block-sparse SpMM, ``False`` through the CSR edge gather, ``"auto"``
        as :func:`resolve_adj_format` picks (natural order).
        ``bsr_dtype=torch.bfloat16`` streams that SpMM in bf16 with float32
        sums; it is kept only where the adjacency is BSR or dense, as JAX's
        ``bsr_dtype if use_bsr else None`` (scdeepsort.py:148-150), and stays
        on the model, so ``predict`` streams as well.
        ``epochs=0`` builds the model and optimizer and returns."""
        fmt = resolve_adj_format(use_bsr, graph.adj, bsr_block, device=self.device,
                                 reorder=False)
        bsr_dtype = compute_dtype_of("ScDeepSort.fit", bsr_dtype) if fmt != "csr" else None
        labels = np.asarray(labels)
        if labels.ndim == 2:
            labels = labels.argmax(1)
        mesh = active_dp_mesh()
        shard = None
        if fmt == "csr" and mesh is not None and mesh.size("dp") > 1:
            # a data-parallel fit: this rank's block rows of the adjacency, the
            # alpha index riding along (scdeepsort.py:159-170)
            adj, feats, gene_id, shard = self._sharded_graph(graph, mesh)
            alpha_idx = None
        else:
            adj, feats, gene_id, alpha_idx = self._device_graph(graph, fmt, bsr_block)
        num_genes = int(graph.info["num_genes"])
        num_cells = int(graph.info["num_cells"])
        self.num_labels = int(labels.max()) + 1
        self._fmt, self._bsr_block = fmt, bsr_block

        rng = np.random.default_rng(self.seed)
        perm = rng.permutation(num_cells) + num_genes
        num_val = int(num_cells * val_ratio)
        val_idx, train_idx = perm[:num_val], perm[num_val:]
        full_labels = -np.ones(num_genes + num_cells, dtype=np.int64)
        full_labels[num_genes:] = labels[:num_cells]
        train_mask = np.isin(np.arange(len(full_labels)), train_idx).astype(np.float32)

        self.model = GNN(feats.shape[1], self.num_labels, self.hidden_dim, self.n_layers,
                         num_genes, dropout=self.dropout, bsr_dtype=bsr_dtype)
        self.model.reset_parameters(torch.Generator().manual_seed(self.seed))
        self.model.to(self.device)
        params = self.model.parameters()
        self._opt = (torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay)
                     if weight_decay else torch.optim.Adam(params, lr=lr))
        if shard is None:
            labels_dev = torch.from_numpy(full_labels).to(self.device)
            mask_dev = torch.from_numpy(train_mask).to(self.device)
            denom = None
        else:  # the loss over this rank's rows, divided by the global count
            labels_dev = shard.rows(full_labels, device=self.device, fill=-1)
            mask_dev = shard.rows(train_mask, device=self.device, fill=0.0)
            denom = max(float(train_mask.sum()), 1.0)
        self._train_state = (adj, feats, gene_id, labels_dev, mask_dev, alpha_idx, denom,
                             None if shard is None else mesh)

        best_val, best_state = -1.0, None
        self.history = []
        for epoch in range(epochs):
            t0 = time.perf_counter()
            record = {"epoch": epoch, "loss": float(self.train_step())}
            if num_val:
                logits = self._logits(adj, feats, gene_id, alpha_idx)
                if shard is not None:
                    logits = shard.gather(logits)
                pred = logits.argmax(1).cpu().numpy()
                val_acc = float((pred[val_idx] == full_labels[val_idx]).mean())
                record["val_acc"] = val_acc
                if val_acc >= best_val:
                    best_val = val_acc
                    best_state = {k: v.detach().clone()
                                  for k, v in self.model.state_dict().items()}
                if epoch % 50 == 0:
                    logger.info("Epoch %04d: loss %.4f, val acc %.4f", epoch,
                                record["loss"], val_acc)
            record["seconds"] = time.perf_counter() - t0
            self.history.append(record)
        if best_state is not None:
            self.model.load_state_dict(best_state)
        return self

    def train_step(self) -> torch.Tensor:
        """One full-graph forward/backward and optimizer step on the state
        ``fit`` set up (counterpart: ``_train_step``, scdeepsort.py:79-92);
        returns the masked cross-entropy before the step."""
        adj, feats, gene_id, labels, mask, alpha_idx, denom, mesh = self._train_state
        self.model.train()
        self._opt.zero_grad(set_to_none=True)
        logits = self.model(adj, feats, gene_id, alpha_idx)
        losses = nn.functional.cross_entropy(logits, labels.clamp(min=0), reduction="none")
        if denom is None:
            loss = (losses * mask).sum() / mask.sum().clamp(min=1.0)
            loss.backward()
        else:  # this rank's share; the global loss comes back with the gradients
            loss = (losses * mask).sum() / denom
            loss.backward()
            loss = sync_grads(list(self.model.parameters()), mesh, extra=loss.detach())
        self._opt.step()
        return loss.detach()

    @torch.no_grad()
    def _logits(self, adj, feats, gene_id, alpha_idx=None) -> torch.Tensor:
        self.model.eval()
        return self.model(adj, feats, gene_id, alpha_idx)

    def save_model(self, path: Optional[str] = None) -> str:
        """Save the weights (counterpart: scdeepsort.py:289)."""
        path = path or f"scdeepsort_{self.species}_{self.tissue}.pt"
        torch.save({"state_dict": self.model.state_dict(), "num_labels": self.num_labels}, path)
        return path

    def load_model(self, path: str):
        """Load weights saved by :meth:`save_model` into the model built by
        ``fit`` (counterpart: scdeepsort.py:296)."""
        if self.model is None:
            raise ValueError("Initialize the model (via fit on a graph) before "
                             "loading parameters")
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(state["state_dict"])
        self.num_labels = int(state["num_labels"])
        return self

    def predict_proba(self, graph: Graph) -> np.ndarray:
        """Softmax over the cell nodes' logits (counterpart: scdeepsort.py:306)."""
        adj, feats, gene_id, alpha_idx = self._device_graph(graph, self._fmt, self._bsr_block)
        logits = self._logits(adj, feats, gene_id, alpha_idx)
        cell_logits = logits[int(graph.info["num_genes"]):]
        return torch.softmax(cell_logits, dim=-1).cpu().numpy()

    def predict(self, graph: Graph, unsure_rate: float = 2.0) -> np.ndarray:
        """Cell types; a top score below ``unsure_rate / num_labels`` gives -1
        (counterpart: scdeepsort.py:323)."""
        probs = self.predict_proba(graph)
        pred = probs.argmax(1)
        pred[probs.max(1) < unsure_rate / self.num_labels] = -1
        return pred


__all__ = ["GNN", "ScDeepSort"]
