"""scDCC: scDeepCluster with pairwise must-link / cannot-link constraints.

Counterpart: dance_tpu/modules/single_modality/clustering/scdcc.py
(``preprocessing_pipeline`` :41-54, the constraint loss :56-63, the
constraint step :70-78, ``fit`` :80-137, the DEC epoch :148-157). The
backbone and both stages are :class:`ScDeepCluster`'s, with a wider noise
(``sigma`` 2.5) and a shorter pretrain (50 epochs). After every DEC
training epoch one full-batch step of Adam (lr 1e-3, its own state, on the
autoencoder and ``mu``) lowers ``ml_weight`` x the mean of ``-log Σ_k q_ik
q_jk`` over the must-link pairs plus ``cl_weight`` x the mean of ``-log(1 -
Σ_k q_ik q_jk)`` over the cannot-link pairs, ``q`` the clean latent's
assignments; it is skipped when no pair is given. The differences from the
JAX package are scDeepCluster's; :func:`scdcc_preprocess` is the array front
of ``preprocessing_pipeline``: it runs the pipeline on a matrix wrapped in a
``Data``.
"""

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dance_tpu_torch.modules.single_modality.clustering.scdeepcluster import (
    ClusteringInputs, ScDeepCluster, zinb_counts_front, zinb_pipeline)
from dance_tpu_torch.transforms.misc import Compose
from dance_tpu_torch.utils.loss import soft_assign


class ScDCC(ScDeepCluster):
    """scDCC (counterpart: scdcc.py:26). ``fit`` takes scDeepCluster's inputs
    and the constraint pairs as index arrays into the cells."""

    def __init__(self, input_dim: int, z_dim: int, n_clusters: int, encodeLayer=(256, 64),
                 decodeLayer=(64, 256), activation: str = "relu", sigma: float = 2.5,
                 alpha: float = 1.0, gamma: float = 1.0, ml_weight: float = 1.0,
                 cl_weight: float = 1.0, device="auto", pretrain_path: Optional[str] = None,
                 seed: int = 0):
        super().__init__(input_dim, z_dim, encodeLayer, decodeLayer, activation, sigma, alpha,
                         gamma, device, pretrain_path, seed)
        self.n_clusters = n_clusters
        self.ml_weight = ml_weight
        self.cl_weight = cl_weight
        self.constraint_step = None  # the last fit's constraint step, when it had pairs

    @staticmethod
    def preprocessing_pipeline(n_top_genes: int = 2000, log_level: str = "INFO") -> Compose:
        """:func:`~dance_tpu_torch.modules.single_modality.clustering.scdeepcluster.zinb_pipeline`
        with the ``n_top_genes`` genes of largest variance, cut after the
        cells' totals are taken (counterpart: scdcc.py:41-54)."""
        return zinb_pipeline(n_top_genes, log_level=log_level)

    def constraint_loss(self, x: torch.Tensor, ml1, ml2, cl1, cl2) -> torch.Tensor:
        """The pairwise loss on the clean assignments of every cell
        (counterpart: scdcc.py:56); an empty side adds 0."""
        q = soft_assign(self.model.encode(x), self.mu, self.alpha)
        loss = torch.zeros((), device=x.device)
        if len(ml1):
            loss = loss + self.ml_weight * -torch.log(
                torch.sum(q[ml1] * q[ml2], dim=1) + 1e-10).mean()
        if len(cl1):
            loss = loss + self.cl_weight * -torch.log(
                1.0 - torch.sum(q[cl1] * q[cl2], dim=1) + 1e-10).mean()
        return loss

    def fit(self, inputs: Tuple, y=None, n_clusters: Optional[int] = None, ml_ind1=None,
            ml_ind2=None, cl_ind1=None, cl_ind2=None, lr: float = 1.0, batch_size: int = 256,
            epochs: int = 10, update_interval: int = 1, tol: float = 1e-3,
            pt_batch_size: int = 256, pt_lr: float = 0.001, pt_epochs: int = 50):
        """Pretrain, k-means centres (20 restarts), then the DEC stage with a
        constraint step after each training epoch (counterpart: scdcc.py:80)."""
        x, x_raw, n_counts = inputs
        self._pretrain(x, x_raw, n_counts, batch_size=pt_batch_size, lr=pt_lr,
                       epochs=pt_epochs, force_pretrain=True)
        x, xr, sf = self._tensors(x, x_raw, n_counts)
        self._init_centres(x, n_clusters or self.n_clusters)
        pairs = [torch.as_tensor(np.asarray([] if p is None else p, np.int64)).to(self.device)
                 for p in (ml_ind1, ml_ind2, cl_ind1, cl_ind2)]
        step = None
        if len(pairs[0]) or len(pairs[2]):
            c_opt = torch.optim.Adam([*self.model.parameters(), self.mu], lr=1e-3)

            def step():
                c_opt.zero_grad(set_to_none=True)
                self.constraint_loss(x, *pairs).backward()
                c_opt.step()

        self.constraint_step = step
        self._dec_stage(x, xr, sf, y, lr=lr, batch_size=min(batch_size, x.shape[0]),
                        epochs=epochs, update_interval=update_interval, tol=tol,
                        after_epoch=step)
        return self


    def fit_distributed(self, *args, mesh=None, **kwargs):
        """The whole :meth:`fit` on every rank: the constraint step reads the
        pairs' cells wherever they are stored, so scDCC has no sharded path
        and every rank ends with the single fit's weights."""
        return self.fit(*args, **kwargs)


def scdcc_preprocess(counts, gene_names: Sequence, labels=None, *,
                     n_top_genes: int = 2000) -> ClusteringInputs:
    """:meth:`ScDCC.preprocessing_pipeline` on raw ``counts`` (cells x genes)
    named ``gene_names``, wrapped in a ``Data``, for a caller that holds a
    matrix."""
    return zinb_counts_front(counts, gene_names, labels,
                             ScDCC.preprocessing_pipeline(n_top_genes, log_level="WARNING"))


__all__ = ["ScDCC", "scdcc_preprocess"]
