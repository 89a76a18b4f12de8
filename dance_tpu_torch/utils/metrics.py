"""The modality-matching evaluator, the joint-embedding suite's entry
point, the adjusted Rand index on the device and the joint-embedding models'
shared ``score`` (counterparts: ``device_ari``, dance_tpu/utils/metrics.py:59;
``get_bipartite_matching_adjacency_matrix``, its ``_mk3`` name,
``batch_separated_bipartite_matching`` and ``_softmax`` metrics.py:115-165;
``integration_openproblems_evaluate`` metrics.py:183). ``acc``, ``ari``,
``nmi``, ``mse``, ``rmse`` and ``mape`` are in :mod:`dance_tpu_torch.utils`
and re-exported here.

The evaluator is host numpy in float64 plus scipy's
``linear_sum_assignment``, copied from the JAX package, which it may not
import. The suite itself is :mod:`dance_tpu_torch.utils.scib_metrics`.
"""

import numpy as np
import scipy.optimize
import torch
import torch.nn.functional as F

from dance_tpu_torch.utils import acc, ari, mape, mse, nmi, rmse  # noqa: F401


def device_ari(true, pred, n_true: int, n_pred: int) -> torch.Tensor:
    """The adjusted Rand index of two integer labelings as a scalar float32
    tensor where ``pred`` lies (counterpart: metrics.py:59): the contingency
    table by one product of one-hot matrices, then the pair counts. For
    per-epoch selection without a copy to the host; the host :func:`ari`
    counts in exact integers."""
    pred = torch.as_tensor(pred)
    true = torch.as_tensor(true, device=pred.device)
    t = F.one_hot(true.long(), n_true).to(torch.float32)
    p = F.one_hot(pred.long(), n_pred).to(torch.float32)
    cont = p.T @ t

    def comb2(x):
        return x * (x - 1.0) * 0.5

    sum_ij = comb2(cont).sum()
    a = comb2(cont.sum(1)).sum()
    b = comb2(cont.sum(0)).sum()
    total = comb2(torch.tensor(float(t.shape[0]), device=t.device))
    expected = a * b / total.clamp(min=1.0)
    denom = 0.5 * (a + b) - expected
    return torch.where(denom == 0, torch.ones_like(denom), (sum_ij - expected) / denom)


def get_bipartite_matching_adjacency_matrix(raw_logits, threshold_quantile: float = 0.995):
    """Sparse-then-assign bipartite matching (counterpart: metrics.py:115):
    entries below both their row's and their column's ``threshold_quantile``
    are zeroed, then a minimum-weight full matching on the negated scores
    gives a permutation-like 0/1 matrix (float64)."""
    weights = np.array(raw_logits, dtype=np.float64, copy=True)
    q_row = np.quantile(weights, threshold_quantile, axis=0, keepdims=True)
    q_col = np.quantile(weights, threshold_quantile, axis=1, keepdims=True)
    weights[(weights < q_row) & (weights < q_col)] = 0
    row_ind, col_ind = scipy.optimize.linear_sum_assignment(-weights)
    out = np.zeros_like(weights)
    out[row_ind, col_ind] = 1
    return out


def get_bipartite_matching_adjacency_matrix_mk3(raw_logits, threshold_quantile=0.995,
                                                 copy=False):
    """The reference's name for :func:`get_bipartite_matching_adjacency_matrix`
    (counterpart: metrics.py:132)."""
    logits = raw_logits.copy() if copy else raw_logits
    return get_bipartite_matching_adjacency_matrix(logits, threshold_quantile=threshold_quantile)


def _softmax(x, axis):
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def batch_separated_bipartite_matching(batch1, batch2, emb1, emb2, threshold_quantile=0.995):
    """Bipartite matching of two modalities' embeddings within each batch
    label of ``batch1`` (counterpart: metrics.py:141): the dot-product
    logits, made symmetric by adding their row and column softmaxes, matched
    by :func:`get_bipartite_matching_adjacency_matrix`. Returns the
    (len(batch1), len(batch2)) 0/1 matrix, float64."""
    batch1, batch2 = np.asarray(batch1), np.asarray(batch2)
    emb1, emb2 = np.asarray(emb1), np.asarray(emb2)
    matrix = np.zeros((batch1.shape[0], batch2.shape[0]))
    for b in np.unique(batch1):
        i0 = np.nonzero(batch1 == b)[0]
        j0 = np.nonzero(batch2 == b)[0]
        logits = emb1[i0] @ emb2[j0].T
        logits = _softmax(logits, axis=-1) + _softmax(logits, axis=0)
        matrix[np.ix_(i0, j0)] = get_bipartite_matching_adjacency_matrix(
            logits, threshold_quantile=threshold_quantile)
    return matrix


def integration_openproblems_evaluate(emb, cell_type, batch=None, **kwargs):
    """The scIB joint-embedding suite (counterpart: metrics.py:183):
    :func:`~dance_tpu_torch.utils.scib_metrics.integration_openproblems_suite`,
    whose keyword arguments (``emb_pre``, ``s_score``, ``g2m_score``,
    ``pseudotime``, ``k``, ``device``) pass through."""
    from dance_tpu_torch.utils.scib_metrics import integration_openproblems_suite

    return integration_openproblems_suite(emb, cell_type, batch, **kwargs)


def score_embedding(emb, y, *, metric: str = "clustering", batch=None, device=None,
                    return_pred: bool = False, **kwargs):
    """The joint-embedding models' ``score`` (counterpart: the ``score`` of
    dance_tpu/modules/multi_modality/joint_embedding/{scmogcn,dcca,jae,
    scmvae}.py): ``metric="clustering"`` gives the k-means NMI of ``emb``
    against ``y`` with as many clusters as labels
    (:func:`~dance_tpu_torch.utils.labeled_clustering_evaluate`);
    ``"openproblems"`` the scIB suite's ``final_scores`` (``batch`` and the
    suite's keyword arguments pass through). ``return_pred`` returns
    ``(scores, emb)``; ``device`` is where the clustering runs."""
    from dance_tpu_torch.utils import labeled_clustering_evaluate

    y = np.asarray(y)
    if metric == "openproblems":
        scores = integration_openproblems_evaluate(emb, y, batch, device=device, **kwargs)
        return (scores, emb) if return_pred else scores["final_scores"]
    scores = labeled_clustering_evaluate(emb, y, n_clusters=len(np.unique(y)), device=device)
    return (scores, emb) if return_pred else scores["dance_nmi"]


__all__ = ["acc", "ari", "batch_separated_bipartite_matching", "device_ari",
           "get_bipartite_matching_adjacency_matrix",
           "get_bipartite_matching_adjacency_matrix_mk3", "integration_openproblems_evaluate",
           "mape", "mse", "nmi", "rmse", "score_embedding"]
