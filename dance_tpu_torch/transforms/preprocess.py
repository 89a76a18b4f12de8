"""Pairwise constraints for scDCC and DSTG's CCA gene helpers (counterpart:
dance_tpu/transforms/preprocess.py: ``generate_random_pair`` :202-237,
``l2norm``, ``ccaEmbed``, ``sortGenes`` and ``selectTopGenes`` :292-368).

``generate_random_pair`` draws from Python's global ``random`` and numpy's
global ``np.random`` as the JAX function does, making the same calls in the
same order, so after ``random.seed(s)`` and ``np.random.seed(s)`` both give
the same pairs.

The CCA helpers take genes x spots arrays where the JAX package takes pandas
frames, and name genes and spots by their row and column indices. Where
this differs from the JAX package:

- Genes with equal loadings are ranked by gene index; JAX's
  ``sort_values`` leaves them in pandas' order.
- :func:`selectTopGenes` returns the sorted gene indices; JAX returns
  ``list(set(...))`` of names, whose order follows string hashes and
  changes from process to process.
"""

import random
from typing import List, Sequence, Tuple

import numpy as np
import torch

from dance_tpu_torch.utils import resolve_device


def generate_random_pair(y, label_cell_indx, num, error_rate=0):
    """Random must-link / cannot-link pairs from labels ``y`` over the cells
    ``label_cell_indx``: ``num`` draws of two distinct cells, a same-label
    pair a must-link (each ordered pair once) and any other a cannot-link,
    the first ``error_rate · num`` draws flipped to simulate noisy
    supervision. Returns ``(ml_ind1, ml_ind2, cl_ind1, cl_ind2,
    error_num)``, each list in a random order."""
    y = np.asarray(y)
    label_cell_indx = list(label_cell_indx)
    ml_ind1, ml_ind2, cl_ind1, cl_ind2 = [], [], [], []
    seen_ml = set()
    error_num = 0
    num0 = num
    while num > 0:
        tmp1 = random.choice(label_cell_indx)
        tmp2 = random.choice(label_cell_indx)
        if tmp1 == tmp2 or (tmp1, tmp2) in seen_ml:
            continue
        flip = error_num < error_rate * num0
        if (y[tmp1] == y[tmp2]) != flip:  # a true pair kept, or a flipped link
            ml_ind1.append(tmp1)
            ml_ind2.append(tmp2)
            seen_ml.add((tmp1, tmp2))
        else:
            cl_ind1.append(tmp1)
            cl_ind2.append(tmp2)
        if flip:
            error_num += 1
        num -= 1
    ml_ind1, ml_ind2 = np.array(ml_ind1, int), np.array(ml_ind2, int)
    cl_ind1, cl_ind2 = np.array(cl_ind1, int), np.array(cl_ind2, int)
    ml_perm = np.random.permutation(len(ml_ind1))
    cl_perm = np.random.permutation(len(cl_ind1))
    return (ml_ind1[ml_perm], ml_ind2[ml_perm], cl_ind1[cl_perm], cl_ind2[cl_perm], error_num)


def l2norm(mat) -> np.ndarray:
    """Rows over their L2 norms, float64; a row of zeros stays zeros
    (counterpart: preprocess.py:292)."""
    arr = np.asarray(mat)
    stat = np.sqrt((arr ** 2).sum(1))
    return np.divide(arr, stat[:, None], out=np.zeros_like(arr, dtype=float),
                     where=stat[:, None] != 0)


def _scale_columns(a: torch.Tensor) -> torch.Tensor:
    """scikit-learn's ``scale``: each column centred and over its population
    std, a std under 10 float64 epsilons taken as 1."""
    std = a.std(0, correction=0)
    std = torch.where(std < 10 * np.finfo(np.float64).eps, 1.0, std)
    return (a - a.mean(0)) / std


def ccaEmbed(data1, data2, num_cc: int = 30, *,
             device="auto") -> Tuple[List[np.ndarray], np.ndarray]:
    """The CCA embedding of two genes x spots sets over the same genes
    (counterpart: preprocess.py:314): each spot standardised over the genes,
    the SVD of the two sets' cross-product, in float64 on ``device``.
    Returns ``([embeds, d], loadings)``: the (spots1 + spots2, num_cc)
    embedding of both sets stacked, each component's sign set so that its
    first row is not negative, the singular values, and the (genes,
    num_cc) gene loadings of the stacked sets. JAX's inner join on the gene
    names and its ``dropna`` have nothing to do on arrays of the same genes;
    a NaN raises."""
    device = resolve_device(device)
    a = torch.as_tensor(np.asarray(data1, np.float64)).to(device)
    b = torch.as_tensor(np.asarray(data2, np.float64)).to(device)
    if torch.isnan(a).any() or torch.isnan(b).any():
        raise ValueError("ccaEmbed: NaN in the inputs (JAX drops those genes)")
    u, s, vt = torch.linalg.svd(_scale_columns(a).T @ _scale_columns(b), full_matrices=False)
    k = int(num_cc)
    embeds = torch.cat([u[:, :k], vt[:k].T])
    embeds = embeds * torch.where(embeds[0] < 0, -1.0, 1.0)
    loadings = torch.cat([a, b], dim=1) @ embeds
    return [embeds.cpu().numpy(), s[:k].cpu().numpy()], loadings.cpu().numpy()


def _top_genes(loadings: np.ndarray, dim: int):
    """Gene indices by decreasing and by increasing loading on ``dim``, ties
    by gene index."""
    data = np.asarray(loadings)[:, dim]
    return np.argsort(-data, kind="stable"), np.argsort(data, kind="stable")


def sortGenes(Loadings, dim: int, numG: int) -> np.ndarray:
    """The round(numG / 2) genes of largest loading on component ``dim``,
    then as many of the smallest (counterpart: preprocess.py:338)."""
    num = int(np.round(numG / 2))
    pos, neg = _top_genes(Loadings, dim)
    return np.concatenate((pos[:num], neg[:num]))


def selectTopGenes(Loadings, dims: Sequence[int], DimGenes: int, maxGenes: int) -> np.ndarray:
    """The union over ``dims`` of :func:`sortGenes` at the largest gene count
    per component, up to ``DimGenes``, whose union stays under ``max(2
    len(dims), maxGenes)`` genes (counterpart: preprocess.py:347). Returns
    the sorted gene indices."""
    max_g = max(len(dims) * 2, maxGenes)
    orders = [_top_genes(Loadings, j) for j in dims]

    def union(num_g):
        num = int(np.round(num_g / 2))
        return set(np.concatenate([np.concatenate((pos[:num], neg[:num]))
                                   for pos, neg in orders]).tolist())

    lens = np.array([len(union(i)) for i in range(1, DimGenes + 1)])
    lens = lens[lens < max_g]
    max_per = int(np.where(lens == lens.max())[0][0]) + 1
    return np.array(sorted(union(max_per)), dtype=np.int64)


__all__ = ["ccaEmbed", "generate_random_pair", "l2norm", "selectTopGenes", "sortGenes"]
