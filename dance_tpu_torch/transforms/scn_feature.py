"""SingleCellNet's top gene-pair features on arrays (counterpart:
dance_tpu/transforms/scn_feature.py).

Per cell type: the genes that pass the alpha/mu expression gates, ranked by
the signed sqrt-R² of a regression on the type's indicator (both ends); the
pairs of those genes, binarised as ``g1 > g2`` and ranked the same way, at
most ``max_gene_per_ct`` pairs per gene. The union of the types' pairs, as
sorted name tuples, gives one binary feature per pair. The JAX functions
take DataFrames; these take the matrix and its gene names, and the host
arithmetic is the same numpy. :class:`SCNFeature` on arrays returns the
pair matrix and its ``"g1&g2"`` column names; on a port ``Data`` it writes
them into ``obsm[out]`` as a ``Frame``, where the JAX transform writes a
DataFrame, and it is registered under JAX's key in the port's own registry.
"""

import itertools
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from dance_tpu_torch.data import Frame
from dance_tpu_torch.data.base import BaseData
from dance_tpu_torch.registry import register_preprocessor
from dance_tpu_torch.settings import logger
from dance_tpu_torch.transforms.base import BaseTransform
from dance_tpu_torch.transforms.stats import genestats_alpha, genestats_mu


def _columns(names: Sequence) -> Dict[str, int]:
    return {str(g): i for i, g in enumerate(names)}


def _get_deg_scores(exp: np.ndarray, cell_type_mask: np.ndarray) -> np.ndarray:
    """Signed sqrt-R² of regressing each column on the cell-type indicator
    (counterpart: scn_feature.py:16)."""
    y = np.vstack([cell_type_mask, np.ones(len(cell_type_mask))]).T
    p = np.linalg.lstsq(y, exp, rcond=None)[0]
    recon = y @ p
    ss_res = ((exp - recon) ** 2).sum(0)
    ss_tot = ((exp - exp.mean(0)) ** 2).sum(0)
    with np.errstate(divide="ignore", invalid="ignore"):
        r2 = np.clip(1 - ss_res / ss_tot, 0, None)
    return np.sqrt(r2) * np.sign(p[0])


def _get_degs_dict(exp: np.ndarray, gene_names: Sequence, cell_type_array,
                   num_top_genes: int, both_ends: bool = True) -> Dict[str, List[str]]:
    """Each type's ``num_top_genes`` highest-scoring genes (and lowest, with
    ``both_ends``), in gene order (counterpart: scn_feature.py:29)."""
    names = np.asarray(gene_names)
    degs = {}
    for ct in np.unique(cell_type_array):
        cval = _get_deg_scores(exp, (cell_type_array == ct).astype(float))
        valid = np.nonzero(~np.isnan(cval))[0]
        order = cval[valid].argsort()[::-1]
        sel = order[:num_top_genes].tolist()
        if both_ends:
            sel.extend(order[-num_top_genes:].tolist())
        degs[ct] = names[valid[sorted(set(sel))]].tolist()
    return degs


def get_diff_exp_genes(exp, gene_names: Sequence, cell_type_array, *, num_top_genes: int = 100,
                       threshold: float = 0, alpha1: float = 0.05, alpha2: float = 0.001,
                       mu: float = 2) -> Dict[str, List[str]]:
    """The differentially expressed genes of each type among the genes
    expressed in more than ``alpha1`` of the cells, or in more than
    ``alpha2`` at a mean above ``mu`` (counterpart: scn_feature.py:44)."""
    exp = np.asarray(exp)
    alpha = genestats_alpha(exp, threshold=threshold)
    mu_stat = genestats_mu(exp, threshold=threshold)
    keep = np.logical_or(alpha > alpha1, np.logical_and(alpha > alpha2, mu_stat > mu))
    return _get_degs_dict(exp[:, keep], np.asarray(gene_names)[keep], cell_type_array,
                          num_top_genes)


def _get_best_gene_pairs(scores, gene_pairs, num_pairs: int = 50,
                         max_gene_per_ct: int = 3) -> List[Tuple[str, str]]:
    """The best-scoring pairs, greedily, at most ``max_gene_per_ct`` per gene
    (counterpart: scn_feature.py:55)."""
    valid = np.nonzero(~np.isnan(scores))[0]
    order = valid[scores[valid].argsort()[::-1]]
    best, counts = [], defaultdict(int)
    for idx in order:
        g1, g2 = gene_pairs[idx]
        if counts[g1] < max_gene_per_ct and counts[g2] < max_gene_per_ct:
            best.append((g1, g2))
            counts[g1] += 1
            counts[g2] += 1
        if len(best) == num_pairs:
            break
    else:
        logger.warning("Ran out of gene pairs: wanted %d, got %d", num_pairs, len(best))
    return best


def get_top_gene_pairs(exp, gene_names: Sequence, cell_type_array, degs_dict, *,
                       num_top_pairs: int = 250,
                       max_gene_per_ct: int = 3) -> List[Tuple[str, str]]:
    """The union of every type's best binarised pairs, as sorted name tuples
    (counterpart: scn_feature.py:72)."""
    exp = np.asarray(exp)
    col = _columns(gene_names)
    top = []
    for ct, degs in degs_dict.items():
        pairs = list(itertools.combinations(degs, 2))
        if not pairs:
            continue
        g1 = [col[p[0]] for p in pairs]
        g2 = [col[p[1]] for p in pairs]
        pair_bin = (exp[:, g1] > exp[:, g2]).astype(float)
        scores = _get_deg_scores(pair_bin, (cell_type_array == ct).astype(float))
        top.extend(_get_best_gene_pairs(scores, pairs, num_pairs=num_top_pairs,
                                        max_gene_per_ct=max_gene_per_ct))
    return sorted(set(top))


def query_transform(exp, gene_names: Sequence,
                    gene_pairs: List[Tuple[str, str]]) -> Tuple[np.ndarray, List[str]]:
    """The float64 (cells, pairs) ``g1 > g2`` indicators and their
    ``"g1&g2"`` names (counterpart: scn_feature.py:91)."""
    col = _columns(gene_names)
    g1, g2 = ([col[g] for g in side] for side in zip(*gene_pairs))
    exp = np.asarray(exp)
    return (exp[:, g1] > exp[:, g2]).astype(float), ["&".join(p) for p in gene_pairs]


@register_preprocessor("feature", "cell")
class SCNFeature(BaseTransform):
    """Gene-pair features (counterpart: scn_feature.py:99).
    ``__call__(x, gene_names, cell_types, split_idx=None)`` selects the
    pairs on the cells ``split_idx`` (all when None) of the (cells x genes)
    ``x``, whose per-cell type names are ``cell_types``, and returns the
    pair features of every cell and their names. ``__call__(data)`` selects
    them on the cells of split ``"train"`` of ``X`` (a class constant,
    printed in the digest: no pipeline names another), their types the
    columns of the one-hot ``obsm["cell_type"]``, and writes every cell's
    features into ``obsm[out]``."""

    _DISPLAY_ATTRS = ("num_top_genes", "alpha1", "alpha2", "mu", "num_top_gene_pairs",
                      "max_gene_per_ct", "split_name")
    split_name = "train"

    def __init__(self, num_top_genes: int = 10, alpha1: float = 0.05, alpha2: float = 0.001,
                 mu: float = 2, num_top_gene_pairs: int = 25, max_gene_per_ct: int = 3,
                 **kwargs):
        super().__init__(**kwargs)
        self.num_top_genes = num_top_genes
        self.alpha1 = alpha1
        self.alpha2 = alpha2
        self.mu = mu
        self.num_top_gene_pairs = num_top_gene_pairs
        self.max_gene_per_ct = max_gene_per_ct

    def __call__(self, x, gene_names: Sequence = None, cell_types=None,
                 split_idx: Optional[Sequence[int]] = None) -> Tuple[np.ndarray, List[str]]:
        if isinstance(x, BaseData):
            return self._transform_data(x)
        x = np.asarray(x.toarray() if sp.issparse(x) else x)
        names = [str(g) for g in gene_names]
        idx = np.arange(x.shape[0]) if split_idx is None else np.asarray(split_idx)
        exp, ct_array = x[idx], np.asarray(cell_types)[idx]
        degs = get_diff_exp_genes(exp, names, ct_array, alpha1=self.alpha1, alpha2=self.alpha2,
                                  mu=self.mu, num_top_genes=self.num_top_genes)
        pairs = get_top_gene_pairs(exp, names, ct_array, degs,
                                   num_top_pairs=self.num_top_gene_pairs,
                                   max_gene_per_ct=self.max_gene_per_ct)
        return query_transform(x, names, pairs)

    def _transform_data(self, data):
        """Counterpart: scn_feature.py:121-138."""
        onehot = data.get_feature(return_type="default", channel="cell_type",
                                  channel_type="obsm")
        types = np.asarray(onehot.columns)[np.asarray(onehot.to_numpy()).argmax(1)]
        feat, names = self(data.get_feature(return_type="numpy", channel_type="X"),
                           data.data.var_names, types, data.get_split_idx(self.split_name))
        data.data.obsm[self.out] = Frame(feat, index=data.data.obs_names, columns=names)
        return data


__all__ = ["SCNFeature", "get_diff_exp_genes", "get_top_gene_pairs", "query_transform"]
