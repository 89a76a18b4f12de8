"""Port parity for the scanpy tools (dance_tpu_torch.sc.tl): marker genes by
Wilcoxon rank sums and Welch's t-test with Benjamini-Hochberg correction,
gene scores and cell-cycle phases, Louvain and Leiden over the neighbour
graph, and UMAP.

Inputs are made with numpy from a seed (``typed_counts``: at most 300 cells
x 60 genes, with never-expressed genes, whose Wilcoxon z is 0) and handed
to both packages; the JAX side runs on ``dance_tpu.data.AnnData``.
Tolerances:

- the rank statistics, p-values, BH and fold changes (float64 on both
  sides): rtol 1e-10, gene by gene. The names are compared where JAX's keys
  are distinct; among equal scores JAX's order is numpy's unstable sort's
  and the port's is by gene index, so there the test checks that the
  port's order is a valid one;
- gene scores: 1e-6 (JAX means float32 data in float32, the port in
  float64), the control genes bit-equal (numpy's draw);
- the Louvain and Leiden labels exactly (one C++ source);
- UMAP's spectral start and ``(a, b)``: 1e-5 (the same host scipy); 5
  epochs from JAX's negatives (rebuilt from ``jax.random`` with the same key
  splits and handed in): 1e-4 (float32 sums scattered in another order);
  200 epochs from each side's own draws: the 15-NN preservation within 0.05
  of JAX's (the layout is chaotic over 200 epochs).
"""

import jax
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from dance_tpu.data import AnnData
from dance_tpu.sc import pp as jpp
from dance_tpu.sc import tl as jtl
from dance_tpu_torch.sc import pp as tpp
from dance_tpu_torch.sc import tl as ttl
from torch_cases import typed_counts

CPU = torch.device("cpu")


def _typed(n=240, g=60, seed=0, n_types=4):
    counts, types, names = typed_counts(n=n, g=g, n_types=n_types, seed=seed)
    x = np.log1p(counts)
    return x, types.astype(str), names


def _jax_rank(x, groups, names, **kw):
    ad = AnnData(X=x, obs=pd.DataFrame({"g": groups}))
    ad.var_names = names
    jtl.rank_genes_groups(ad, "g", **kw)
    return ad.uns["rank_genes_groups"]


def _by_gene(res, key, group, names):
    """One group's statistic ``key`` in gene order."""
    pos = {n: i for i, n in enumerate(names)}
    out = np.empty(len(res["names"][group]))
    out[[pos[n] for n in res["names"][group]]] = res[key][group]
    return out


# --------------------------------------------------------------------------
# marker genes
# --------------------------------------------------------------------------

def test_bh_adjust_matches_jax():
    rng = np.random.default_rng(0)
    p = rng.random(200) ** 3
    p[10:40] = p[5]  # ties: the same adjusted value whatever their order
    p[50:60] = 1.0
    p[60:65] = 0.0
    np.testing.assert_allclose(ttl._bh_adjust(p).numpy(), jtl._bh_adjust(p), rtol=1e-12, atol=0)


@pytest.mark.parametrize("pts", [True, False])
@pytest.mark.parametrize("method", ["wilcoxon", "t-test"])
def test_rank_genes_groups_matches_jax(method, pts):
    x, groups, names = _typed(seed=1)
    want = _jax_rank(x, groups, names, method=method, n_genes=25, pts=pts)
    got = ttl.rank_genes_groups(x, groups, method=method, n_genes=25, pts=pts,
                                gene_names=names, device=CPU)
    assert list(got["names"]) == list(want["names"]) == ["0", "1", "2", "3"]
    assert got["params"]["method"] == method and ("pts" in got) == pts
    keys = ["scores", "pvals", "pvals_adj", "logfoldchanges"] + (["pts", "pts_rest"] * pts)
    for g in want["names"]:
        # JAX's quirk: Wilcoxon keeps every gene, the t-test n_genes
        assert len(got["names"][g]) == len(want["names"][g]) == (60 if method == "wilcoxon"
                                                                  else 25)
        if method == "wilcoxon":
            for key in keys:
                np.testing.assert_allclose(_by_gene(got, key, g, names),
                                           _by_gene(want, key, g, names), rtol=1e-10,
                                           atol=1e-300, err_msg=f"{g} {key}")
        scores = want["scores"][g]
        distinct = np.r_[True, scores[1:] != scores[:-1]] & np.r_[scores[:-1] != scores[1:], True]
        np.testing.assert_array_equal(got["names"][g][distinct], want["names"][g][distinct])
        # the port's order is by score, ties by gene index
        pos = np.array([list(names).index(n) for n in got["names"][g]])
        s = got["scores"][g]
        assert np.all((s[:-1] > s[1:]) | ((s[:-1] == s[1:]) & (pos[:-1] < pos[1:])))
        for key in keys:
            both = np.isin(got["names"][g], want["names"][g])
            w = dict(zip(want["names"][g], want[key][g]))
            np.testing.assert_allclose(got[key][g][both],
                                       [w[n] for n in got["names"][g][both]], rtol=1e-10,
                                       atol=1e-300, err_msg=f"{g} {key}")


def test_wilcoxon_all_equal_genes_have_z_zero():
    """A gene equal in every cell has tie term n (n - 1) (n + 1): its
    variance is exactly 0 and its z 0, as in JAX; no rounding noise."""
    x, groups, names = _typed(seed=2)
    x[:, 7] = 0.0
    x[:, 9] = 1.5
    got = ttl.rank_genes_groups(x, groups, method="wilcoxon", gene_names=names, device=CPU)
    want = _jax_rank(x, groups, names, method="wilcoxon")
    for g in got["names"]:
        for j in (7, 9):
            assert _by_gene(got, "scores", g, names)[j] == 0.0
            assert _by_gene(want, "scores", g, names)[j] == 0.0
            assert _by_gene(got, "pvals", g, names)[j] == 1.0


def test_average_ranks_match_scipy():
    from scipy.stats import rankdata

    rng = np.random.default_rng(3)
    x = rng.integers(0, 4, (50, 6)).astype(np.float64)  # many ties
    ranks, tie = ttl._average_ranks(torch.from_numpy(x))
    np.testing.assert_array_equal(ranks.numpy(), rankdata(x, axis=0))
    want = [np.sum(c.astype(float) ** 3 - c) for c in
            (np.unique(x[:, j], return_counts=True)[1] for j in range(6))]
    np.testing.assert_array_equal(tie.numpy(), want)


def _marker_case(twins: bool):
    """Cells of 3 types over 60 genes at a low base rate, 12 marker genes a
    type at 60 times it; with ``twins`` each marker gene has a copy, whose
    statistics are the same to the last bit (ties in the adjusted p-values)."""
    rng = np.random.default_rng(4)
    types = rng.integers(0, 3, 300)
    rates = np.tile(rng.gamma(2.0, 0.05, 60), (300, 1))
    for t in range(3):
        rates[np.ix_(types == t, np.arange(t * 12, t * 12 + 12))] *= 60.0
    x = np.log1p(rng.poisson(rates)).astype(np.float32)
    if twins:
        x[:, 36:] = x[:, [t * 12 + j for t in range(3) for j in range(8)]]
    return x, np.array([f"g{j}" for j in range(60)]), np.array([f"t{t}" for t in types])


@pytest.mark.parametrize("twins", [False, True])
def test_stdgcn_marker_genes_match_jax(twins):
    """``stdgcn_marker_genes`` against ``stdGCNMarkGenes``: every pick passes
    the filters, no passing gene left out has a smaller adjusted p-value than
    a pick, the picks are JAX's where the cut is not tied, and in JAX's
    order where the adjusted p-values are distinct. BH's running minimum
    ties adjusted p-values even where the p-values are distinct, and JAX's
    unstable sort orders those its own way; with ``twins`` the twin genes
    tie to the last bit."""
    from dance_tpu.data import Data
    from dance_tpu.modules.spatial.cell_type_deconvo.stdgcn import stdGCNMarkGenes
    from dance_tpu_torch.modules.spatial.cell_type_deconvo import stdgcn_marker_genes

    x, names, labels = _marker_case(twins)
    ad = AnnData(X=x, obs=pd.DataFrame({"cellType": labels}))
    ad.var_names = names
    data = Data(ad, train_size="all")
    stdGCNMarkGenes(top_gene_per_type=6, split="train")(data)
    want = data.data.uns["gene_dict"]
    gene_list, got = stdgcn_marker_genes(x, labels, names, top_gene_per_type=6, device=CPU)
    stats = _jax_rank(x, labels, names, method="wilcoxon", pts=True)
    assert list(got) == list(want) and gene_list == sorted(set().union(*got.values()))
    ties = 0
    for t in got:
        padj = dict(zip(stats["names"][t], stats["pvals_adj"][t]))
        ok = {n for n, p, l, a, b in zip(stats["names"][t], stats["pvals_adj"][t],
                                         stats["logfoldchanges"][t], stats["pts"][t],
                                         stats["pts_rest"][t])
              if p < 0.1 and l >= 1.0 and a >= 0.7 and b < 0.3}
        assert set(got[t]) <= ok and len(got[t]) == len(want[t]) == min(6, len(ok)) > 0
        worst = max(padj[n] for n in got[t])
        assert all(padj[n] >= worst for n in ok - set(got[t]))
        # where the cut is not tied, the same genes; where keys are distinct, in order
        if all(padj[n] > worst for n in ok - set(got[t])):
            assert set(got[t]) == set(want[t])
        keys, passing = [padj[n] for n in want[t]], [padj[n] for n in ok]
        for i, n in enumerate(want[t]):
            if passing.count(keys[i]) == 1:
                assert got[t][i] == n
        ties += len(set(keys)) < len(keys)
    assert ties > 0 if twins else True
    if not twins:
        assert gene_list == data.data.uns["gene_list"]


# --------------------------------------------------------------------------
# gene scores
# --------------------------------------------------------------------------

def test_score_genes_matches_jax():
    x, _, names = _typed(seed=6)
    genes = list(names[[3, 8, 21, 40]]) + ["not_a_gene"]
    ad = AnnData(X=x)
    ad.var_names = names
    jtl.score_genes(ad, genes, ctrl_size=12, random_state=3)
    got = ttl.score_genes(x, genes, names, ctrl_size=12, random_state=3, device=CPU)
    np.testing.assert_allclose(got, ad.obs["score"].to_numpy(), rtol=1e-6, atol=1e-6)
    want_ctrl = np.random.default_rng(3).choice(60, size=12, replace=False)
    np.testing.assert_array_equal(ttl.control_genes(60, 12, 3), want_ctrl)
    np.testing.assert_array_equal(ttl.score_genes(x, ["nope"], names, device=CPU), 0.0)


def test_score_genes_cell_cycle_matches_jax():
    x, _, names = _typed(seed=7)
    s_genes, g2m_genes = list(names[:10]), list(names[10:20])
    ad = AnnData(X=x)
    ad.var_names = names
    jtl.score_genes_cell_cycle(ad, s_genes, g2m_genes, ctrl_size=15, random_state=1)
    s, g2m, phase = ttl.score_genes_cell_cycle(x, s_genes, g2m_genes, names, ctrl_size=15,
                                               random_state=1, device=CPU)
    np.testing.assert_allclose(s, ad.obs["S_score"].to_numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g2m, ad.obs["G2M_score"].to_numpy(), rtol=1e-6, atol=1e-6)
    # the phase where the rule is not decided within the scores' float32 rounding
    clear = (np.abs(s - g2m) > 1e-5) & (np.abs(s) > 1e-5) & (np.abs(g2m) > 1e-5)
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(phase[clear], ad.obs["phase"].to_numpy()[clear])
    assert set(phase) <= {"G1", "S", "G2M"} and len(set(phase)) > 1


# --------------------------------------------------------------------------
# neighbour graph tools
# --------------------------------------------------------------------------

def _graph_case(n=150, seed=8):
    rng = np.random.default_rng(seed)
    truth = rng.integers(0, 3, n)
    rep = (rng.standard_normal((3, 8)) * 4)[truth] + rng.standard_normal((n, 8))
    rep = (rep - rep.mean(0)).astype(np.float32)
    ad = AnnData(X=np.zeros((n, 2), np.float32), obsm={"X_pca": rep})
    jpp.neighbors(ad, n_neighbors=10)
    return ad, rep, truth


@pytest.mark.parametrize("which", ["louvain", "leiden"])
def test_louvain_and_leiden_match_jax(which):
    ad, _, _ = _graph_case()
    getattr(jtl, which)(ad, resolution=0.8, random_state=2)
    conn = sp.csr_matrix(ad.obsp["connectivities"])
    got = getattr(ttl, which)(conn, resolution=0.8, random_state=2)
    np.testing.assert_array_equal(got.astype(str), ad.obs[which].to_numpy().astype(str))


def test_pca_tool_is_pp_pca():
    x, _, _ = _typed(seed=9)
    a = ttl.pca(x, n_comps=5, device=CPU)
    b = tpp.pca(x, n_comps=5, device=CPU)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def _jax_negatives(seed, n_epochs, n_edges, n):
    key = jax.random.key(seed)
    out = []
    for _ in range(n_epochs):
        key, nk = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(nk, (n_edges,), 0, n)))
    return np.stack(out)


def test_umap_start_and_curve_match_jax():
    ad, _, _ = _graph_case()
    conn = sp.csr_matrix(ad.obsp["connectivities"]).astype(np.float64)
    np.testing.assert_allclose(ttl._spectral_init(conn, 2), jtl._spectral_init(conn, 2),
                               rtol=1e-5, atol=1e-5)
    jtl.umap(ad, n_epochs=0)
    np.testing.assert_allclose(ttl.umap(conn, n_epochs=0, device=CPU), ad.obsm["X_umap"],
                               rtol=1e-5, atol=1e-5)
    from scipy.optimize import curve_fit
    xv = np.linspace(0, 3, 300)
    yv = np.where(xv < 0.3, 1.0, np.exp(-(xv - 0.3)))
    (a, b), _ = curve_fit(lambda x, a, b: 1.0 / (1.0 + a * x ** (2 * b)), xv, yv, maxfev=10000)
    np.testing.assert_allclose(ttl._fit_ab(0.3, 1.0), (a, b), rtol=1e-5)


@pytest.mark.parametrize("min_dist", [0.5, 0.1])
def test_umap_epochs_with_jax_negatives_match_jax(min_dist):
    """Five epochs from JAX's draws. At ``min_dist`` 0.1 the curve's b is
    under 1, where a pair at distance 0 would give a NaN on both sides; the
    spectral start has none."""
    ad, _, _ = _graph_case()
    conn = sp.csr_matrix(ad.obsp["connectivities"])
    n_edges = sp.triu(conn.maximum(conn.T), k=1).nnz
    negs = _jax_negatives(4, 5, n_edges, conn.shape[0])
    jtl.umap(ad, n_epochs=5, random_state=4, min_dist=min_dist)
    got = ttl.umap(conn, n_epochs=5, min_dist=min_dist, negatives=negs, device=CPU)
    assert got.dtype == np.float32
    want = ad.obsm["X_umap"]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    with pytest.raises(ValueError, match="negatives"):
        ttl.umap(conn, n_epochs=4, negatives=negs, device=CPU)


def test_umap_coincident_pair_is_nan_as_in_jax():
    """Two points of an edge at one place with b < 1: ``0 ** (b - 1)`` is
    inf, times a zero difference a NaN, in JAX's epoch and in the port's."""
    import jax.numpy as jnp

    emb = np.array([[0.0, 0.0], [0.0, 0.0], [1.0, 2.0]], np.float32)
    src, dst, w = np.array([0, 1]), np.array([1, 2]), np.ones(2, np.float32)
    neg = np.array([2, 0])
    a, b = ttl._fit_ab(0.1, 1.0)
    assert b < 1
    got = ttl._umap_epoch(torch.from_numpy(emb), torch.from_numpy(src), torch.from_numpy(dst),
                          torch.from_numpy(w), torch.from_numpy(neg), torch.tensor(1.0), a, b)
    d = jnp.asarray(emb)[src] - jnp.asarray(emb)[dst]
    coef = -2.0 * a * b * (d ** 2).sum(1) ** (b - 1.0) / (1.0 + a * (d ** 2).sum(1) ** b)
    want_nan = np.isnan(np.asarray(jnp.clip(coef[:, None] * d, -4.0, 4.0)))
    assert want_nan[0].all() and np.isnan(got.numpy()[:2]).all()


def test_umap_200_epochs_preserve_neighbours_as_jax():
    ad, rep, _ = _graph_case(n=200, seed=10)
    conn = sp.csr_matrix(ad.obsp["connectivities"])
    jtl.umap(ad, random_state=0)
    got = ttl.umap(conn, random_state=0, device=CPU)

    def preserved(emb):
        def nn(z):
            d = ((z[:, None] - z[None]) ** 2).sum(-1) + np.eye(len(z)) * 1e30
            return np.argsort(d, 1)[:, :15]
        a, b = nn(rep.astype(np.float64)), nn(emb.astype(np.float64))
        return np.mean([len(set(u) & set(v)) / 15 for u, v in zip(a, b)])

    assert np.isfinite(got).all() and got.shape == (200, 2)
    assert abs(preserved(got) - preserved(ad.obsm["X_umap"])) <= 0.05
    assert preserved(got) > 0.3
