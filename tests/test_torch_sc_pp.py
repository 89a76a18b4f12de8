"""Port parity for the scanpy preprocessing surface (dance_tpu_torch.sc.pp):
the ``seurat`` HVG flavour and HVG batches, the QC metrics, the neighbour
graph, PCA, regress-out, ComBat, Scrublet and subsampling, with the PCA
projection and the Gaussian projection of ops.linalg.

Inputs are made with numpy from a seed (``typed_counts``: at most 300 cells
x 60 genes) and handed to both packages; the JAX side runs on
``dance_tpu.data.AnnData``. Tolerances, as the arithmetic allows:

- the HVG masks and statistics, the numpy draws of subsample and of
  Scrublet's pairs: bit-equal (the same host numpy, and pandas' ``pd.cut``
  and group statistics written out in its arithmetic);
- ComBat and regress-out (float64 on both sides, float32 out): rtol 1e-10;
- QC metrics and the neighbour graph: 1e-5 (float32 sums in another order;
  a cell's distance to itself is the square root of the distance formula's
  rounding, ~1e-3, on either side, so the diagonal is held under 1e-2);
- PCA (float32 SVDs of two libraries): 1e-4 of the largest value;
- Scrublet's scores: 1e-5 on every cell whose neighbour list is the same
  set in both, JAX's first neighbour the cell itself; elsewhere the lists
  hold coinciding points (a cell without counts is a doublet's partner that
  leaves the other cell's profile unchanged), which each side orders its
  own way, and JAX drops the first where the port drops the cell.
"""

import jax
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from dance_tpu.data import AnnData
from dance_tpu.ops import linalg as jlinalg
from dance_tpu.ops.neighbors import knn as jknn
from dance_tpu.sc import pp as jpp
from dance_tpu_torch.ops import linalg as tlinalg
from dance_tpu_torch.ops.neighbors import knn as tknn
from dance_tpu_torch.sc import pp as tpp
from torch_cases import typed_counts

CPU = torch.device("cpu")


def _log_counts(n=240, g=60, seed=0, sparse=False):
    counts, types, names = typed_counts(n=n, g=g, n_types=4, seed=seed)
    x = np.log1p(counts)
    return (sp.csr_matrix(x) if sparse else x), counts, types


def _frame(want: pd.DataFrame, got: dict, keys):
    for key in keys:
        w = want[key].to_numpy()
        assert got[key].dtype == w.dtype, key
        np.testing.assert_array_equal(got[key], w, err_msg=key)


# --------------------------------------------------------------------------
# highly variable genes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_top_genes", [None, 15])
@pytest.mark.parametrize("sparse", [False, True])
def test_seurat_hvg_matches_jax(sparse, n_top_genes):
    """Bit-equal: the zero dispersions (never-expressed genes) are NaN, a
    bin of one gene falls back to its centred dispersion."""
    x, _, _ = _log_counts(seed=1, sparse=sparse)
    want = jpp.highly_variable_genes(AnnData(X=x), flavor="seurat", n_top_genes=n_top_genes,
                                     inplace=False)
    got = tpp.highly_variable_genes(x, n_top_genes=n_top_genes)  # seurat is the default
    _frame(want, got, ("highly_variable", "means", "dispersions", "dispersions_norm"))
    assert np.isnan(got["dispersions"]).any() and 0 < got["highly_variable"].sum() < x.shape[1]


@pytest.mark.parametrize("n_bins", [20, 3])
def test_seurat_hvg_bins_and_cutoffs_match_jax(n_bins):
    """Few bins (genes on shared edges), the mean and dispersion cut-offs
    moved, and a constant matrix (one mean: the bin edges widened at both
    ends, every dispersion NaN)."""
    x, _, _ = _log_counts(seed=2)
    kw = dict(flavor="seurat", n_bins=n_bins, min_mean=0.1, max_mean=2.0, min_disp=0.2)
    want = jpp.highly_variable_genes(AnnData(X=x), inplace=False, **kw)
    _frame(want, tpp.highly_variable_genes(x, **kw),
           ("highly_variable", "means", "dispersions", "dispersions_norm"))
    ones = np.ones((6, 5), np.float32)
    want = jpp.highly_variable_genes(AnnData(X=ones), inplace=False, **kw)
    _frame(want, tpp.highly_variable_genes(ones, **kw), ("highly_variable", "dispersions_norm"))


@pytest.mark.parametrize("flavor,n_top_genes", [("seurat", None), ("seurat", 12),
                                                ("cell_ranger", 12), ("seurat_v3", 20)])
def test_hvg_batches_match_jax(flavor, n_top_genes):
    """Per-batch selections ranked by their count, then the summed normalised
    dispersion: the masks and counts bit-equal."""
    x, counts, _ = _log_counts(seed=3)
    data = counts if flavor == "seurat_v3" else x
    batch = np.array(["b", "a", "c"])[np.random.default_rng(3).integers(0, 3, len(x))]
    ad = AnnData(X=data, obs=pd.DataFrame({"batch": batch}))
    want = jpp.highly_variable_genes(ad, flavor=flavor, n_top_genes=n_top_genes,
                                     batch_key="batch", inplace=False)
    got = tpp.highly_variable_genes(data, flavor=flavor, n_top_genes=n_top_genes,
                                    batch_key=batch)
    for key in ("highly_variable", "highly_variable_nbatches"):
        np.testing.assert_array_equal(got[key], want[key].to_numpy(), err_msg=key)
    assert got["highly_variable"].any()


# --------------------------------------------------------------------------
# QC, neighbours, PCA
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sparse", [False, True])
def test_calculate_qc_metrics_matches_jax(sparse):
    _, counts, _ = _log_counts(seed=4)
    x = sp.csr_matrix(counts) if sparse else counts
    ad = AnnData(X=x)
    jpp.calculate_qc_metrics(ad, percent_top=(5, 20, 100))
    obs, var = tpp.calculate_qc_metrics(x, percent_top=(5, 20, 100), device=CPU)
    assert set(obs) == {"n_genes_by_counts", "total_counts", "pct_counts_in_top_5_genes",
                        "pct_counts_in_top_20_genes"}
    for key, val in obs.items():
        np.testing.assert_allclose(val, ad.obs[key].to_numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    for key, val in var.items():
        np.testing.assert_allclose(val, ad.var[key].to_numpy(), rtol=1e-5, err_msg=key)
    np.testing.assert_array_equal(obs["n_genes_by_counts"], ad.obs["n_genes_by_counts"])


@pytest.mark.parametrize("n_pcs", [None, 6])
def test_neighbors_matches_jax(n_pcs):
    rng = np.random.default_rng(5)
    rep = rng.standard_normal((200, 10)) + 3 * rng.integers(0, 3, (200, 1))
    rep = (rep - rep.mean(0)).astype(np.float32)  # centred, as a PCA is
    ad = AnnData(X=np.zeros((200, 2), np.float32), obsm={"X_pca": rep})
    jpp.neighbors(ad, n_neighbors=8, n_pcs=n_pcs)
    dist, conn = tpp.neighbors(rep, n_neighbors=8, n_pcs=n_pcs, device=CPU)
    for got, want in ((dist, ad.obsp["distances"]), (conn, ad.obsp["connectivities"])):
        want = sp.csr_matrix(want)
        np.testing.assert_array_equal((got != 0).toarray() | np.eye(200, dtype=bool),
                                      (want != 0).toarray() | np.eye(200, dtype=bool))
        off = ~np.eye(200, dtype=bool)
        np.testing.assert_allclose(got.toarray()[off], want.toarray()[off], rtol=1e-5, atol=1e-5)
    assert np.abs(dist.diagonal()).max() < 1e-2 and conn.diagonal().max() == 0
    assert (conn != conn.T).nnz == 0


def test_neighbors_on_coordinates_uses_the_kdtree():
    """Three or fewer columns: the host KD-tree, bit-equal with JAX's."""
    xy = np.random.default_rng(6).random((150, 2)).astype(np.float32) * 10
    ad = AnnData(X=np.zeros((150, 2), np.float32), obsm={"X_pca": xy})
    jpp.neighbors(ad, n_neighbors=6)
    dist, conn = tpp.neighbors(xy, n_neighbors=6, device=CPU)
    np.testing.assert_array_equal(dist.toarray(), sp.csr_matrix(ad.obsp["distances"]).toarray())
    np.testing.assert_array_equal(conn.toarray(),
                                  sp.csr_matrix(ad.obsp["connectivities"]).toarray())


@pytest.mark.parametrize("zero_center", [True, False])
def test_pca_matches_jax(zero_center):
    x, _, _ = _log_counts(seed=7)
    ad = AnnData(X=x)
    jpp.pca(ad, n_comps=10, zero_center=zero_center)
    emb, pcs, variance = tpp.pca(x, n_comps=10, zero_center=zero_center, device=CPU)
    assert emb.shape == (240, 10) and pcs.shape == (60, 10)
    for got, want in ((emb, ad.obsm["X_pca"]), (pcs, ad.varm["PCs"])):
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    if zero_center:
        np.testing.assert_allclose(variance, ad.uns["pca"]["variance"], rtol=1e-4)
    else:
        assert variance is None


def test_pca_transform_matches_jax():
    x, _, _ = _log_counts(seed=8)
    new = np.random.default_rng(8).random((30, 60)).astype(np.float32)
    res = tlinalg.pca(torch.from_numpy(x), 8)
    jres = jlinalg.PCAResult(*(np.asarray(a.numpy()) for a in res))
    np.testing.assert_allclose(tlinalg.pca_transform(new, res).numpy(),
                               np.asarray(jlinalg.pca_transform(new, jres)), rtol=1e-5,
                               atol=1e-5)


def test_gram_schmidt_gauss_proj_law():
    """The same law as JAX's (standard normals over sqrt(k)); the draws are a
    torch generator's, the same for the same seed."""
    proj = tlinalg.gram_schmidt_gauss_proj(torch.Generator().manual_seed(3), 400, 50)
    again = tlinalg.gram_schmidt_gauss_proj(torch.Generator().manual_seed(3), 400, 50)
    want = np.asarray(jlinalg.gram_schmidt_gauss_proj(jax.random.key(3), 400, 50))
    assert proj.shape == want.shape and proj.dtype == torch.float32 and torch.equal(proj, again)
    z = torch.randn((400, 50), generator=torch.Generator().manual_seed(3))
    assert torch.equal(proj, z / np.float32(np.sqrt(50)))
    assert abs(float(proj.std()) - float(want.std())) < 0.01 and abs(float(proj.mean())) < 0.01


# --------------------------------------------------------------------------
# regress-out and ComBat
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["one", "two", "constant"])
def test_regress_out_matches_jax(case):
    """Full-rank covariates and a rank-deficient one (a constant, collinear
    with the intercept: the minimum-norm solution)."""
    x, counts, _ = _log_counts(seed=9)
    rng = np.random.default_rng(9)
    covs = {"total": counts.sum(1), "pct": rng.random(len(x))}
    if case == "constant":
        covs["total"] = np.full(len(x), 3.0)
    keys = ["total", "pct"] if case == "two" else ["total"]
    ad = AnnData(X=x, obs=pd.DataFrame(covs))
    jpp.regress_out(ad, keys)
    got = tpp.regress_out(x, [covs[k] for k in keys], device=CPU)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ad.X, rtol=1e-10, atol=1e-10)
    if case == "constant":
        # the fit is each gene's mean m, split by the minimum-norm solution as
        # m / 10 on the intercept and 3 m / 10 on the constant 3: m / 10 is put back
        m = x.astype(np.float64).mean(0)
        np.testing.assert_allclose(got, x - m + m / 10, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sparse", [False, True])
def test_combat_matches_jax(sparse):
    """Three batches of different location and scale, a gene constant in one
    batch (its std 0 set to 1), float64 inside, float32 out."""
    x, _, _ = _log_counts(seed=10, sparse=sparse)
    rng = np.random.default_rng(10)
    batch = np.array(["p", "q", "r"])[rng.integers(0, 3, x.shape[0])]
    xd = tpp._dense(x).copy()
    xd[batch == "q"] = xd[batch == "q"] * 1.7 + 0.4
    xd[batch == "r", 5] = 2.0
    x = sp.csr_matrix(xd) if sparse else xd
    ad = AnnData(X=x, obs=pd.DataFrame({"batch": batch}))
    jpp.combat(ad, key="batch")
    got = tpp.combat(x, batch, device=CPU)
    assert got.dtype == np.float32 and got.shape == xd.shape
    np.testing.assert_allclose(got, ad.X, rtol=1e-10, atol=1e-10)


# --------------------------------------------------------------------------
# Scrublet and subsample
# --------------------------------------------------------------------------

def test_scrublet_matches_jax():
    _, counts, _ = _log_counts(n=200, seed=11)
    ad = AnnData(X=counts)
    jpp.scrublet(ad, random_state=4)
    score, predicted, thr = tpp.scrublet(counts, random_state=4, device=CPU)
    # the pairs: numpy's draws, as JAX makes them
    rng = np.random.default_rng(4)
    want_i1, want_i2 = rng.integers(0, 200, 400), rng.integers(0, 200, 400)
    i1, i2 = tpp.scrublet_pairs(200, 2.0, 4)
    np.testing.assert_array_equal(i1, want_i1)
    np.testing.assert_array_equal(i2, want_i2)
    # the same neighbour sets: JAX's embedding and kNN against the port's
    xd = counts.astype(np.float64)
    norm = np.log1p(xd / np.maximum(xd.sum(1, keepdims=True), 1e-12) * 1e4)
    sim = xd[i1] + xd[i2]
    sim = np.log1p(sim / np.maximum(sim.sum(1, keepdims=True), 1e-12) * 1e4)
    res = jlinalg.pca(norm.astype(np.float32), 30)
    emb = np.concatenate([np.asarray(res.embedding),
                          np.asarray(jlinalg.pca_transform(sim.astype(np.float32), res))])
    k_adj = int(round(max(int(round(0.5 * np.sqrt(200))), 3) * 3))
    jidx = jknn(emb, k_adj + 1)[1][:200]
    tres = tlinalg.pca(torch.from_numpy(norm.astype(np.float32)), 30)
    temb = torch.cat([tres.embedding, tlinalg.pca_transform(sim.astype(np.float32), tres)])
    tidx = tknn(temb.numpy(), k_adj + 1)[1][:200]
    # the same neighbours, and JAX's first the cell itself (JAX drops the first
    # column, the port the cell's own index)
    same = np.array([set(a) == set(b) and a[0] == r for r, (a, b) in enumerate(zip(jidx, tidx))])
    # elsewhere the lists hold points that coincide: the cells without counts,
    # and a cell and its doublets with one of them
    d = np.sqrt(((emb[:, None] - emb[None]) ** 2).sum(-1)) + np.eye(len(emb))
    twin = (d < 1e-2).any(1)
    for r in np.nonzero(~same)[0]:
        assert twin[np.union1d(jidx[r], tidx[r])].any(), r
    assert same.mean() > 0.85
    want = ad.obs["doublet_score"].to_numpy()
    np.testing.assert_allclose(score[same], want[same], rtol=1e-5, atol=1e-5)
    assert thr == max(np.percentile(score, 90), 0.3)
    np.testing.assert_array_equal(predicted, score > thr)
    assert predicted.dtype == bool and score.shape == (200,)


@pytest.mark.parametrize("kw", [{"fraction": 0.3}, {"n_obs": 57}])
def test_subsample_matches_jax(kw):
    x, _, types = _log_counts(seed=12)
    ad = AnnData(X=x, obs=pd.DataFrame({"t": types}))
    ad.obs_names = [f"c{i}" for i in range(len(x))]
    jpp.subsample(ad, random_state=7, **kw)
    idx, sub = tpp.subsample(x, random_state=7, **kw)
    np.testing.assert_array_equal(np.array([f"c{i}" for i in idx]), ad.obs_names.to_numpy())
    np.testing.assert_array_equal(sub, ad.X)


def test_new_entry_points_need_a_card_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.ones((6, 4), np.float32)
    for call in (lambda: tpp.combat(x, np.zeros(6)), lambda: tpp.regress_out(x, np.arange(6)),
                 lambda: tpp.pca(x, n_comps=2), lambda: tpp.scrublet(x),
                 lambda: tpp.calculate_qc_metrics(x, percent_top=(2,))):
        with pytest.raises(RuntimeError, match="device='auto'"):
            call()
