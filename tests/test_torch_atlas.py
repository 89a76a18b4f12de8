"""The atlas similarity of the port (dance_tpu_torch.atlas) against the JAX
package's (dance_tpu.atlas) on a seeded pair of count datasets that share
some cell types and some genes, on the CPU.

Tolerances: the common genes of ``filter_gene`` exactly; the sampled cells
and the sampled metrics (cosine, Pearson, Jaccard, Jensen-Shannon: host
numpy float64 in both) within 1e-12; the Bures and spectral distances
(float64, torch's eigh/SVD against numpy's) at rtol 1e-6; the float32
pairwise metrics (MMD, the two Sinkhorn costs, Hausdorff, Chamfer, energy:
sums in another order) at rtol 1e-4.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from dance_tpu.atlas.sc_similarity import anndata_similarity as JA
from dance_tpu.data import AnnData as JAnnData
from dance_tpu_torch.atlas.sc_similarity import anndata_similarity as TA
from dance_tpu_torch.data import AnnData, Frame

CPU = torch.device("cpu")
F32 = ("mmd", "wasserstein", "hausdorff", "chamfer", "energy", "sinkhorn2")
F64 = ("bures", "spectral")
SAMPLED = ("cosine", "pearson", "jaccard", "js_distance")


def _counts(n, genes, types, seed):
    rng = np.random.default_rng(seed)
    programs = rng.gamma(0.8, 1.0, (6, genes.size)) * (rng.random((6, genes.size)) < 0.5)
    labels = rng.choice(types, n)
    depth = rng.gamma(4.0, 0.5, (n, 1))
    x = rng.poisson((programs[labels] + 0.05) * depth).astype(np.float32)
    obs = {"n_umi": x.sum(1), "tissue": np.array(["blood", "bone"])[rng.integers(0, 2, n)]}
    return x, obs


def _pair():
    genes = np.array([f"G{k}" for k in range(400)])
    x1, o1 = _counts(180, genes, [0, 1, 2, 3], seed=0)
    x2, o2 = _counts(140, genes, [2, 3, 4, 5], seed=1)
    keep2 = np.r_[0:300, 320:400]  # 20 genes only in the first
    out = []
    for x, obs, names in ((x1, o1, genes), (x2[:, keep2], o2, genes[keep2])):
        j = JAnnData(x.copy(), obs=pd.DataFrame(obs))
        j.var_names = pd.Index(names.astype(object))
        t = AnnData(x.copy(), obs=Frame(obs))
        t.var_names = names
        out.append((j, t))
    return out


@pytest.fixture(scope="module")
def sims():
    (j1, t1), (j2, t2) = _pair()
    js = JA.AnnDataSimilarity(j1, j2, sample_size=100, init_random_state=3, n_runs=2)
    ts = TA.AnnDataSimilarity(t1, t2, sample_size=100, init_random_state=3, n_runs=2,
                              device=CPU)
    js.filter_gene(n_top_genes=150)
    ts.filter_gene(n_top_genes=150)
    return js, ts


def test_filter_gene(sims):
    js, ts = sims
    assert ts.common_genes == js.common_genes
    assert 0 < len(ts.common_genes) < 150
    np.testing.assert_array_equal(ts.adata1.X, js.adata1.X)
    np.testing.assert_array_equal(ts.adata2.X, js.adata2.X)
    # fewer genes than asked: the plain intersection, as JAX
    (j1, t1), (j2, t2) = _pair()
    assert TA.AnnDataSimilarity(t1, t2, device=CPU).common_genes == \
        JA.AnnDataSimilarity(j1, j2).common_genes


@pytest.mark.parametrize("metric", SAMPLED + F32 + F64)
def test_metric(sims, metric):
    js, ts = sims
    jx1, jx2 = js.sample_cells(5)
    tx1, tx2 = ts.sample_cells(5)
    np.testing.assert_allclose(tx1, jx1, rtol=1e-12)
    np.testing.assert_allclose(tx2, jx2, rtol=1e-12)
    names = {"cosine": "cosine_sim_sampled", "pearson": "pearson_corr_sampled",
             "jaccard": "jaccard_sim_sampled", "js_distance": "js_divergence_sampled",
             "mmd": "compute_mmd", "wasserstein": "wasserstein_dist",
             "hausdorff": "get_Hausdorff", "chamfer": "chamfer_distance",
             "energy": "energy_distance_metric", "sinkhorn2": "get_sinkhorn2",
             "bures": "bures_distance", "spectral": "spectral_distance"}
    got = getattr(ts, names[metric])(tx1, tx2)
    want = getattr(js, names[metric])(jx1, jx2)
    rtol = 1e-4 if metric in F32 else 1e-6 if metric in F64 else 1e-12
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=rtol)


def test_compute_similarity(sims):
    js, ts = sims
    methods = list(SAMPLED + F32 + F64) + ["metadata_sim", "common_genes_num"]
    got, want = ts.compute_similarity(methods), js.compute_similarity(methods)
    assert list(got) == list(want)
    for m in methods:
        rtol = 1e-4 if m in F32 else 1e-6 if m in F64 else 1e-12
        np.testing.assert_allclose(got[m], want[m], rtol=rtol, err_msg=m)
    assert ts.get_dataset_meta_sim() == js.get_dataset_meta_sim()
    # the default method list
    assert list(ts.compute_similarity()) == list(js.compute_similarity())


def test_pdist2_full_float32():
    # TF32 or not, the squared distances are full float32 products
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((50, 30)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((40, 30)).astype(np.float32))
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    matmul.allow_tf32 = True
    try:
        d = TA.pdist2(x, y)
        assert matmul.allow_tf32  # the caller's flag, restored
    finally:
        matmul.allow_tf32 = prev
    want = ((x.double()[:, None] - y.double()[None]) ** 2).sum(-1)
    np.testing.assert_allclose(d.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(JA._pdist2(x.numpy(), y.numpy())), d.numpy(), rtol=1e-5, atol=1e-4)
