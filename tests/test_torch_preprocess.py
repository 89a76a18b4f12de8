"""Port parity for scDeepSort's preprocessing: PCA and weighted_feature_pca.

Inputs are made with numpy from a seed. Both sides apply sklearn's sign
convention, so results compare directly: within 1e-4 (float32 SVDs from two
LAPACK call paths) for the exact solver, and against the exact SVD for the
randomized one, whose random test matrices differ between the packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dance_tpu.ops.linalg import pca as jpca
from dance_tpu_torch.ops.linalg import pca, randomized_svd
from dance_tpu_torch.transforms import weighted_feature_pca


def _low_rank(n, m, rank, seed, noise=1e-3):
    rng = np.random.default_rng(seed)
    spectrum = np.geomspace(10.0, 1.0, rank)
    u, _ = np.linalg.qr(rng.standard_normal((n, rank)))
    v, _ = np.linalg.qr(rng.standard_normal((m, rank)))
    x = (u * spectrum) @ v.T + noise * rng.standard_normal((n, m))
    return x.astype(np.float32)


@pytest.mark.parametrize("shape,k", [((40, 12), 5), ((30, 50), 8)])
def test_pca_exact_matches_jax(shape, k):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    j = jpca(jnp.asarray(x), k)
    t = pca(torch.from_numpy(x), k)
    for name in ("embedding", "components", "mean", "explained_variance"):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_randomized_svd_matches_exact():
    x = torch.from_numpy(_low_rank(300, 200, 12, 0))
    ue, se, vte = randomized_svd(x, 10, solver="exact")
    ur, sr, vtr = randomized_svd(x, 10, solver="randomized", seed=3)
    np.testing.assert_allclose(sr.numpy(), se.numpy(), rtol=1e-4)
    np.testing.assert_allclose(vtr.numpy(), vte.numpy(), atol=1e-3)
    np.testing.assert_allclose(ur.numpy(), ue.numpy(), atol=1e-3)


def test_pca_randomized_path_matches_jax():
    """Above 1024 on the short side both packages take the randomized solver,
    as scDeepSort's gene PCA does at bench size (2,000 genes)."""
    x = _low_rank(1100, 1030, 6, 1)
    j = jpca(jnp.asarray(x), 5)
    t = pca(torch.from_numpy(x), 5)
    np.testing.assert_allclose(t.explained_variance.numpy(), np.asarray(j.explained_variance),
                               rtol=1e-4)
    np.testing.assert_allclose(t.embedding.numpy(), np.asarray(j.embedding), atol=1e-3)


def test_weighted_feature_pca_matches_jax():
    from dance_tpu.data import AnnData, Data
    from dance_tpu.transforms import WeightedFeaturePCA

    rng = np.random.default_rng(0)
    x = rng.poisson(2.0, size=(60, 30)).astype(np.float32)
    x[x < 1] = 0
    x[5] = 0  # a cell with no expression keeps a zero feature
    data = Data(AnnData(X=x.copy(), obs={"cell_type": rng.choice(list("abc"), 60)}),
                train_size=40)
    WeightedFeaturePCA(n_components=8, split_name="train")(data)
    cell_feat, gene_feat = weighted_feature_pca(data.get_x("train"), x, 8, device="cpu")
    assert cell_feat.dtype == gene_feat.dtype == np.float32
    np.testing.assert_allclose(gene_feat, data.data.varm["WeightedFeaturePCA"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(cell_feat, data.data.obsm["WeightedFeaturePCA"], rtol=1e-4,
                               atol=1e-4)
    assert not cell_feat[5].any()


def test_weighted_feature_pca_sparse_input_and_clipping():
    x = sp.random(20, 12, density=0.4, random_state=0, format="csr", dtype=np.float32)
    cell_dense, gene_dense = weighted_feature_pca(x.toarray(), x.toarray(), 50, device="cpu")
    cell_sparse, gene_sparse = weighted_feature_pca(x, x, 50, device="cpu")
    assert gene_dense.shape == (12, 12) and cell_dense.shape == (20, 12)
    np.testing.assert_array_equal(cell_sparse, cell_dense)
    np.testing.assert_array_equal(gene_sparse, gene_dense)
