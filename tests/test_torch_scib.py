"""Port parity for the scIB joint-embedding suite (dance_tpu_torch.utils.
scib_metrics, utils.metrics.integration_openproblems_evaluate) and the NMI
averages (dance_tpu_torch.utils.nmi), against the JAX package's suite and
scikit-learn, on embeddings made with numpy from a seed.

Tolerances: the silhouettes within 1e-6 of sklearn's (the port's on torch,
float64 sums), NMI within 1e-12 of sklearn's, the Louvain NMI sweep and
graph connectivity exactly (same kNN graph, same C++ Louvain), cell-cycle
conservation at 1e-4 (its PCA, float32), the diffusion pseudotime and the
trajectory score at 1e-4 (200 float32 power iterations).
"""

import numpy as np
import pytest
from sklearn.metrics import normalized_mutual_info_score
from sklearn.metrics import silhouette_samples as sk_silhouette_samples

from dance_tpu.utils import metrics as jmetrics
from dance_tpu.utils import scib_metrics as J
from dance_tpu_torch.utils import metrics as tmetrics
from dance_tpu_torch.utils import nmi
from dance_tpu_torch.utils import scib_metrics as T


def _emb(n=240, d=8, k=4, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    types = rng.integers(0, k, n)
    emb = rng.normal(size=(n, d))
    emb[:, 0] += 1.5 * types
    emb[:, 1] += np.linspace(0, 3, n)  # a trajectory along the cells' order
    batch = rng.integers(0, 2, n)
    return emb.astype(dtype), types, batch


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_silhouette_samples_match_sklearn(dtype):
    emb, types, _ = _emb(dtype=dtype)
    types[[3, 50]] = [7, 8]  # two one-cell clusters: their cells score 0
    got = T.silhouette_samples(emb, types, chunk=64, device="cpu")
    want = sk_silhouette_samples(emb, types)
    assert got.dtype == np.float64 and got[3] == 0.0 == got[50]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="Number of labels"):
        T.silhouette_samples(emb[:3], [0, 1, 2], device="cpu")


def test_silhouette_label_and_batch_match_jax():
    emb, types, batch = _emb(seed=1)
    assert T.silhouette_label(emb, types, device="cpu") == \
        pytest.approx(J.silhouette_label(emb, types), abs=1e-6)
    types[7] = 9  # a one-cell type is skipped by the batch score
    assert T.silhouette_batch(emb, batch, types, device="cpu") == \
        pytest.approx(J.silhouette_batch(emb, batch, types), abs=1e-6)
    assert np.isnan(T.silhouette_batch(emb, np.zeros(len(emb)), types, device="cpu"))


@pytest.mark.parametrize("average_method", ["arithmetic", "max"])
def test_nmi_averages_match_sklearn(average_method):
    rng = np.random.default_rng(2)
    a, b = rng.integers(0, 5, 300), rng.integers(0, 3, 300)
    b[:100] = a[:100] % 3
    assert nmi(a, b, average_method=average_method) == pytest.approx(
        normalized_mutual_info_score(a, b, average_method=average_method), abs=1e-12)
    assert nmi(a, a, average_method=average_method) == pytest.approx(1.0)
    assert nmi(np.zeros(5), np.zeros(5), average_method=average_method) == 1.0
    with pytest.raises(ValueError, match="average_method"):
        nmi(a, b, average_method="geometric")


def test_louvain_nmi_and_connectivity_match_jax():
    emb, types, _ = _emb(seed=3)
    assert T.nmi_opt_louvain(emb, types) == J.nmi_opt_louvain(emb, types)
    res = np.array([0.2, 1.0])
    assert T.nmi_opt_louvain(emb, types, k=8, resolutions=res) == \
        J.nmi_opt_louvain(emb, types, k=8, resolutions=res)
    types[0] = 9  # a one-cell type counts as connected
    assert T.graph_connectivity(emb, types, k=5) == J.graph_connectivity(emb, types, k=5)


def test_cell_cycle_conservation_matches_jax():
    emb, _, batch = _emb(seed=4)
    rng = np.random.default_rng(4)
    s, g2m = rng.normal(size=len(emb)), rng.normal(size=len(emb))
    pre = (emb @ rng.normal(size=(8, 12))).astype(np.float32)
    pre[:, :2] += np.stack([s, g2m], 1)
    for b in (batch, None):
        assert T.cell_cycle_conservation(pre, emb, s, g2m, b, device="cpu") == pytest.approx(
            J.cell_cycle_conservation(pre, emb, s, g2m, b), abs=1e-4)
    assert T._pcr(pre, s, device="cpu") == pytest.approx(J._pcr(pre, s), abs=1e-4)


def test_pseudotime_and_trajectory_match_jax():
    emb, _, _ = _emb(seed=5)
    got = T.diffusion_pseudotime(emb, device="cpu")
    np.testing.assert_allclose(got, J.diffusion_pseudotime(emb), rtol=0, atol=1e-4)
    assert got.min() == 0.0 and got.max() == pytest.approx(1.0)
    np.testing.assert_allclose(T.diffusion_pseudotime(emb, root=10, k=8, device="cpu"),
                               J.diffusion_pseudotime(emb, root=10, k=8), rtol=0, atol=1e-4)
    pt = np.linspace(0, 1, len(emb))
    pt[:5] = np.nan  # non-finite entries are left out
    assert T.trajectory_conservation(emb, pt, device="cpu") == pytest.approx(
        J.trajectory_conservation(emb, pt), abs=1e-4)
    assert np.isnan(T.trajectory_conservation(emb[:9], pt[5:14], device="cpu"))


def test_openproblems_suite_matches_jax():
    emb, types, batch = _emb(seed=6)
    rng = np.random.default_rng(6)
    extra = dict(emb_pre=(emb @ rng.normal(size=(8, 10))).astype(np.float32),
                 s_score=rng.normal(size=len(emb)), g2m_score=rng.normal(size=len(emb)),
                 pseudotime=np.linspace(0, 1, len(emb)))
    got = tmetrics.integration_openproblems_evaluate(emb, types, batch, device="cpu", **extra)
    want = jmetrics.integration_openproblems_evaluate(emb, types, batch, **extra)
    assert list(got) == list(want) == ["asw_label", "asw_batch", "nmi", "graph_conn",
                                       "cc_cons", "ti_cons", "final_scores"]
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-4), key
    # without a second batch or the extra inputs, those metrics are left out
    short = T.integration_openproblems_suite(emb, types, np.zeros(len(emb)), device="cpu")
    assert list(short) == ["asw_label", "nmi", "graph_conn", "final_scores"]
    assert short["final_scores"] == pytest.approx(np.mean([short["asw_label"], short["nmi"],
                                                           short["graph_conn"]]))
