"""Port parity for dance_tpu_torch.transforms.normalize: ScTransform stage by
stage and whole, its analytic flavour, and the normalisation fronts.

Inputs are negative-binomial counts made with numpy from a seed (at most
300 cells x 200 genes); the JAX side runs on ``dance_tpu.data.AnnData``.
Tolerances, as the arithmetic allows:

- the Poisson GLM and θ: float32 on both sides, summed in other orders over
  the cells, so β within rtol 1e-3 and θ within rtol 1e-2 (1e-3 for one
  gene's; the Newton steps divide by a sum that cancels);
- the regularisation and the residuals from JAX's own step-1 parameters:
  float64 on both sides, rtol 1e-10;
- the whole transform: the residuals within 1e-3 absolute (of a clip at
  sqrt(n / 30) ~ 3), the parameters within rtol 1e-2, on inputs where no
  step-1 gene's robust score lies within 10 % of the outlier threshold, so
  a float32 gap cannot flip a flag (checked in the test);
- the step-1 draw: bit-equal (the same ``RandomState.choice`` call);
- the analytic residuals and the fronts: float32 rounding, rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from dance_tpu.data import AnnData, Data
from dance_tpu.transforms import normalize as J
from dance_tpu_torch.transforms import normalize as T
from torch_cases import nb_counts

CPU = torch.device("cpu")


def _glm_inputs(seed=0):
    x = nb_counts(200, 50, seed).astype(np.float64)
    umi = x.sum(1)
    return x, np.log10(np.maximum(umi, 1.0))


def test_poisson_glm_theta_matches_jax():
    x, log_umi = _glm_inputs()
    beta_j, theta_j = J._poisson_glm_theta(jnp.asarray(x, jnp.float32),
                                           jnp.asarray(log_umi, jnp.float32))
    beta_t, theta_t = T.poisson_glm_theta(torch.tensor(x, dtype=torch.float32),
                                          torch.tensor(log_umi, dtype=torch.float32))
    np.testing.assert_allclose(beta_t.numpy(), np.asarray(beta_j), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(theta_t.numpy(), np.asarray(theta_j), rtol=1e-2)


@pytest.mark.parametrize("limit", [2, 10])
def test_theta_ml_loop_semantics(limit):
    x, log_umi = _glm_inputs(1)
    y, mu = x[:, 3], np.full(x.shape[0], x[:, 3].mean())
    assert T.theta_ml(y, mu, limit=limit) == pytest.approx(J.theta_ml(y, mu, limit=limit),
                                                            rel=1e-3)


def _step1_record(monkeypatch):
    """Record the genes JAX's transform draws from numpy's global generator."""
    seen = []
    choice = np.random.choice

    def recording(*args, **kwargs):
        out = choice(*args, **kwargs)
        seen.append(np.sort(out))
        return out

    monkeypatch.setattr(np.random, "choice", recording)
    return seen


def _jax_sct(x, seed, monkeypatch, **kwargs):
    seen = _step1_record(monkeypatch)
    np.random.seed(seed)
    adata = AnnData(x.copy())
    J.ScTransform(**kwargs)(Data(adata))
    monkeypatch.undo()
    return adata, seen


def test_step1_draw_is_jax_bit_for_bit(monkeypatch):
    x = nb_counts()
    _, seen = _jax_sct(x, 7, monkeypatch, n_genes=100)
    keep = x.sum(0) >= 5
    log_gmean = np.log10(J.gmean(x[:, keep].astype(np.float64), axis=0, eps=1.0))
    np.testing.assert_array_equal(T.step1_genes(log_gmean, 100, random_state=7), seen[0])
    np.testing.assert_array_equal(T.step1_genes(log_gmean, 500), np.arange(keep.sum()))


def test_regularize_and_residuals_from_jax_params():
    x = nb_counts(seed=2).astype(np.float64)
    x = x[:, x.sum(0) >= 5]
    genes_log_gmean = np.log10(J.gmean(x, axis=0, eps=1.0))
    log_umi = np.log10(np.maximum(x.sum(1), 1.0))
    step1 = np.arange(0, x.shape[1], 2)
    beta, theta = J._poisson_glm_theta(jnp.asarray(x[:, step1], jnp.float32),
                                       jnp.asarray(log_umi, jnp.float32))
    gm1 = genes_log_gmean[step1]
    theta = np.maximum(np.asarray(theta, np.float64), 1e-7)
    pars = np.column_stack([np.asarray(beta, np.float64), np.log10(1 + 10 ** gm1 / theta)])
    # JAX's own arithmetic (normalize.py:192-207)
    bw = J._bw_silverman(gm1) * 3.0
    x_points = np.clip(genes_log_gmean, gm1.min(), gm1.max())
    full = np.column_stack([J._kernel_reg_ll(pars[:, j], gm1, x_points, bw) for j in range(3)])
    theta_full = np.maximum(10 ** genes_log_gmean / (10 ** full[:, 2] - 1), 1e-7)
    mu = np.exp(full[:, 0][None, :] + full[:, 1][None, :] * log_umi[:, None])
    resid = (x - mu) / np.sqrt(mu + mu ** 2 / theta_full[None, :])
    resid[x == 0] = 0.0
    resid[resid < 0] = 0.0
    resid = np.minimum(resid, np.sqrt(x.shape[0] / 30))

    full_t, theta_t = T.sct_regularize(torch.from_numpy(pars), gm1, genes_log_gmean, 3.0)
    np.testing.assert_allclose(full_t.numpy(), full, rtol=1e-10)
    np.testing.assert_allclose(theta_t.numpy(), theta_full, rtol=1e-10)
    resid_t = T.sct_residuals(torch.from_numpy(x), full_t, theta_t, torch.from_numpy(log_umi))
    np.testing.assert_allclose(resid_t.numpy(), resid, rtol=1e-10, atol=1e-12)
    for j in range(3):  # the outlier flags are the same host numpy
        np.testing.assert_array_equal(T.is_outlier(pars[:, j], gm1), J.is_outlier(pars[:, j],
                                                                                  gm1))


def _min_robust_scores(pars, x):
    """Each step-1 gene's smaller |robust score| over the two binnings,
    per parameter (normalize.py:280-290)."""
    bin_width = (x.max() - x.min()) * J._bw_silverman(x) / 2
    eps = np.finfo(float).eps * 10
    b1 = np.arange(x.min(), x.max() + bin_width, bin_width)
    b2 = np.arange(x.min() - eps - bin_width / 2, x.max() + bin_width, bin_width)
    return np.stack([np.abs(np.vstack([J.robust_scale_binned(pars[:, j], x, b1),
                                       J.robust_scale_binned(pars[:, j], x, b2)])).min(0)
                     for j in range(pars.shape[1])])


def test_whole_transform_matches_jax(monkeypatch):
    x = nb_counts(seed=3)
    adata, seen = _jax_sct(x, 11, monkeypatch, n_genes=120)
    keep = x.sum(0) >= 5
    xk = x[:, keep].astype(np.float64)
    gm1 = np.log10(J.gmean(xk, axis=0, eps=1.0))[seen[0]]
    beta, theta = J._poisson_glm_theta(jnp.asarray(xk[:, seen[0]], jnp.float32),
                                       jnp.asarray(np.log10(np.maximum(xk.sum(1), 1)),
                                                   jnp.float32))
    theta = np.maximum(np.asarray(theta, np.float64), 1e-7)
    pars = np.column_stack([np.asarray(beta, np.float64), np.log10(1 + 10 ** gm1 / theta)])
    scores = _min_robust_scores(pars, gm1)
    assert (np.abs(scores - 10) > 1.0).all(), "a step-1 gene lies near the outlier threshold"

    out = T.ScTransform(n_genes=120, random_state=11, device=CPU)(x)
    np.testing.assert_allclose(out["X"], np.asarray(adata.X), atol=1e-3)
    for key, vals in out["var"].items():
        want = np.asarray(adata.var[key], np.float64)
        np.testing.assert_array_equal(np.isnan(vals), np.isnan(want), err_msg=key)
        ok = ~np.isnan(want)
        np.testing.assert_allclose(vals[ok], want[ok], rtol=1e-2, atol=1e-6, err_msg=key)
    for key, vals in out["obs"].items():
        np.testing.assert_allclose(vals, np.asarray(adata.obs[key], np.float64), rtol=1e-12,
                                   err_msg=key)


def test_stage_seconds_recorded():
    sct = T.ScTransform(n_genes=40, device=CPU)
    sct(nb_counts(100, 60, seed=4))
    assert set(sct.seconds) == {"attributes", "glm_theta", "outliers", "regularize",
                                "residuals"}


def test_analytic_flavour_matches_jax():
    x = nb_counts(seed=5)
    x[:, :3] = 0
    x[:2, 1] = 4  # two cells: under min_cells, dropped
    adata = AnnData(x.copy())
    J.ScTransform(flavor="analytic")(Data(adata))
    out = T.ScTransform(flavor="analytic", device=CPU)(x)
    np.testing.assert_array_equal(out["genes_kept"], (x > 0).sum(0) >= 5)
    np.testing.assert_allclose(out["X"], np.asarray(adata.X), rtol=1e-5, atol=1e-5)


def test_sctransform_r_raises():
    with pytest.raises(NotImplementedError, match="rpy2"):
        T.ScTransformR()(nb_counts(10, 5))


@pytest.mark.parametrize("mode,axis", [("normalize", 0), ("standardize", 1), ("minmax", 0)])
def test_column_sum_normalize_by_batch(mode, axis):
    x = nb_counts(120, 30, seed=6)
    batches = np.array(["a", "b", "c"])[np.random.default_rng(6).integers(0, 3, 120)]
    adata = AnnData(x.copy(), obs=pd.DataFrame({"batch": batches}))
    J.ColumnSumNormalize(axis=axis, mode=mode, batch_key="batch")(Data(adata))
    got = T.ColumnSumNormalize(axis=axis, mode=mode, device=CPU)(x, batches)
    np.testing.assert_allclose(got, np.asarray(adata.X), rtol=1e-5, atol=1e-7)
    whole = AnnData(x.copy())
    J.ColumnSumNormalize(axis=axis, mode=mode)(Data(whole))
    np.testing.assert_allclose(T.ColumnSumNormalize(axis=axis, mode=mode, device=CPU)(x),
                               np.asarray(whole.X), rtol=1e-5, atol=1e-7)


def test_tfidf_and_scanpy_fronts():
    x = nb_counts(120, 30, seed=7)
    x[:, 0] += 1
    for jcls, tcls, kwargs in ((J.tfidfTransform, T.tfidfTransform, {"device": CPU}),
                               (J.NormalizeTotalLog1P, T.NormalizeTotalLog1P, {}),
                               (J.Log1P, T.Log1P, {}),
                               (J.NormalizePlaceHolder, T.NormalizePlaceHolder, {})):
        adata = AnnData(x.copy())
        jcls()(Data(adata))
        np.testing.assert_allclose(tcls(**kwargs)(x), np.asarray(adata.X), rtol=1e-5,
                                   atol=1e-7, err_msg=jcls.__name__)
    adata = AnnData(x.copy())
    J.NormalizeTotal(target_sum=1e4, max_fraction=1.0)(Data(adata))
    np.testing.assert_allclose(T.NormalizeTotal(target_sum=1e4, max_fraction=1.0)(x),
                               np.asarray(adata.X), rtol=1e-6)
    adata = AnnData(x.copy())
    J.UpdateSizeFactors()(Data(adata))
    n_counts, sf = T.UpdateSizeFactors()(x)
    np.testing.assert_array_equal(n_counts, adata.obs["n_counts"].to_numpy())
    np.testing.assert_array_equal(sf, adata.obs["size_factors"].to_numpy())


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: 'auto' resolves")
    with pytest.raises(RuntimeError, match="device='auto'"):
        T.ScTransform(n_genes=None)(nb_counts(20, 10))
