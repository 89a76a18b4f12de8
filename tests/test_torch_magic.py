"""Port parity for MAGIC (dance_tpu_torch.modules.single_modality.
imputation.magic): the class's diffusion, the functional API and the front.

Inputs are made with numpy from a seed (``torch_cases.typed_counts``) and
handed to both packages; JAX's ``MAGIC._impute`` is its compiled program.
Tolerances: the imputations at 1e-5 of the largest value (float32 distances,
three products with the row-stochastic P, a percentile ratio); the
percentiles at rtol 1e-6; the Markov matrix and the matrix powers at rtol
1e-5; the kNN mask, ``optimal_t`` and the front exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dance_tpu.data import AnnData, Data
from dance_tpu.modules.single_modality.imputation import magic as J
from dance_tpu_torch.modules.single_modality.imputation import magic as T
from torch_cases import typed_counts

CPU = torch.device("cpu")


def _x(seed=0, n=120, g=40):
    counts = typed_counts(n=n, g=g, seed=seed)[0]
    return np.log1p(counts).astype(np.float32)


def _close_scaled(got, want, rel=1e-5, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    gap = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert gap <= rel, f"{name}: gap {gap} of the largest value"


@pytest.mark.parametrize("kw", [{}, {"t": 2, "k": 6, "ka": 2, "epsilon": 2.0},
                                {"rescale": 0}], ids=["defaults", "small_k", "no_rescale"])
def test_impute_matches_jax(kw):
    x = _x()
    got = T.MAGIC(device=CPU, **kw).fit(x).predict()
    want = J.MAGIC(**kw).fit(x).predict()
    _close_scaled(got, want)


def test_masked_fit_and_ties_match_jax():
    """The mask multiplies the input; duplicated cells put ties at the k-th
    distance, and every cell within it stays a neighbour."""
    x = _x(seed=1)
    x[40:50] = x[30]  # ten copies of one cell: eleven at distance 0
    mask = np.random.default_rng(2).random(x.shape) > 0.1
    got = T.MAGIC(device=CPU).fit(x, mask=mask).predict()
    want = J.MAGIC().fit(x, mask=mask).predict()
    _close_scaled(got, want)
    # the tie rule itself: row 30 keeps all 11 cells at distance 0 with k = 4
    m = T.MAGIC(k=4, ka=2, rescale=0, t=1, device=CPU)
    eye = torch.eye(x.shape[0])
    p = m._impute(eye)  # P @ I = P
    assert int((p[30] > 0).sum()) >= 11
    _close_scaled(p.numpy(), np.asarray(J.MAGIC(k=4, ka=2, rescale=0, t=1)._impute(
        jnp.eye(x.shape[0]))))
    assert T.MAGIC(device=CPU).predict(x).shape == x.shape


def test_percentile_matches_jnp():
    x = np.random.default_rng(3).random((37, 5)).astype(np.float32)
    for q in (0, 1, 50, 99, 100):
        np.testing.assert_allclose(T.percentile(torch.tensor(x), q).numpy(),
                                   np.asarray(jnp.percentile(x, q, axis=0)), rtol=1e-6)


def test_functional_api_matches_jax(monkeypatch):
    """compute_markov's host assembly, impute_fast with and without the warm
    start and rescale, magic and optimal_t. The port's kNN (held against
    JAX's in test_torch_stagate.py) computes its float32 distances in
    another order, which can swap neighbours tied at the k-th distance to
    rounding; JAX's neighbours are handed in, so the Markov matrices are
    compared on the same graph."""
    import dance_tpu.ops.neighbors as jnb

    monkeypatch.setattr(T, "knn", lambda d, k, include_self: tuple(
        np.asarray(a) for a in jnb.knn(d, k, include_self=include_self)))
    x = _x(seed=4, n=90)
    emb = x[:, :10]
    for kw in ({"k": 8, "ka": 3}, {"k": 5, "ka": 0, "epsilon": 0}):
        got, want = T.compute_markov(emb, **kw), J.compute_markov(emb, **kw)
        np.testing.assert_allclose(got.toarray(), want.toarray(), rtol=1e-5, atol=1e-7)
    L = J.compute_markov(emb, k=8, ka=3)
    for t, rescale in ((3, 99), (2, 0)):
        got, Lt = T.impute_fast(x, L, t, rescale, device=CPU)
        want, jLt = J.impute_fast(x, L, t, rescale)
        _close_scaled(got, want)
        _close_scaled(Lt, jLt)
    got, _ = T.impute_fast(x, L, 5, 99, L_t=Lt, tprev=2, device=CPU)
    want, _ = J.impute_fast(x, L, 5, 99, L_t=jLt, tprev=2)
    _close_scaled(got, want)
    neg = x - 1.0  # negative values: the rescale is skipped with a warning
    _close_scaled(T.impute_fast(neg, L, 2, 99, device=CPU)[0], J.impute_fast(neg, L, 2, 99)[0])
    _close_scaled(T.magic(x, emb, t=2, k=6, ka=2, device=CPU), J.magic(x, emb, t=2, k=6, ka=2))
    assert T.optimal_t(x) == J.optimal_t(x)
    assert T.optimal_t(x, th=1e-9, max_t=4) == J.optimal_t(x, th=1e-9, max_t=4)
    with pytest.raises(ValueError, match="euclidean"):
        T.compute_markov(emb, distance_metric="cosine")


@pytest.mark.parametrize("mask", [True, False])
def test_magic_preprocess_matches_jax(mask):
    """The gene and cell filters, the raw counts, normalize_total(1e4),
    log1p and the masks against the JAX Compose on a Data container."""
    counts = typed_counts(seed=5)[0].astype(np.float32)
    counts[:, 2] = 0
    counts[5] = 0
    data = Data(AnnData(counts.copy(), obs={"idx": np.arange(len(counts))},
                        var={"gidx": np.arange(counts.shape[1])}))
    J.MAGIC.preprocessing_pipeline(seed=3, mask=mask, log_level="WARNING")(data)
    inp = T.magic_preprocess(counts, seed=3, mask=mask)
    ad = data.data
    np.testing.assert_array_equal(inp.cells, ad.obs["idx"].to_numpy())
    np.testing.assert_array_equal(inp.genes, ad.var["gidx"].to_numpy())
    np.testing.assert_allclose(inp.x, ad.X, rtol=1e-6)
    np.testing.assert_array_equal(inp.x_raw, ad.raw.X)
    if mask:
        for name in ("train_mask", "valid_mask", "test_mask"):
            np.testing.assert_array_equal(getattr(inp, name), ad.layers[name], err_msg=name)
    else:
        assert inp.train_mask.all() and not inp.valid_mask.any()
    sparse = T.magic_preprocess(sp.csr_matrix(counts), seed=3, mask=mask)
    np.testing.assert_array_equal(sparse.x, inp.x)
    # the front is the container pipeline, which prints JAX's digest
    assert T.MAGIC.preprocessing_pipeline(seed=3, mask=mask).hexdigest() == \
        J.MAGIC.preprocessing_pipeline(seed=3, mask=mask).hexdigest()


def test_device_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.MAGIC()
