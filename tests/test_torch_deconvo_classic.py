"""Port parity for the classical deconvolution methods and what they stand
on: NMF and NNLS (dance_tpu_torch.ops.nmf), SPOTlight, SpatialDecon and
CARD (dance_tpu_torch.modules.spatial.cell_type_deconvo), the common-gene
filter, Giotto's profiles and the cell counts (dance_tpu_torch.transforms),
and the Pearson and Spearman distances (dance_tpu_torch.utils.matrix).

Inputs are made with numpy from a seed, as the JAX deconvolution cases make
them at a small size (reference cells with marker genes, spots as Poisson
mixtures at Dirichlet portions with coordinates); JAX's NMF starts are
handed to the port through a patched ``init_factors``. CARD starts from the
same numpy Dirichlet draw in both packages.
Tolerances: one NMF or CAR iteration and the transforms at rtol 1e-5;
fixed-length fits (100 multiplicative-update or CAR iterations, 400 Adam
steps) at 1e-4 of the largest value, float32 rounding carried through the ratios; the
converged CARD run (``epsilon`` 1e-4) within 1e-3 of the largest portion
and its iteration count within one, since near ``epsilon`` the stop can
fall one iteration apart; the gene lists and their order exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import dance_tpu.ops.nmf as JN
from dance_tpu.data import AnnData, Data
from dance_tpu.modules.spatial.cell_type_deconvo import card as jcard
from dance_tpu.modules.spatial.cell_type_deconvo import spatialdecon as jsd
from dance_tpu.modules.spatial.cell_type_deconvo import spotlight as jspot
from dance_tpu.transforms import pseudobulk as jpb
from dance_tpu.transforms.filter import FilterGenesCommon as JCommon
from dance_tpu.utils import matrix as jmatrix
import dance_tpu_torch.ops.nmf as TN
from dance_tpu_torch.modules.spatial.cell_type_deconvo import card as tcard
from dance_tpu_torch.modules.spatial.cell_type_deconvo import spatialdecon as tsd
from dance_tpu_torch.modules.spatial.cell_type_deconvo import spotlight as tspot
from dance_tpu_torch.transforms import (CellGiottoTopicProfile, CellTypeNums, FilterGenesCommon,
                                        get_giotto_dt)
from dance_tpu_torch.utils import matrix as tmatrix

CPU = torch.device("cpu")
N_TYPES = 4


def deconvo_case(n_ref=160, n_genes=60, n_spots=120, seed=0, alpha=1.0):
    """Reference cells and spots as the JAX package's deconvolution cases
    make them (benchmarks/matrix.py:750-757), small, the portions drawn
    from Dirichlet(``alpha``): (x_ref, labels, x_spots, portions, coords,
    profiles)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, N_TYPES, n_ref)
    rates = np.tile(rng.gamma(2.0, 0.5, n_genes), (n_ref, 1))
    for t in range(N_TYPES):
        markers = rng.choice(n_genes, n_genes // 10, replace=False)
        rates[np.ix_(np.nonzero(labels == t)[0], markers)] *= 4.0
    x_ref = rng.poisson(rates * rng.lognormal(0, 0.3, n_ref)[:, None]).astype(np.float32)
    profiles = np.stack([x_ref[labels == t].mean(0) for t in range(N_TYPES)])
    portions = rng.dirichlet(np.full(N_TYPES, alpha), n_spots)
    x_spots = rng.poisson(portions @ profiles * 3).astype(np.float32)
    coords = (rng.random((n_spots, 2)) * 100).astype(np.float32)
    return x_ref, np.array([f"ct{t}" for t in labels]), x_spots, portions, coords, profiles


def _jax_init(V, n_components, seed):
    """JAX's NMF starts (nmf.py:56-62), as tensors."""
    V = jnp.asarray(np.asarray(V.cpu() if isinstance(V, torch.Tensor) else V), jnp.float32)
    n, m = V.shape
    scale = jnp.sqrt(V.mean() / n_components)
    k1, k2 = jax.random.split(jax.random.key(seed))
    W = scale * jnp.abs(jax.random.normal(k1, (n, n_components)))
    H = scale * jnp.abs(jax.random.normal(k2, (n_components, m)))
    return torch.tensor(np.asarray(W)), torch.tensor(np.asarray(H))


def _close_scaled(got, want, rel=1e-4, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    gap = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert gap <= rel, f"{name}: gap {gap} of the largest value"


def test_nmf_matches_jax(monkeypatch):
    """One and 100 multiplicative updates from JAX's starts, then W fixed,
    and nnls with one and several right-hand sides."""
    monkeypatch.setattr(TN, "init_factors", _jax_init)
    x_ref = deconvo_case()[0]
    V = x_ref.T
    for n_iter, rel in ((1, 1e-5), (100, 1e-4)):
        got, want = TN.nmf(V, 5, n_iter=n_iter, seed=2, device=CPU), JN.nmf(V, 5, n_iter=n_iter,
                                                                           seed=2)
        _close_scaled(got.W.numpy(), want.W, rel, "W")
        _close_scaled(got.H.numpy(), want.H, rel, "H")
        np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=rel)
    W = np.abs(np.random.default_rng(1).normal(size=(V.shape[0], 5))).astype(np.float32)
    got = TN.nmf(V, 5, n_iter=100, W_init=W, W_fixed=True, device=CPU)
    want = JN.nmf(V, 5, n_iter=100, W_init=W, W_fixed=True)
    np.testing.assert_array_equal(got.W.numpy(), W)
    _close_scaled(got.H.numpy(), want.H, name="H fixed W")
    h0 = np.asarray(_jax_init(V, 5, 0)[1])
    _close_scaled(TN.nnls(W, V, 50, x_init=h0, device=CPU).numpy(), JN.nnls(W, V, 50), name="nnls")
    h1 = np.asarray(_jax_init(V[:, :1], 5, 0)[1])[:, 0]  # JAX draws a (5, 1) start
    _close_scaled(TN.nnls(W, V[:, 0], 50, x_init=h1, device=CPU).numpy(),
                  JN.nnls(W, V[:, 0], 50), name="nnls 1-d")


def test_nmf_own_starts_are_seeded():
    V = torch.tensor(deconvo_case()[0].T)
    W, H = TN.init_factors(V, 3, 0)
    W2, H2 = TN.init_factors(V, 3, 0)
    assert torch.equal(W, W2) and torch.equal(H, H2) and float(W.min()) >= 0
    scale = float(torch.sqrt(V.mean() / 3))
    assert float(H.mean()) == pytest.approx(scale * np.sqrt(2 / np.pi), rel=0.1)


def test_spotlight_matches_jax(monkeypatch):
    """The reference NMF from the median profiles (rank = the types; a random
    start is test_nmf_matches_jax's), the topic profiles and the two
    fixed-basis regressions, 100 iterations each; score with
    valid_idx/test_idx; the projected-gradient NNLS class."""
    monkeypatch.setattr(TN, "init_factors", _jax_init)
    x_ref, labels, x_spots, portions, _, _ = deconvo_case()
    cts = [f"ct{t}" for t in range(N_TYPES)]
    jm = jspot.SPOTlight(x_ref, labels, cts, rank=N_TYPES).fit(x_spots, max_iter=100)
    tm = tspot.SPOTlight(x_ref, labels, cts, rank=N_TYPES, device=CPU).fit(x_spots, max_iter=100)
    for name in ("W", "H", "B", "P"):
        _close_scaled(getattr(tm, name), getattr(jm, name), name=name)
    _close_scaled(tm.predict(), jm.predict(), name="portions")
    valid, test = np.arange(0, 60), np.arange(60, 120)
    got = tm.score(None, portions, valid_idx=valid, test_idx=test)
    want = jm.score(None, portions, valid_idx=valid, test_idx=test)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(tm.score(None, portions), jm.score(None, portions), rtol=1e-4)
    rng = np.random.default_rng(3)
    xa, wa = rng.random((50, 6)).astype(np.float32), rng.random((4, 6)).astype(np.float32)
    ya = xa @ wa.T
    jn = jspot.NNLS(6, 4).fit(xa, ya, max_iter=200, lr=0.05)
    tn = tspot.NNLS(6, 4, device=CPU).fit(xa, ya, max_iter=200, lr=0.05)
    _close_scaled(tn.weight, jn.weight, name="NNLS")
    np.testing.assert_allclose(tn(xa), jn(xa), rtol=1e-4, atol=1e-6)
    assert (tn.weight >= 0).all()


@pytest.mark.parametrize("bias", [False, True])
def test_spatialdecon_matches_jax(bias):
    """Adam on MSLE with the weights clamped at 0 after every step: the
    clamped weights' halved gradient at 0 (JAX's maximum, torch's) over 400
    steps at lr 1e-2, as the benchmark case sets it. Sparse portions
    (Dirichlet 0.2) drive the absent types' weights onto the clamp."""
    x_ref, labels, x_spots, portions, _, _ = deconvo_case(seed=1, alpha=0.2)
    profile, cts = tsd.spatialdecon_preprocess(x_ref, labels)
    want_profile = jpb.get_ct_profile(x_ref, labels, ct_select=cts, method="median")
    np.testing.assert_allclose(profile, want_profile, rtol=1e-6)
    jm = jsd.SpatialDecon(profile, cts, bias=bias).fit(x_spots, lr=1e-2, max_iter=400)
    tm = tsd.SpatialDecon(profile, cts, bias=bias, device=CPU).fit(x_spots, lr=1e-2, max_iter=400)
    assert (jm.weights == 0).any()  # some weights sit on the clamp
    _close_scaled(tm.weights, jm.weights, name="weights")
    _close_scaled(tm.predict(), jm.predict(), name="portions")
    np.testing.assert_allclose(tm.score(None, portions), jm.score(None, portions), rtol=1e-4)
    assert len(tm.history) == 4
    pred, true = np.abs(x_spots[:5]), x_spots[5:10]
    np.testing.assert_allclose(tsd.MSLELoss()(pred, true), jsd.MSLELoss()(pred, true), rtol=1e-6)
    w = torch.zeros(3, requires_grad=True)
    torch.maximum(w, torch.zeros(())).sum().backward()
    assert w.grad.tolist() == [0.5] * 3  # the halved gradient at the clamp


def _card_inputs(seed=2):
    x_ref, labels, x_spots, portions, coords, profiles = deconvo_case(seed=seed)
    x_norm = np.asarray(jmatrix.normalize(np.asarray(x_spots, np.float64), axis=1,
                                          mode="normalize"))
    x_norm = x_norm * 0.1 / x_norm.mean()
    basis = profiles.T.astype(np.float64)
    b_mat = (basis * 0.1 / basis.mean()).astype(np.float32)
    V0 = np.random.default_rng(42).dirichlet(np.repeat(10, N_TYPES), len(x_spots))
    return x_spots, coords, portions, profiles, x_norm.T.astype(np.float32), b_mat, \
        V0.astype(np.float32)


def test_card_kernel_matches_jax():
    """The Gaussian kernel of the scaled coordinates, zero on the diagonal.
    Bound 2e-5: the float32 cancellation in |a|² + |b|² - 2ab (~1e-7 on
    coordinates in [0, 1]) is divided by 2σ² = 0.02 in the exponent."""
    coords = deconvo_case()[4]
    c = coords - coords.min(0)
    c = c / max(c.max(), 1e-12)
    d = jmatrix.pairwise_distance(c.astype(np.float32))
    want = np.exp(-d ** 2 / (2 * 0.1 ** 2))
    np.fill_diagonal(want, 0)
    np.testing.assert_allclose(tcard.gaussian_kernel(coords, 0.1, CPU).numpy(), want, rtol=2e-5,
                               atol=1e-7)


@pytest.mark.parametrize("phi", [0.1, 0.9, None])
def test_cardref_fixed_iterations_match_jax(phi):
    """Each φ (None: no kernel) at fixed iteration counts (epsilon 0): one
    iteration at 1e-5, 100 at 1e-4; the objective likewise."""
    x_spots, coords, _, _, X, U, V0 = _card_inputs()
    W = None if phi is None else tcard.gaussian_kernel(coords, 0.1, CPU)
    jW = None if phi is None else jnp.asarray(W.numpy())
    for iters, rel in ((1, 1e-5), (100, 1e-4)):
        run = tcard._cardref(torch.tensor(X), torch.tensor(U), W, phi or 0.0, torch.tensor(V0),
                             iters, 0.0)
        jpred, jobj = jcard._cardref(jnp.asarray(X), jnp.asarray(U), jW, phi or 0.0,
                                     jnp.asarray(V0), iters, 0.0)
        assert run.iterations == iters
        _close_scaled(run.pred.numpy(), jpred, rel, "pred")
        np.testing.assert_allclose(float(run.obj), float(jobj), rtol=rel)


def test_cardref_stop_matches_jax():
    """The RMS stop past iteration 5 (epsilon 1e-4): the converged portions
    within 1e-3, the iterations run within one of JAX's (which reports none:
    its count is recovered as the fixed-length run that gives its V)."""
    x_spots, coords, _, _, X, U, V0 = _card_inputs()
    W = tcard.gaussian_kernel(coords, 0.1, CPU)
    run = tcard._cardref(torch.tensor(X), torch.tensor(U), W, 0.3, torch.tensor(V0), 400, 1e-4)
    jpred, _ = jcard._cardref(jnp.asarray(X), jnp.asarray(U), jnp.asarray(W.numpy()), 0.3,
                              jnp.asarray(V0), 400, 1e-4)
    assert 5 < run.iterations < 400
    _close_scaled(run.pred.numpy(), jpred, 1e-3, "converged pred")
    gaps = {}
    for n in (run.iterations - 1, run.iterations, run.iterations + 1):
        p, _ = jcard._cardref(jnp.asarray(X), jnp.asarray(U), jnp.asarray(W.numpy()), 0.3,
                              jnp.asarray(V0), n, 0.0)
        gaps[n] = float(np.abs(np.asarray(p) - np.asarray(jpred)).max())
    assert min(gaps.values()) <= 1e-5, gaps
    # the converged V stays frozen while the loop finishes its chunk
    fixed = tcard._cardref(torch.tensor(X), torch.tensor(U), W, 0.3, torch.tensor(V0),
                           run.iterations, 0.0)
    np.testing.assert_array_equal(fixed.pred.numpy(), run.pred.numpy())


def test_card_fit_matches_jax():
    """Card.fit: the φ sweep at 30 iterations (epsilon 0) picks JAX's φ, with
    every φ's objective within 1e-4; the location-free fit; the host
    CARDref and obj_func."""
    x_spots, coords, portions, profiles, X, U, V0 = _card_inputs()
    cts = [f"ct{t}" for t in range(N_TYPES)]
    jm = jcard.Card(pd.DataFrame(profiles.T, columns=cts)).fit((x_spots, coords), max_iter=30,
                                                               epsilon=0.0)
    tm = tcard.Card(profiles.T, device=CPU).fit((x_spots, coords), max_iter=30, epsilon=0.0)
    assert tm.best_phi == jm.best_phi
    np.testing.assert_allclose(tm.best_obj, jm.best_obj, rtol=1e-4)
    _close_scaled(tm.predict(), jm.predict(), name="portions")
    assert [h["phi"] for h in tm.history] == list(tcard.PHIS)
    np.testing.assert_allclose(tm.score(None, portions), jm.score(None, portions), rtol=1e-3)
    jf = jcard.Card(pd.DataFrame(profiles.T)).fit((x_spots, np.zeros_like(coords)), max_iter=20)
    tf = tcard.Card(profiles.T, device=CPU).fit((x_spots, np.zeros_like(coords)), max_iter=20)
    assert tf.best_phi == jf.best_phi == 0.0
    _close_scaled(tf.predict(), jf.predict(), 1e-3, "location free")
    Wn = tcard.gaussian_kernel(coords, 0.1, CPU).numpy().astype(np.float64)
    args = (X.astype(np.float64), U.astype(np.float64), Wn, 0.3, 10, 1e-4, V0,
            np.zeros((N_TYPES, 1)), 0.1, np.full(N_TYPES, 10.0))
    got, want = tcard.CARDref(*args), jcard.CARDref(*args)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def _deconvo_data(x_ref, labels, x_spots, coords, names):
    n_ref = len(x_ref)
    adata = AnnData(np.vstack([x_ref, x_spots]),
                    obs={"cellType": np.r_[labels, ["spot"] * len(x_spots)]},
                    var=pd.DataFrame(index=pd.Index(names)))
    adata.obsm["spatial"] = np.vstack([np.zeros((n_ref, 2), np.float32), coords])
    data = Data(adata)
    data.set_split_idx("ref", list(range(n_ref)))
    data.set_split_idx("test", list(range(n_ref, n_ref + len(x_spots))))
    return data


def test_card_preprocess_matches_jax():
    """The profiles by mean, the mt- match, the common genes, the markers and
    the rv percentiles against the JAX Compose on a reference + spots
    container: the genes, their order and the basis."""
    x_ref, labels, x_spots, _, coords, _ = deconvo_case(n_genes=80, seed=3)
    names = np.array([("mt-" if k % 13 == 0 else "g") + str(k) for k in
                      np.random.default_rng(0).permutation(80)])
    x_spots[:, 5] = 0  # a gene no spot expresses
    data = _deconvo_data(x_ref, labels, x_spots, coords, names)
    jcard.Card.preprocessing_pipeline(log_level="WARNING")(data)
    inp = tcard.card_preprocess(x_ref, labels, x_spots, coords, names)
    np.testing.assert_array_equal(inp.genes, np.asarray(data.data.var_names))
    np.testing.assert_array_equal(inp.basis, data.data.varm["CellTopicProfile"].values)
    test = np.asarray(data.get_split_idx("test"))
    np.testing.assert_array_equal(inp.x, data.data.X[test])
    assert not any(g.startswith("mt-") for g in inp.genes) and list(inp.genes) == sorted(inp.genes)
    # the front runs the container pipeline, which prints JAX's digest
    assert tcard.Card.preprocessing_pipeline().hexdigest() == \
        jcard.Card.preprocessing_pipeline().hexdigest()


def test_filter_genes_common_matches_jax():
    """Genes with a nonzero sum in every group, in sorted-name order."""
    x_ref, labels, x_spots, _, coords, _ = deconvo_case(seed=4)
    names = np.array([f"g{k}" for k in np.random.default_rng(1).permutation(x_ref.shape[1])])
    x_ref[:, 3] = 0
    x_spots[:, 7] = 0
    data = _deconvo_data(x_ref, labels, x_spots, coords, names)
    JCommon(split_keys=["ref", "test"])(data)
    got = FilterGenesCommon()([(x_ref, names), (x_spots, names)])
    np.testing.assert_array_equal(got[0][1], np.asarray(data.data.var_names))
    np.testing.assert_array_equal(np.vstack([got[0][0], got[1][0]]), data.data.X)
    assert list(got[0][1]) == sorted(got[0][1]) and len(got[0][1]) == len(names) - 2
    # groups naming their genes in different orders
    perm = np.random.default_rng(2).permutation(len(names))
    other = FilterGenesCommon()([(x_ref, names), (x_spots[:, perm], names[perm])])
    np.testing.assert_array_equal(other[1][0], got[1][0])


def test_giotto_profiles_and_counts_match_jax():
    x_ref, labels, _, _, _, _ = deconvo_case(seed=5)
    np.testing.assert_array_equal(get_giotto_dt(x_ref, labels, 1.0),
                                  jpb.get_giotto_dt(x_ref, labels, 1.0))
    data = Data(AnnData(x_ref.copy(), obs={"cellType": labels}))
    jpb.CellGiottoTopicProfile()(data)
    mean, det, cts = CellGiottoTopicProfile()(x_ref, labels)
    np.testing.assert_array_equal(mean, data.data.varm["CellGiottoTopicProfile"].values)
    np.testing.assert_array_equal(det, data.data.varm["CellGiottoDetectionTopicProfile"].values)
    assert cts == list(data.data.varm["CellGiottoTopicProfile"].columns)
    with pytest.warns(UserWarning, match="experimental"):
        jpb.CellTypeNums(ct_select=["ct2", "ct0"])(data)
    nums, cts = CellTypeNums(ct_select=["ct2", "ct0"])(labels)
    np.testing.assert_array_equal(nums, data.data.uns["CellTypeNums"]["nums"].to_numpy())
    assert cts == ["ct2", "ct0"]


@pytest.mark.parametrize("dist", ["pearson", "spearman", 1, 2])
def test_correlation_distances_match_jax(dist):
    """JAX's float32 Pearson (norms clamped at 1e-12: a constant row is at
    distance 1, not NaN) and Spearman on average-tie ranks."""
    rng = np.random.default_rng(6)
    x = rng.poisson(1.0, (30, 12)).astype(np.float32)  # ties in every row
    x[4] = 3.0  # a constant row
    y = rng.random((9, 12)).astype(np.float32)
    got = tmatrix.pairwise_distance(x, dist_func=dist)
    want = jmatrix.pairwise_distance(x, dist_func=dist)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.isfinite(got).all() and np.allclose(got[4], 1.0)
    np.testing.assert_allclose(tmatrix.pairwise_distance(x, y, dist_func=dist),
                               jmatrix.pairwise_distance(x, y, dist_func=dist), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(tmatrix._rankdata(torch.tensor(x)).numpy(),
                                  np.asarray(jmatrix._rankdata(jnp.asarray(x))))


def test_single_pair_distances_match_jax():
    rng = np.random.default_rng(7)
    a, b = rng.poisson(2.0, 20).astype(float), rng.random(20)
    for name in ("euclidean_distance", "pearson_distance", "spearman_distance"):
        assert getattr(tmatrix, name)(a, b) == getattr(jmatrix, name)(a, b)
    np.testing.assert_array_equal(tmatrix.mean_rank_data(a), jmatrix.mean_rank_data(a))
    with pytest.raises(ValueError, match="same length"):
        tmatrix.spearman_distance(a, b[:5])
