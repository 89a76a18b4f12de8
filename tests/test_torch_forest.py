"""Port parity for the random forest (dance_tpu_torch.ops.forest), the gene
statistics (dance_tpu_torch.transforms.stats), SingleCellNet's gene-pair
features (dance_tpu_torch.transforms.scn_feature) and SingleCellNet
(dance_tpu_torch.modules.single_modality.cell_type_annotation.singlecellnet).

Inputs are made with numpy from a seed; JAX's draws (Poisson weights, each
level's candidate features and threshold examples, from its keys as
``_fit_forest`` splits them) are handed to the port's ``fit``, and the
pseudo-cells come from a ``RandomState`` seeded as numpy's global state is
seeded for JAX. Tolerances: unweighted fits (integer weights, exact sums)
give JAX's split tables exactly and its leaf distributions at rtol 1e-6;
with balanced weights the class sums are float32 in another order and a pure
node's split is rounding's choice in each package, so the tables are held at
90 %, the probabilities within 0.05 and the labels wherever that bound
cannot flip them; the
statistics, the features and the gene pairs exactly.
"""

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import dance_tpu.ops.forest as J
from dance_tpu.datasets.synthetic import annotation_data
from dance_tpu.modules.single_modality.cell_type_annotation import SingleCellNet as JSCN
from dance_tpu.transforms import scn_feature as jscn
from dance_tpu.transforms import stats as jstats
import dance_tpu_torch.ops.forest as T
from dance_tpu_torch.modules.single_modality.cell_type_annotation import (
    SingleCellNet, singlecellnet_preprocess)
from dance_tpu_torch.transforms import GeneStats
from dance_tpu_torch.transforms import scn_feature as tscn
from dance_tpu_torch.transforms import stats as tstats

CPU = torch.device("cpu")


def jax_draws(seed, n_trees, n, n_feats, max_depth, k, bootstrap=True) -> T.ForestDraws:
    """Every draw of JAX's ``_fit_forest`` (forest.py:82-104), from its keys."""
    width = 2 ** (max_depth - 1)
    k_boot, k_lvl = jax.random.split(jax.random.key(seed))
    poisson = (torch.tensor(np.asarray(jax.random.poisson(k_boot, 1.0, (n_trees, n)),
                                       np.float32)) if bootstrap else None)
    cand_f, r1, r2 = (np.zeros((n_trees, max_depth, width, k), np.int64) for _ in range(3))
    for t, key_t in enumerate(jax.random.split(k_lvl, n_trees)):
        for level, key_l in enumerate(jax.random.split(key_t, max_depth)):
            kf, kt1, kt2 = jax.random.split(key_l, 3)
            cand_f[t, level] = jax.random.randint(kf, (width, k), 0, n_feats)
            r1[t, level] = jax.random.randint(kt1, (width, k), 0, n)
            r2[t, level] = jax.random.randint(kt2, (width, k), 0, n)
    return T.ForestDraws(poisson, *(torch.from_numpy(a) for a in (cand_f, r1, r2)))


def _xy(seed=0, n=150, f=12, classes=3):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n)
    centres = rng.normal(0, 1.5, (classes, f))
    x = (centres[y] + rng.normal(size=(n, f))).astype(np.float32)
    y[:10] = classes - 1  # an unbalanced last class
    return x, y


@pytest.mark.parametrize("bootstrap", [True, False])
def test_forest_unweighted_matches_jax(bootstrap):
    """Integer weights: the split tables are JAX's exactly."""
    x, y = _xy()
    T_, D, K = 6, 4, 8
    jm = J.RandomForest(n_estimators=T_, max_depth=D, n_candidates=K, bootstrap=bootstrap,
                        random_state=3).fit(x, y)
    tm = T.RandomForest(n_estimators=T_, max_depth=D, n_candidates=K, bootstrap=bootstrap,
                        random_state=3, device=CPU)
    tm.fit(x, y, draws=jax_draws(3, T_, len(y), x.shape[1], D, K, bootstrap))
    np.testing.assert_array_equal(tm.forest.feats.numpy(), np.asarray(jm.forest.feats))
    np.testing.assert_array_equal(tm.forest.thrs.numpy(), np.asarray(jm.forest.thrs))
    np.testing.assert_allclose(tm.forest.leaf_probs.numpy(), np.asarray(jm.forest.leaf_probs),
                               rtol=1e-6)
    xq, _ = _xy(seed=1)
    np.testing.assert_allclose(tm.predict_proba(xq), jm.predict_proba(xq), rtol=1e-6)
    np.testing.assert_array_equal(tm.predict(xq), jm.predict(xq))
    np.testing.assert_array_equal(tm.classes_, jm.classes_)


def test_forest_balanced_matches_jax():
    """class_weight="balanced": the class sums are float32 sums in another
    order. Where candidates score alike to rounding (every split of a pure
    node scores the node's weight), each package picks by its own rounding,
    so a pure node's split, and with it how its class's weight falls into
    its leaves, may differ. Held: the roots' splits exactly, 90 % of the
    table, the probabilities within 0.05 and the labels wherever JAX's two
    likeliest classes are further apart than that allows."""
    x, y = _xy(seed=2)
    T_, D, K = 6, 4, 8
    jm = J.RandomForest(n_estimators=T_, max_depth=D, n_candidates=K, class_weight="balanced",
                        random_state=4).fit(x, y)
    tm = T.RandomForest(n_estimators=T_, max_depth=D, n_candidates=K, class_weight="balanced",
                        random_state=4, device=CPU)
    tm.fit(x, y, draws=jax_draws(4, T_, len(y), x.shape[1], D, K))
    f, jf = tm.forest.feats.numpy(), np.asarray(jm.forest.feats)
    np.testing.assert_array_equal(f[:, 0, 0], jf[:, 0, 0])
    used = np.concatenate([f[:, lv, :2 ** lv].ravel() == jf[:, lv, :2 ** lv].ravel()
                           for lv in range(D)])
    assert used.mean() >= 0.9
    xq, _ = _xy(seed=3)
    p, jp = tm.predict_proba(xq), jm.predict_proba(xq)
    assert np.abs(p - jp).max() <= 0.05
    _same_where_clear(tm.predict(xq), jm.predict(xq), jp)


def _same_where_clear(pred, jpred, jp, bound=0.05):
    """The labels agree wherever JAX's two largest probabilities are more
    than twice the probability bound apart."""
    top2 = np.sort(jp, 1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * bound
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(pred[clear], jpred[clear])


def test_segment_sum_is_exact_and_repeatable():
    """Integer values sum exactly (as JAX's segment_sum of integers); float
    values agree with a float64 reference, the same on every call."""
    rng = np.random.default_rng(0)
    seg = rng.integers(0, 7, (3, 200))
    seg[1] = 2  # one segment holds everything
    vals = rng.poisson(2.0, (3, 200, 4)).astype(np.float32)
    want = np.zeros((3, 9, 4))
    for r in range(3):
        np.add.at(want[r], seg[r], vals[r])
    got = T.segment_sum(torch.tensor(vals), torch.tensor(seg), 9)
    np.testing.assert_array_equal(got.numpy(), want)
    fv = rng.random((3, 200)).astype(np.float32)
    want = np.zeros((3, 9))
    for r in range(3):
        np.add.at(want[r], seg[r], fv[r].astype(np.float64))
    a = T.segment_sum(torch.tensor(fv), torch.tensor(seg), 9)
    np.testing.assert_allclose(a.numpy(), want, rtol=1e-6)
    np.testing.assert_array_equal(a.numpy(), T.segment_sum(torch.tensor(fv), torch.tensor(seg),
                                                           9).numpy())


def test_forest_own_draws():
    """The port's draws: Poisson(1) weights, candidates in range; a fit from
    them classifies its training cells well above chance."""
    x, y = _xy(seed=5)
    d = T.forest_draws(0, 4, len(y), x.shape[1], 3, 5)
    assert d.poisson.shape == (4, len(y)) and float(d.poisson.mean()) == pytest.approx(1, abs=0.2)
    assert d.cand_f.shape == (4, 3, 4, 5) and int(d.cand_f.max()) < x.shape[1]
    assert int(d.r1.max()) < len(y) and int(d.r2.min()) >= 0
    m = T.RandomForest(n_estimators=10, max_depth=5, device=CPU).fit(x, y)
    assert (m.predict(x) == y).mean() > 0.8


def test_genestats_match_jax():
    x = np.asarray(annotation_data(n_cells=80, n_genes=30, seed=1).data.X, np.float32)
    x[:, 3] = 0  # a gene no cell expresses: mu, cov and fano are NaN
    for name, fn in tstats.GENESTATS_FUNCS.items():
        jfn = getattr(jstats, f"genestats_{name}")
        for kw in ({}, {"threshold": 1.0, "pseudo": True}):
            np.testing.assert_array_equal(fn(x, **kw), jfn(x, **kw), err_msg=name)
    from dance_tpu.registry import REGISTERED_GENESTATS_FUNCS
    assert list(tstats.GENESTATS_FUNCS) == list(REGISTERED_GENESTATS_FUNCS)
    from dance_tpu.data import AnnData, Data
    data = Data(AnnData(x.copy()), train_size="all")
    jstats.GeneStats(["mu", "cov_all"], fill_na=-1.0, threshold=0.5)(data)
    got = GeneStats(x, ["mu", "cov_all"], fill_na=-1.0, threshold=0.5)
    df = data.data.varm["GeneStats"]
    for k, v in got.items():
        np.testing.assert_array_equal(v, df[k].to_numpy())
    assert set(GeneStats(x)) == set(tstats.GENESTATS_FUNCS)
    with pytest.raises(ValueError, match="Unknown"):
        GeneStats(x, ["nope"])


def _annotation(seed=0, n=200, g=60):
    data = annotation_data(n_cells=n, n_genes=g, n_types=3, seed=seed)
    x = np.log1p(np.asarray(data.data.X, np.float32))
    names = np.asarray(data.data.var_names)
    types = np.asarray(data.data.obs["cell_type"])
    return data, x, names, types


def test_scn_feature_functions_match_jax():
    """The DE genes, the greedy pair choice and the pair features against
    JAX's on a DataFrame."""
    _, x, names, types = _annotation()
    df = pd.DataFrame(x, columns=names)
    for kw in ({"num_top_genes": 5}, {"num_top_genes": 8, "alpha1": 0.5, "mu": 1.0}):
        jdegs = jscn.get_diff_exp_genes(df, types, **kw)
        tdegs = tscn.get_diff_exp_genes(x, names, types, **kw)
        assert tdegs == jdegs
    jpairs = jscn.get_top_gene_pairs(df, types, jdegs, num_top_pairs=6, max_gene_per_ct=2)
    tpairs = tscn.get_top_gene_pairs(x, names, types, tdegs, num_top_pairs=6, max_gene_per_ct=2)
    assert tpairs == jpairs and len(tpairs) > 6
    feat, cols = tscn.query_transform(x, names, tpairs)
    jfeat = jscn.query_transform(df, jpairs)
    np.testing.assert_array_equal(feat, jfeat.values)
    assert cols == list(jfeat.columns)
    scores = np.r_[np.nan, np.linspace(0, 1, 9)]
    pairs = [("a", "b"), ("a", "c"), ("b", "c"), ("a", "d"), ("c", "d"), ("b", "d"),
             ("e", "f"), ("a", "e"), ("d", "f"), ("c", "e")]
    assert (tscn._get_best_gene_pairs(scores, pairs, 4, 1)
            == jscn._get_best_gene_pairs(scores, pairs, 4, 1))


def test_scn_preprocess_matches_jax_pipeline():
    """normalize_total(1e4), log1p and SCNFeature on the training split
    against the JAX Compose on a Data container."""
    data, _, names, types = _annotation(seed=1)
    counts = np.asarray(data.data.X, np.float32).copy()
    train = np.asarray(data.get_split_idx("train"))
    JSCN.preprocessing_pipeline(num_top_genes=6, num_top_gene_pairs=8,
                                log_level="WARNING")(data)
    jdf = data.data.obsm["SCNFeature"]
    feat, cols = singlecellnet_preprocess(counts, names, types, train, num_top_genes=6,
                                          num_top_gene_pairs=8)
    assert cols == list(jdf.columns)
    np.testing.assert_array_equal(feat, jdf.values)


def test_singlecellnet_matches_jax():
    """Pseudo-cells from the same numpy stream, JAX's forest draws: the
    probabilities within 0.05 and the labels where they are clear (balanced
    weights: see test_forest_balanced_matches_jax)."""
    _, x, _, types = _annotation(seed=2, n=160, g=20)
    y = np.unique(types, return_inverse=True)[1]
    num_rand, trees, depth = 20, 8, 5
    np.random.seed(11)
    jm = JSCN(num_trees=trees, max_depth=depth)
    jm.fit(x, y, num_rand=num_rand, random_state=7)
    tm = SingleCellNet(num_trees=trees, max_depth=depth, device=CPU)
    tm.fit(x, y, num_rand=num_rand, random_state=7, rng=np.random.RandomState(11),
           draws=jax_draws(7, trees, len(y) + num_rand, x.shape[1], depth, 32))
    p, jp = tm.predict_proba(x), jm.predict_proba(x)
    assert p.shape == (len(y), y.max() + 2)
    assert np.abs(p - jp).max() <= 0.05
    _same_where_clear(tm.predict(x), jm.predict(x), jp)
    np.random.seed(11)
    jr = jm.randomize(x, num=5)
    np.testing.assert_array_equal(tm.randomize(x, num=5, rng=np.random.RandomState(11)), jr)
    # the default draw is seeded by random_state: two fits agree
    a = SingleCellNet(num_trees=3, max_depth=3, device=CPU).fit(x, y, num_rand=5)
    b = SingleCellNet(num_trees=3, max_depth=3, device=CPU).fit(x, y, num_rand=5)
    np.testing.assert_array_equal(a.predict_proba(x), b.predict_proba(x))
