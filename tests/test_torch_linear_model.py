"""Port parity for the linear heads (dance_tpu_torch.ops.linear_model) and
the methods on them, SVM and CellTypist (dance_tpu_torch.modules.
single_modality.cell_type_annotation.{svm,celltypist}).

Inputs are made with numpy from a seed (``torch_cases.typed_counts``: 160
cells x 48 genes in 3 types, log1p) and handed to both packages; JAX's
minibatch rows and RFF draws are handed to the port through patched
``sgd_rows``/``rff_draws``. JAX's fits are its jitted ``_fit_ovr`` and
``_fit_kernel_ovr`` called directly.
The SVC fits are 300 Adam steps (optax's adam is torch's rule).
Tolerances: the objective, the kernels, the features and the standardising
at rtol 1e-5; fits (up to a few hundred Adam steps from zero weights, float32
sums in another order) at 1e-5 of the largest weight; γ exactly; labels,
the chosen genes, the tol stop's step count, the majority vote and the
over-clustering exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import dance_tpu.ops.linear_model as J
from dance_tpu.modules.single_modality.cell_type_annotation import SVM as JSVM
from dance_tpu.modules.single_modality.cell_type_annotation import Celltypist as JCelltypist
from dance_tpu.modules.single_modality.cell_type_annotation import celltypist as jct
import dance_tpu_torch.ops.linear_model as T
from dance_tpu_torch.modules.single_modality.cell_type_annotation import (SVM, Celltypist,
                                                                          svm_preprocess)
from dance_tpu_torch.modules.single_modality.cell_type_annotation import celltypist as tct
from dance_tpu_torch.transforms import weighted_feature_pca
from torch_cases import typed_counts

CPU = torch.device("cpu")


def _inputs(seed=0, n=160, g=48):
    counts, types, _ = typed_counts(n=n, g=g, seed=seed)
    return np.log1p(counts), types


def _close_scaled(got, want, rel=1e-5, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    gap = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert gap <= rel, f"{name}: gap {gap} of the largest value"


def _targets(y):
    return T.ovr_targets(y)[1]


@pytest.mark.parametrize("loss", ["squared_hinge", "logistic"])
def test_objective_matches_jax(loss):
    """The objective and its gradients at random weights (rtol 1e-5)."""
    x, y = _inputs()
    t = _targets(y)
    rng = np.random.default_rng(1)
    W = rng.normal(size=(x.shape[1], 3)).astype(np.float32) * 0.1
    b = rng.normal(size=3).astype(np.float32)

    def jobj(W, b):
        f = jnp.dot(x, W, precision=J.HI) + b
        m = t * f
        if loss == "squared_hinge":
            data = jnp.mean(jnp.sum(jnp.maximum(0.0, 1.0 - m) ** 2, axis=1))
        else:
            data = jnp.mean(jnp.sum(jnp.logaddexp(0.0, -m), axis=1))
        return data + 0.5 * 0.01 * jnp.sum(W * W)

    jv, (jgW, jgb) = jax.value_and_grad(jobj, argnums=(0, 1))(W, b)
    tW = torch.tensor(W, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    tv = T.ovr_objective(tW, tb, torch.tensor(x), torch.tensor(t), 0.01, loss)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(tW.grad.numpy(), np.asarray(jgW), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jgb), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("tol", [1e-4, 1e-2])
def test_tol_stop_matches_jax(tol):
    """DeviceLogisticRegression's chunked stop: the same weights as JAX's
    while_loop, and the protocol: every chunk but the last gains more than
    tol of the objective, the last at most (or the cap is reached), one
    chunk of 25 steps at a time."""
    x, y = _inputs()
    t = _targets(y)
    jW, jb = J._fit_ovr(jnp.asarray(x), jnp.asarray(t), 1.0 / len(y), 0.05, 1000, "logistic",
                        tol=tol, tol_chunk=25, precision=jax.lax.Precision.DEFAULT)
    m = T.DeviceLogisticRegression(tol=tol, device=CPU).fit(x, y)
    _close_scaled(m.coef_.T, jW, name="W")
    _close_scaled(m.intercept_, jb, name="b")
    obj = np.asarray(m.objectives_, np.float32)
    assert m.steps_run == 25 * (len(obj) - 1) and m.steps_run < 1000
    gains = (obj[:-1] - obj[1:]) > tol * np.maximum(np.abs(obj[:-1]), 1e-12)
    assert gains[:-1].all() and not gains[-1]
    # the same number of steps without the stop gives the same weights
    W, b, _, _ = T._fit_ovr(torch.tensor(x), torch.tensor(t), 1.0 / len(y), 0.05, m.steps_run,
                            "logistic")
    np.testing.assert_array_equal(W.numpy().T, m.coef_)


def test_tol_stop_runs_to_the_cap():
    """With a tol no chunk can miss, the fit runs ceil(epochs / 25) chunks."""
    x, y = _inputs()
    m = T.DeviceLogisticRegression(tol=-1.0, epochs=60, device=CPU).fit(x, y)
    assert m.steps_run == 75 and len(m.objectives_) == 4


def test_linear_classifier_surface_matches_jax():
    """decision_function, predict and the row-normalised predict_proba of a
    fitted head, from the same weights."""
    x, y = _inputs()
    jm = J.DeviceLinearClassifier(epochs=50).fit(x, y)
    tm = T.DeviceLinearClassifier(epochs=50, device=CPU).fit(x, y)
    _close_scaled(tm.coef_, jm.coef_, name="coef")
    np.testing.assert_array_equal(tm.classes_, jm.classes_)
    tm._W = torch.tensor(np.asarray(jm._W))
    tm._b = torch.tensor(np.asarray(jm._b))
    np.testing.assert_allclose(tm.decision_function(x), jm.decision_function(x), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(tm.predict(x), jm.predict(x))
    np.testing.assert_allclose(tm.predict_proba(x), jm.predict_proba(x), rtol=1e-5)
    np.testing.assert_allclose(tm.predict_proba(x).sum(1), 1.0, rtol=1e-6)
    # the SGD head goes full batch when the batch covers the cells
    sgd = T.DeviceSGDLogistic(epochs=5, batch_size=500, device=CPU).fit(x, y)
    assert sgd.batch_size == 0


def test_rbf_kernel_and_gamma_match_jax():
    x, _ = _inputs()
    jm, tm = J.DeviceSVC(), T.DeviceSVC(device=CPU)
    assert tm._resolve_gamma(x) == jm._resolve_gamma(x)
    g = tm._gamma_val
    np.testing.assert_allclose(T._rbf_kernel(torch.tensor(x), torch.tensor(x[:40]), g).numpy(),
                               np.asarray(J._rbf_kernel(x, x[:40], g)), rtol=1e-5, atol=1e-7)
    assert T.DeviceSVC(gamma="auto", device=CPU)._resolve_gamma(x) == 1.0 / x.shape[1]
    assert T.DeviceSVC(gamma=0.5, device=CPU)._resolve_gamma(x) == 0.5


def _jax_rff_draws(d, n_features, seed):
    kw, kb = jax.random.split(jax.random.key(seed))
    return (torch.tensor(np.asarray(jax.random.normal(kw, (d, n_features)))),
            torch.tensor(np.asarray(jax.random.uniform(kb, (n_features,), maxval=2 * jnp.pi))))


def test_rff_svc_matches_jax(monkeypatch):
    """Beyond kernel_cap the SVC trains on random Fourier features: JAX's
    draws, then 300 Adam steps of the squared hinge."""
    monkeypatch.setattr(T, "rff_draws", _jax_rff_draws)
    x, y = _inputs()
    g = J.DeviceSVC()._resolve_gamma(x)
    np.testing.assert_allclose(T._rff(torch.tensor(x), g, 256, 5).numpy(),
                               np.asarray(J._rff(jnp.asarray(x), g, 256, 5)), rtol=1e-5, atol=1e-6)
    jm = J.DeviceSVC(n_components=256, kernel_cap=100, random_state=5).fit(x, y)
    tm = T.DeviceSVC(n_components=256, kernel_cap=100, random_state=5, device=CPU).fit(x, y)
    assert tm._x_fit is None
    _close_scaled(tm.coef_, jm.coef_, name="coef")
    _close_scaled(tm.decision_function(x), jm.decision_function(x), name="decision")
    np.testing.assert_array_equal(tm.predict(x), jm.predict(x))


def test_kernel_svc_matches_jax():
    """Up to kernel_cap the Gram matrix is exact: 300 Adam steps on the
    primal kernel objective."""
    x, y = _inputs()
    jm = J.DeviceSVC(random_state=0).fit(x[:120], y[:120])
    tm = T.DeviceSVC(random_state=0, device=CPU).fit(x[:120], y[:120])
    _close_scaled(tm._W.numpy(), jm._W, name="a")
    _close_scaled(tm._b.numpy(), jm._b, name="b")
    _close_scaled(tm.decision_function(x[120:]), jm.decision_function(x[120:]), name="decision")
    np.testing.assert_array_equal(tm.predict(x[120:]), jm.predict(x[120:]))
    np.testing.assert_allclose(tm.predict_proba(x[120:]), jm.predict_proba(x[120:]), rtol=1e-4)


def test_svm_method_matches_jax():
    """SVM on one-hot labels, on the gene-PCA features of the training cells
    (svm_preprocess: ``weighted_feature_pca``, held against JAX's
    WeightedFeaturePCA in test_torch_scdeepsort.py); the sklearn backend
    raises."""
    x, y = _inputs(n=150)
    train = np.arange(100)
    feat = svm_preprocess(x, train, 12, device=CPU)
    np.testing.assert_array_equal(feat, weighted_feature_pca(x[train], x, 12, device=CPU)[0])
    yoh = np.eye(3, dtype=np.float32)[y]
    jm, tm = JSVM(random_state=1), SVM(random_state=1, device=CPU)
    jm.fit(feat[train], yoh[train])
    tm.fit(feat[train], yoh[train])
    np.testing.assert_array_equal(tm.predict(feat), jm.predict(feat))
    _close_scaled(tm.predict_proba(feat), jm.predict_proba(feat), name="proba")
    with pytest.raises(NotImplementedError, match="scikit-learn"):
        SVM(backend="sklearn", device=CPU)


def test_device_standardize_matches_jax():
    """Population variance (torch's default is the unbiased one), a zero
    scale read as 1, values clipped at 10."""
    x, _ = _inputs()
    x[:, 5] = 2.0  # constant gene
    x[0, 7] = 400.0  # clipped
    jx, jmean, jscale = jct._device_standardize(jnp.asarray(x))
    tx, tmean, tscale = tct._device_standardize(torch.tensor(x))
    np.testing.assert_allclose(tscale.numpy(), np.asarray(jscale), rtol=1e-5)
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=1e-5)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5)
    assert tscale[5] == 1.0 and float(tx.max()) == 10.0
    assert not np.allclose(tscale.numpy(), torch.tensor(x).std(0).numpy())


def _fit_pair(x, y, monkeypatch=None, rows=None, **kw):
    jm = JCelltypist().fit(x, y, **kw)
    tm = Celltypist(device=CPU).fit(x, y, **kw)
    return jm, tm


@pytest.mark.parametrize("kw", [{}, {"use_SGD": True, "max_iter": 80},
                                {"feature_selection": True, "top_genes": 10, "max_iter": 80}],
                         ids=["lr_tol", "sgd", "feature_selection"])
def test_celltypist_fit_matches_jax(kw):
    """The LR head to its tol stop, the full-batch SGD head, and the
    two-pass feature selection (argpartition over |coef| on the host)."""
    x, y = _inputs(n=120)
    jm, tm = _fit_pair(x, y, **kw)
    np.testing.assert_array_equal(tm.classifier.features, jm.classifier.features)
    _close_scaled(tm.classifier.coef_, jm.classifier.coef_, name="coef")
    np.testing.assert_allclose(tm.scaler.mean_, jm.scaler.mean_, rtol=1e-5)
    np.testing.assert_allclose(tm.scaler.scale_, jm.scaler.scale_, rtol=1e-5)
    np.testing.assert_allclose(tm.scaler.var_, jm.scaler.var_, rtol=1e-5)
    assert tm.scaler.n_features_in_ == jm.scaler.n_features_in_
    xq, _ = _inputs(seed=4, n=60)
    xq = xq[:, tm.classifier.features.astype(int)]  # the query on the chosen genes
    np.testing.assert_array_equal(tm.predict(xq), jm.predict(xq))
    tres, jres = tm.predict(xq, as_obj=True), jm.predict(xq, as_obj=True)
    _close_scaled(tres.decision_matrix, jres.decision_matrix.values, name="decision")
    _close_scaled(tres.probability_matrix, jres.probability_matrix.values, name="prob")
    assert tres.cell_types == list(jres.decision_matrix.columns)
    values, counts = tres.summary_frequency()
    want = jres.summary_frequency()
    np.testing.assert_array_equal(values, want["predicted_labels"].to_numpy())
    np.testing.assert_array_equal(counts, want["counts"].to_numpy())
    if kw.get("feature_selection"):
        assert len(tm.classifier.features) < x.shape[1]


def test_celltypist_minibatch_matches_jax(monkeypatch):
    """Minibatch SGD on JAX's rows: epochs x min(batch_number, n // batch)
    steps, each drawn with replacement."""
    own = T.sgd_rows(50, 64, 7, 0)  # the port's own draws
    assert own.shape == (7, 64) and int(own.min()) >= 0 and int(own.max()) < 50
    assert len(np.unique(own[0].numpy())) < 64
    x, y = _inputs(n=120)
    steps, bs = 3 * min(100, 120 // 40), 40
    keys = jax.random.split(jax.random.key(0), steps)
    rows = np.array(jax.vmap(lambda k: jax.random.randint(k, (bs,), 0, len(y)))(keys))
    seen = {}

    def rows_fn(n, b, s, sd):
        seen["shape"] = (n, b, s, sd)
        return torch.as_tensor(rows, dtype=torch.int64)
    monkeypatch.setattr(T, "sgd_rows", rows_fn)
    kw = dict(use_SGD=True, mini_batch=True, batch_size=bs, epochs=3)
    jm, tm = _fit_pair(x, y, **kw)
    assert seen["shape"] == (120, bs, steps, 0)
    _close_scaled(tm.classifier.coef_, jm.classifier.coef_, name="coef")


def test_celltypist_sklearn_paths_raise():
    x, y = _inputs(n=40)
    with pytest.raises(NotImplementedError, match="scikit-learn"):
        Celltypist(device=CPU).fit(x, y, backend="sklearn")
    for fn in (tct.LRClassifier_celltypist, tct.SGDClassifier_celltypist):
        with pytest.raises(NotImplementedError, match="scikit-learn"):
            fn(x, y, 1.0, None, 10, None)
    with pytest.raises(ValueError, match="cannot select"):
        Celltypist(device=CPU).fit(x, y, feature_selection=True, top_genes=100)


@pytest.mark.parametrize("min_prop", [0.0, 0.6])
def test_majority_voting_matches_crosstab(min_prop):
    """Each over-cluster's label: the first of the sorted labels at a tie, as
    pd.crosstab(...).idxmax() picks it; columns are the cluster names as
    strings ("10" before "2"); shares below min_prop are "Heterogeneous"."""
    rng = np.random.default_rng(5)
    clusters = rng.integers(0, 12, 90).astype(str)
    labels = rng.integers(0, 4, 90)
    tie = np.nonzero(clusters == "3")[0]  # a 1-2 tie in cluster "3"
    labels[tie] = np.where(np.arange(len(tie)) % 2, 1, 2)
    if len(tie) % 2:
        labels[tie[-1]] = 0
    labels = np.array([f"t{i}" for i in labels])  # pandas sets no str into an int column
    decision = rng.normal(size=(90, 4))
    cols = [f"t{i}" for i in range(4)]
    jres = jct.AnnotationResult(pd.DataFrame({"predicted_labels": labels}),
                                pd.DataFrame(decision, columns=cols),
                                pd.DataFrame(decision, columns=cols))
    jres = JCelltypist._majority_voting(jres, clusters, min_prop)
    tres = tct.AnnotationResult(labels, decision, decision, cols)
    tres = Celltypist._majority_voting(tres, clusters, min_prop)
    want = jres.predicted_labels["majority_voting"].to_numpy()
    got = tres.predicted_labels["majority_voting"]
    assert got.tolist() == want.tolist()
    if not min_prop:
        assert got[clusters == "3"][0] == "t1"  # the tie goes to the first sorted label
    if min_prop:
        assert "Heterogeneous" in got.tolist()
    np.testing.assert_array_equal(tres.predicted_labels["over_clustering"], clusters)


def test_celltypist_majority_voting_predict_matches_jax():
    """predict with majority_voting: the query's over-clustering (PCA,
    15-NN, Leiden at the cell count's resolution) and the vote."""
    x, y = _inputs(n=120)
    xq, _ = _inputs(seed=6, n=150)
    jm = JCelltypist(majority_voting=True).fit(x, y)
    tm = Celltypist(majority_voting=True, device=CPU).fit(x, y)
    jclf = jct.Classifier(xq, jct.Model(jm.classifier, jm.scaler, jm.description))
    tclf = tct.Classifier(xq, tct.Model(tm.classifier, tm.scaler, tm.description), device=CPU)
    jclusters = jclf.over_cluster().to_numpy()
    np.testing.assert_array_equal(tclf.over_cluster(), jclusters)
    assert tm.predict(xq).tolist() == jm.predict(xq, over_clustering=jclusters).tolist()
    res = tm.predict(xq, as_obj=True)
    assert set(res.predicted_labels) == {"predicted_labels", "over_clustering",
                                         "majority_voting"}


def test_model_markers_match_jax():
    x, y = _inputs(n=120)
    jm, tm = _fit_pair(x, y)
    jmodel = jct.Model(jm.classifier, jm.scaler, jm.description)
    tmodel = tct.Model(tm.classifier, tm.scaler, tm.description)
    assert repr(tmodel) == repr(jmodel)
    for ct in tmodel.cell_types:
        for pos in (True, False):
            np.testing.assert_array_equal(tmodel.extract_top_markers(ct, 5, pos),
                                          jmodel.extract_top_markers(ct, 5, pos))
