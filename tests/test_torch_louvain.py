"""Port parity for Louvain and Leiden (dance_tpu_torch.ops.cluster on the
C++ library built from ``csrc/host/louvain.cpp`` by ops._build), the spatial
``Louvain`` method and its front, and the python-louvain module API.

Both packages get the same scipy adjacency, made with numpy from a seed.
The C++ labels are compared with the JAX package's C++ labels exactly (the
same source and compiler flags); ``louvain_plain`` with the JAX package's
numpy loop exactly, reached by making ``dance_tpu.native.louvain_labels``
return None in the test. The front's graph against the JAX pipeline's
(``Louvain.preprocessing_pipeline`` on a ``Data`` container) at rtol 1e-4 (its
PCA, float32 sums in another order), its pattern exactly.
"""

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp

import dance_tpu.native as jnative
from dance_tpu.data import AnnData, Data
from dance_tpu.modules.spatial.spatial_domain import louvain as JL
from dance_tpu.ops import cluster as jcluster
from dance_tpu.ops.neighbors import knn_graph as jknn_graph
from dance_tpu_torch.modules.spatial.spatial_domain import louvain as TL
from dance_tpu_torch.ops import _build
from dance_tpu_torch.ops import cluster as tcluster
from dance_tpu_torch.utils import ari


def _points(n=400, k=4, d=6, seed=0, spread=3.0):
    rng = np.random.default_rng(seed)
    truth = rng.integers(0, k, n)
    return ((rng.standard_normal((k, d)) * spread)[truth]
            + rng.standard_normal((n, d))).astype(np.float32), truth


def _graph(n=400, seed=0, mode="gauss", k=10):
    x, truth = _points(n=n, seed=seed)
    return jknn_graph(x, k, mode=mode, include_self=False), truth


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("resolution", [0.5, 1.0, 1.7])
def test_louvain_labels_equal_jax(seed, resolution):
    adj, _ = _graph(seed=seed)
    got = tcluster.louvain(adj, resolution=resolution, seed=seed)
    want = jcluster.louvain(adj, resolution=resolution, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert got.dtype.kind == "i" and got.min() == 0
    raw = tcluster.louvain_labels(adj + adj.T, resolution=resolution, seed=seed)
    np.testing.assert_array_equal(raw, jnative.louvain_labels(adj + adj.T, resolution=resolution,
                                                              seed=seed))


def test_louvain_plain_equals_jax_numpy_loop(monkeypatch):
    monkeypatch.setattr(jnative, "louvain_labels", lambda *a, **k: None)
    for seed, resolution in ((0, 1.0), (3, 0.6)):
        adj, truth = _graph(n=160, seed=seed, mode="connectivity", k=6)
        got = tcluster.louvain_plain(adj, resolution=resolution, seed=seed)
        np.testing.assert_array_equal(got, jcluster.louvain(adj, resolution=resolution,
                                                            seed=seed))
        assert ari(truth, got) > 0.5
    # an edgeless graph: one community per node
    np.testing.assert_array_equal(tcluster.louvain_plain(sp.csr_matrix((5, 5))), np.arange(5))


def test_leiden_matches_jax():
    adj, truth = _graph(n=300, seed=4, mode="connectivity", k=5)
    for resolution in (0.05, 1.0):
        got = tcluster.leiden(adj, resolution=resolution, seed=2)
        np.testing.assert_array_equal(got, jcluster.leiden(adj, resolution=resolution, seed=2))
    # two disconnected copies share no community
    two = sp.block_diag([adj, adj]).tocsr()
    labels = tcluster.leiden(two, resolution=0.01, seed=0)
    np.testing.assert_array_equal(labels, jcluster.leiden(two, resolution=0.01, seed=0))
    assert not set(labels[:300]) & set(labels[300:])


def test_spatial_louvain_front_fit_and_predict():
    rng = np.random.default_rng(5)
    dom = rng.integers(0, 3, 240)
    counts = rng.poisson(rng.gamma(1.0, 2.0, (3, 60))[dom] * 3).astype(np.float32)
    adj = TL.louvain_preprocess(counts, dim=10, n_neighbors=8, device="cpu")
    data = Data(AnnData(counts, obs=pd.DataFrame({"label": dom},
                                                 index=[f"s{i}" for i in range(240)])))
    JL.Louvain.preprocessing_pipeline(dim=10, n_neighbors=8)(data)
    jadj, labels = data.get_data(return_type="default")
    np.testing.assert_array_equal(np.asarray(labels).ravel(), dom)
    np.testing.assert_array_equal(adj.indptr, jadj.indptr)
    np.testing.assert_array_equal(adj.indices, jadj.indices)
    np.testing.assert_allclose(adj.data, jadj.data, rtol=1e-4, atol=1e-6)
    for rs in (None, 3):
        m, jm = TL.Louvain(resolution=0.8, seed=1), JL.Louvain(resolution=0.8, seed=1)
        got = m.fit(jadj, random_state=rs).predict()
        np.testing.assert_array_equal(got, jm.fit(jadj, random_state=rs).predict())
    assert m.score(None, dom) == pytest.approx(ari(dom, got))
    assert m.score(None, dom) > 0.5


def test_python_louvain_api_matches_jax():
    adj, _ = _graph(n=200, seed=6)
    for kw in ({}, {"random_state": 7}, {"randomize": True, "random_state": 2},
               {"resolution": 0.5}):
        part = TL.best_partition(adj, **kw)
        assert part == JL.best_partition(adj, **kw)
    assert TL.modularity(part, adj) == JL.modularity(part, adj)
    assert TL.modularity(part, adj) > 0.3
    got, want = TL.induced_graph(part, adj), JL.induced_graph(part, adj)
    assert got.shape == want.shape and abs(got - want).sum() == 0
    dendro = TL.generate_dendrogram(adj, random_state=1)
    assert dendro == JL.generate_dendrogram(adj, random_state=1)
    coarse = {c: c % 2 for c in set(dendro[0].values())}
    assert TL.partition_at_level(dendro + [coarse], 1) == \
        JL.partition_at_level(dendro + [coarse], 1)
    for make in (lambda: 4, lambda: np.random.RandomState(1), lambda: np.random.default_rng(1)):
        assert TL.check_random_state(make()).randint(1000) == \
            JL.check_random_state(make()).randint(1000)
    state = np.random.RandomState(2)
    assert TL.check_random_state(state) is state
    assert isinstance(TL.check_random_state(None), np.random.RandomState)
    with pytest.raises(ValueError, match="cannot be used"):
        TL.check_random_state("x")
    with pytest.raises(ValueError, match="without link"):
        TL.modularity({0: 0, 1: 0}, sp.csr_matrix((2, 2)))


def test_louvain_build_is_keyed_and_raises(tmp_path, monkeypatch):
    kern = _build.build_louvain(tmp_path)
    assert kern.path.parent == tmp_path and kern.path.name.startswith("liblouvain_")
    assert kern.build_seconds > 0 and list(tmp_path.iterdir()) == [kern.path]
    again = _build.build_louvain(tmp_path)
    assert again.path == kern.path and again.build_seconds == 0.0
    monkeypatch.setattr(_build, "HOST_FLAGS", ("-O3", "--no-such-flag", "-shared", "-fPIC"))
    with pytest.raises(RuntimeError, match="failed"):
        _build.build_louvain(tmp_path / "bad")
    assert not any((tmp_path / "bad").iterdir())
