"""Port parity for scTAG (dance_tpu_torch.modules.single_modality.clustering.
sctag): the net's forward, the weight transfer, short fits from the same
weights and centres, ``sctag_preprocess`` against the JAX pipeline, the
kernel launches of a fit, and the device defaults of the entry points.

Inputs are made with numpy from a seed and handed to both packages; flax
weights are copied into the torch net (sctag_flax_to_torch) and the k-means
centres the JAX fit draws are handed to the port's fit. The JAX BSR path
runs its Pallas kernel in interpret mode on the CPU. Tolerances: forwards at
rtol 1e-5 (sums in another order); fits of 2 pretrain and 3 DEC epochs at
rtol 1e-4, atol 1e-5, as the graph-sc fit test; preprocessing bit for bit
on sparse counts and at float32 rounding on dense ones, the PCA and the
graph's weights at rtol 1e-4, its structure exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dance_tpu.data import AnnData, Data
from dance_tpu.modules.single_modality.clustering.sctag import ScTAG as JScTAG
from dance_tpu.modules.single_modality.clustering.sctag import _ScTAGNet as JScTAGNet
from dance_tpu.ops import cluster as jcluster
from dance_tpu.ops import pallas_kernels as jpk
from dance_tpu.ops.sparse import csr_from_scipy as jcsr_from_scipy
from dance_tpu_torch.modules.single_modality.clustering import ScDSC, ScTAG, sctag_preprocess
from dance_tpu_torch.modules.single_modality.clustering import sctag as tsctag
from dance_tpu_torch.modules.single_modality.clustering.sctag import _ScTAGNet
from dance_tpu_torch.modules.single_modality.clustering.scdsc import scdsc_preprocess
from dance_tpu_torch.ops import bsr as tbsr
from dance_tpu_torch.ops.cluster import KMeansResult
from dance_tpu_torch.ops.neighbors import knn_graph
from dance_tpu_torch.ops.sparse import CSRMatrix, csr_from_scipy, sym_norm_adjacency
from dance_tpu_torch.transforms import cell_pca
from dance_tpu_torch.utils.params import sctag_flax_to_torch

NET = {"hidden_dim": 16, "latent_dim": 4, "k": 2}
DEC = (8, 12)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _inputs(seed=0, n=150, g=30, n_types=3):
    """A gauss kNN graph of clustered points, features, counts and their
    totals: the four inputs of ``fit``, and the types."""
    rng = np.random.default_rng(seed)
    types = rng.integers(0, n_types, n)
    centres = rng.normal(0, 3, (n_types, 6))
    pts = (centres[types] + rng.normal(0, 1, (n, 6))).astype(np.float32)
    adj = knn_graph(pts, 8, mode="gauss", include_self=False, symmetrize=True)
    x = (rng.normal(0, 1, (n, g)) + types[:, None] * 0.5).astype(np.float32)
    x_raw = rng.poisson(np.exp(rng.normal(0, 1, (n_types, g)))[types]).astype(np.float32)
    return (adj, x, x_raw, x_raw.sum(1)), types


def _jnet(in_dim):
    return JScTAGNet(in_dim=in_dim, hidden_dim=NET["hidden_dim"], latent_dim=NET["latent_dim"],
                     dec_dims=DEC, k=NET["k"], dropout=0.0)


@pytest.mark.parametrize("use_bsr", [False, True])
def test_sctag_net_forward_matches_jax(use_bsr):
    (adj, x, _, _), _ = _inputs(1)
    _, adj_n = sym_norm_adjacency(adj)
    jadj = jpk.bsr_from_scipy(adj_n) if use_bsr else jcsr_from_scipy(adj_n)
    jnet = _jnet(x.shape[1])
    params = jnet.init(jax.random.key(0), jadj, jnp.asarray(x))
    want = jnet.apply(params, jadj, jnp.asarray(x))
    net = _ScTAGNet(x.shape[1], NET["hidden_dim"], NET["latent_dim"], DEC, NET["k"], 0.0)
    net.load_state_dict(sctag_flax_to_torch(_np_tree(params["params"])))
    tadj = tbsr.bsr_from_scipy(adj_n) if use_bsr else csr_from_scipy(adj_n)
    with torch.no_grad():
        got = net(tadj, torch.from_numpy(x))
    for name, g, w in zip(("z", "adj", "mean", "disp", "pi"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)


def test_sctag_flax_to_torch_rejects_unknown_names():
    with pytest.raises(KeyError, match="unexpected"):
        sctag_flax_to_torch({"LayerNorm_0": {}})
    with pytest.raises(KeyError, match="unexpected"):
        sctag_flax_to_torch({"encoder1": {"Dense_0": {"kernel": np.zeros((2, 2)),
                                                      "scale": np.zeros(2)}}})


@pytest.mark.parametrize("use_bsr", [False, True])
def test_sctag_fit_matches_jax(use_bsr, monkeypatch):
    """2 pretrain and 3 DEC epochs of Adam from the same weights and k-means
    centres: parameters, centres, ``q`` (the best-ARI epoch's pre-update
    assignments) and ``z``."""
    inputs, types = _inputs(2)
    x = inputs[1]
    kw = dict(n_clusters=3, dec_dim=DEC, seed=0, **NET)
    jm = JScTAG(dropout=0.0, **kw)
    # the weights JAX's init_model draws (they depend on the shapes only)
    init = _jnet(x.shape[1]).init(
        jax.random.key(0), jcsr_from_scipy(sp.eye(x.shape[0], format="csr", dtype=np.float32)),
        jnp.asarray(x))["params"]
    centres = {}
    jkmeans = jcluster.kmeans

    def record(*args, **kwargs):
        res = jkmeans(*args, **kwargs)
        centres["jax"] = np.asarray(res.centers)
        return res

    monkeypatch.setattr(jcluster, "kmeans", record)
    fit_kw = dict(pretrain_epochs=2, epochs=3, lr=1e-3, use_bsr=use_bsr)
    jm.fit(inputs, types, **fit_kw)

    tm = ScTAG(device="cpu", **kw)
    tm.init_model(inputs[0], x)
    tm.net.load_state_dict(sctag_flax_to_torch(_np_tree(init)))
    monkeypatch.setattr(tsctag, "kmeans", lambda z, k, **_: KMeansResult(
        torch.zeros(z.shape[0], dtype=torch.long), torch.tensor(centres["jax"]),
        torch.zeros(())))
    tm.fit(inputs, types, **fit_kw)
    want = sctag_flax_to_torch(_np_tree(jm.params))
    got = tm.net.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(tm.mu.detach().numpy(), np.asarray(jm.mu), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tm.q, np.asarray(jm.q), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tm.z, np.asarray(jm.z), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tm.predict(), np.asarray(jm.predict()))
    assert len(tm.pretrain_history) == 2 and len(tm.history) == 3
    assert all(np.isfinite(h["loss"]) and h["seconds"] >= 0 for h in tm.history)


def test_sctag_fit_counts_spmm_and_keeps_the_last_q_without_labels(monkeypatch):
    """Per epoch 2 x k forward hops and k ``Aᵀḡ`` hops of the second encoder
    (the first runs on the constant features); one more encode for k-means."""
    calls = {"spmm": 0}
    spmm = tbsr.bsr_spmm

    def count(*args, **kw):
        calls["spmm"] += 1
        return spmm(*args, **kw)

    monkeypatch.setattr(tbsr, "bsr_spmm", count)
    inputs, types = _inputs(3)
    m = ScTAG(n_clusters=3, dec_dim=DEC, device="cpu", **NET)
    m.fit(inputs, pretrain_epochs=2, epochs=3, use_bsr=True)
    k = NET["k"]
    assert calls["spmm"] == (2 + 3) * 3 * k + 2 * k
    assert m.q.shape == (150, 3) and m.z.shape == (150, NET["latent_dim"])
    np.testing.assert_allclose(m.q.sum(1), 1.0, rtol=1e-5)
    assert m.predict().shape == (150,) and m.is_pretrained
    m.fit(inputs, epochs=1, use_bsr="auto")  # CSR on the CPU, as JAX's "auto" off the TPU
    assert calls["spmm"] == (2 + 3) * 3 * k + 2 * k and isinstance(m.adj_n, CSRMatrix)
    m.fit(inputs, pretrain_epochs=5, epochs=0, use_bsr=False)  # pretrained: skipped
    assert len(m.pretrain_history) == 2 and not m.q.any()


def test_sctag_pretrain_path_round_trip(tmp_path):
    inputs, _ = _inputs(4)
    path = str(tmp_path / "sctag.pt")
    first = ScTAG(n_clusters=3, dec_dim=DEC, device="cpu", pretrain_path=path, **NET)
    first.fit(inputs, pretrain_epochs=2, epochs=0, use_bsr=False)
    second = ScTAG(n_clusters=3, dec_dim=DEC, device="cpu", pretrain_path=path, seed=5, **NET)
    second.fit(inputs, pretrain_epochs=2, epochs=0, use_bsr=False)
    assert second.pretrain_history == []  # loaded, not pretrained
    for k, v in first.net.state_dict().items():
        assert torch.equal(second.net.state_dict()[k], v)


def _counts(n=200, g=260, seed=9, fold=10.0, frac=0.3):
    rng = np.random.default_rng(seed)
    types = rng.integers(0, 3, n)
    rates = rng.gamma(0.6, 2.0, g) * (rng.random(g) > 0.05)
    fold = np.where(rng.random((3, g)) < frac, fold, 1.0)
    lam = fold[types] * rates[None] * rng.gamma(3.0, 1 / 3, (n, 1))
    counts = rng.poisson(lam) * (rng.random((n, g)) < 0.4)
    counts[11] = 0           # a cell without counts is dropped
    counts[:, 5] = 0         # genes under 3 counts are dropped
    counts[0, 6], counts[:, 6] = 2, 0
    return counts.astype(np.float32), types


@pytest.mark.parametrize("sparse", [True, False])
def test_sctag_preprocess_matches_jax_pipeline(sparse):
    counts, types = _counts()
    x = sp.csr_matrix(counts) if sparse else counts
    adata = AnnData(X=x.copy(), obs={"idx": np.arange(200), "Group": types},
                    var={"gidx": np.arange(260)})
    data = Data(adata)
    JScTAG.preprocessing_pipeline(n_top_genes=80, n_components=6, n_neighbors=8,
                                  log_level="WARNING")(data)
    ad = data.data
    (adj, xt, x_raw, n_counts), cells = sctag_preprocess(x, n_top_genes=80, n_components=6,
                                                         n_neighbors=8, device="cpu")
    np.testing.assert_array_equal(cells, ad.obs["idx"].to_numpy())
    assert 11 not in cells
    # dense: the JAX AnnData keeps its subsets in Fortran order, where numpy
    # sums a row's float32 values in another order; sparse: bit for bit
    tol = {"rtol": 0.0, "atol": 0.0} if sparse else {"rtol": 1e-5, "atol": 1e-5}
    np.testing.assert_allclose(xt, ad.X, **tol)
    raw = ad.raw.X.toarray() if sp.issparse(ad.raw.X) else ad.raw.X
    np.testing.assert_allclose(x_raw, raw, **tol)
    np.testing.assert_allclose(n_counts, ad.obs["n_counts"].to_numpy(), **tol)
    np.testing.assert_allclose(cell_pca(xt, 6, device="cpu"), ad.obsm["CellPCA"], rtol=1e-4,
                               atol=1e-4)
    jadj = sp.csr_matrix(ad.obsp["NeighborGraph"])
    for field in ("indices", "indptr"):
        np.testing.assert_array_equal(getattr(adj, field), getattr(jadj, field))
    # the gauss weights follow the PCA's distances
    np.testing.assert_allclose(adj.data, jadj.data, rtol=1e-4, atol=1e-6)


def test_entry_points_raise_without_a_card_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    counts, _ = _counts(n=60, g=80)
    calls = {
        "ScTAG": lambda **kw: ScTAG(n_clusters=2, **kw),
        "ScDSC": lambda **kw: ScDSC(n_input=8, n_clusters=2, **kw),
        "sctag_preprocess": lambda **kw: sctag_preprocess(counts, n_top_genes=20,
                                                          n_components=4, n_neighbors=5, **kw),
        "scdsc_preprocess": lambda **kw: scdsc_preprocess(counts, n_top_genes=20,
                                                          n_neighbors=5, **kw),
        "cell_pca": lambda **kw: cell_pca(counts, 3, **kw),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        call(device="cpu")  # runs
