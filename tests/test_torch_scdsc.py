"""Port parity for scDSC (dance_tpu_torch.modules.single_modality.clustering.
scdsc): the model's forward, the weight transfer, short fits from the same
weights, pretrain batches and centres, ``scdsc_preprocess`` against the JAX
pipeline, and the kernel launches of a fit.

Inputs are made with numpy from a seed and handed to both packages; flax
weights are copied into the torch model (scdsc_flax_to_torch), and the
pretrain batch indices and k-means centres of the JAX fit are handed to the
port's. The JAX BSR path runs its Pallas kernel in interpret mode on the
CPU. Tolerances: forwards at rtol 1e-5 (sums in another order); fits of 2
pretrain and 3 DEC epochs at rtol 1e-4, atol 1e-5, as the graph-sc fit test;
preprocessing bit for bit on sparse counts and at float32 rounding on dense
ones, the graph's structure exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dance_tpu.data import AnnData, Data
from dance_tpu.modules.single_modality.clustering.scdsc import ScDSC as JScDSC
from dance_tpu.modules.single_modality.clustering.scdsc import ScDSCModel as JScDSCModel
from dance_tpu.ops import cluster as jcluster
from dance_tpu.ops import pallas_kernels as jpk
from dance_tpu.ops.sparse import csr_from_scipy as jcsr_from_scipy
from dance_tpu.utils.batch import epoch_batches as jepoch_batches
from dance_tpu_torch.modules.single_modality.clustering import ScDSC, ScDSCModel, scdsc_preprocess
from dance_tpu_torch.modules.single_modality.clustering import scdsc as tscdsc
from dance_tpu_torch.ops.sparse import sym_norm_adjacency
from dance_tpu_torch.ops import bsr as tbsr
from dance_tpu_torch.ops.cluster import KMeansResult
from dance_tpu_torch.ops.sparse import CSRMatrix, csr_from_scipy
from dance_tpu_torch.utils.params import scdsc_flax_to_torch
from test_torch_sctag import _counts, _inputs

DIMS = dict(n_enc_1=24, n_enc_2=16, n_enc_3=16, n_z1=12, n_z2=8, n_z3=4, n_dec_1=12,
            n_dec_2=16, n_dec_3=24)
DIM_TUPLE = (24, 16, 16, 12, 8, 4, 12, 16, 24)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("sigma", [1.0, 0.4])
@pytest.mark.parametrize("use_bsr", [False, True])
def test_scdsc_model_forward_matches_jax(use_bsr, sigma):
    (adj, x, _, _), _ = _inputs(5)
    _, adj_n = sym_norm_adjacency(adj)
    jadj = jpk.bsr_from_scipy(adj_n) if use_bsr else jcsr_from_scipy(adj_n)
    jm = JScDSCModel(n_input=x.shape[1], n_clusters=3, sigma=sigma, dims=DIM_TUPLE)
    params = jm.init(jax.random.key(1), jnp.asarray(x), jadj)
    want = jm.apply(params, jnp.asarray(x), jadj)
    tm = ScDSCModel(x.shape[1], 3, sigma=sigma, dims=DIM_TUPLE)
    tm.load_state_dict(scdsc_flax_to_torch(_np_tree(params["params"])))
    tadj = tbsr.bsr_from_scipy(adj_n) if use_bsr else csr_from_scipy(adj_n)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), tadj)
    for name, g, w in zip(("x_bar", "q", "predict", "z", "mean", "disp", "pi"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)


def test_scdsc_flax_to_torch_rejects_unknown_names():
    for bad in ({"LayerNorm_0": {}}, {"ae": {"mid_0": {}}},
                {"gnn_0": {"kernel": np.zeros((2, 2)), "bias": np.zeros(2)}}):
        with pytest.raises(KeyError, match="unexpected"):
            scdsc_flax_to_torch(bad)


@pytest.mark.parametrize("use_bsr,reference_protocol", [(False, False), (True, False),
                                                        (False, True)])
def test_scdsc_fit_matches_jax(use_bsr, reference_protocol, monkeypatch):
    """2 minibatch pretrain epochs (batches of 64 over 150 cells: the last
    one wrap-padded) and 3 DEC epochs from the same weights, batches and
    centres: parameters and ``q``. The DEC stage runs at lr 1e-4: at 1e-3 one
    weight of 384 (``ae.dec.2``) ended 1.9e-5 apart (2.3e-4 relative), every
    other within the bounds; Adam's normalised step turns float32 gradient
    rounding into a gap of the order of lr where a gradient is near zero."""
    inputs, types = _inputs(6)
    x = inputs[1]
    kw = dict(n_clusters=3, n_input=x.shape[1], seed=0, reference_protocol=reference_protocol,
              **DIMS)
    fit_kw = dict(pt_epochs=2, pt_batch_size=64, epochs=3, lr=1e-4, pt_lr=1e-3,
                  use_bsr=use_bsr)
    jm = JScDSC(**kw)
    # the weights JAX draws at its first fit (they depend on the shapes only)
    init = jm.model.init(jax.random.key(0), jnp.asarray(x[:1]), jcsr_from_scipy(
        sp.eye(x.shape[0], format="csr", dtype=np.float32)))["params"]
    centres, jkmeans = {}, jcluster.kmeans

    def record(*args, **kwargs):
        res = jkmeans(*args, **kwargs)
        centres["jax"] = np.asarray(res.centers)
        return res

    monkeypatch.setattr(jcluster, "kmeans", record)
    jm.fit(inputs, types, **fit_kw)
    assert ("jax" in centres) != reference_protocol

    keys = jax.random.split(jax.random.key(0), 2)
    batches = iter([torch.from_numpy(np.asarray(jepoch_batches(k, x.shape[0], 64)))
                    for k in keys])
    monkeypatch.setattr(tscdsc, "epoch_batches", lambda gen, n, bs: next(batches))
    monkeypatch.setattr(tscdsc, "kmeans", lambda z, k, **_: KMeansResult(
        torch.zeros(z.shape[0], dtype=torch.long), torch.tensor(centres["jax"]),
        torch.zeros(())))
    tm = ScDSC(device="cpu", **kw)
    tm.model.load_state_dict(scdsc_flax_to_torch(_np_tree(init)))
    tm.fit(inputs, types, **fit_kw)
    want = scdsc_flax_to_torch(_np_tree(jm.params))
    got = tm.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(tm.q, np.asarray(jm.q), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tm.predict(), np.asarray(jm.predict()))
    assert len(tm.pretrain_history) == 2 and len(tm.history) == 3
    assert tm.dec_out["epoch"] == 3 and not tm.dec_out["stop"]


def test_scdsc_fit_counts_spmm_and_refreshes_every_ten_epochs(monkeypatch):
    """Per epoch the seven GCN aggregations forward and seven ``Aᵀḡ``; the
    refreshes run the autoencoder only."""
    calls = {"spmm": 0, "refresh": 0}
    spmm, assign = tbsr.bsr_spmm, ScDSCModel.assign

    def count(*args, **kw):
        calls["spmm"] += 1
        return spmm(*args, **kw)

    def count_assign(self, z):
        calls["refresh"] += 1
        return assign(self, z)

    monkeypatch.setattr(tbsr, "bsr_spmm", count)
    monkeypatch.setattr(ScDSCModel, "assign", count_assign)
    inputs, types = _inputs(7)
    m = ScDSC(n_clusters=3, n_input=inputs[1].shape[1], device="cpu", **DIMS)
    m.fit(inputs, pt_epochs=1, epochs=12, use_bsr=True)
    assert calls["spmm"] == 12 * 14
    assert calls["refresh"] == 12 + 2  # the training forwards and 2 refreshes
    assert m.q.shape == (150, 3) and m.dec_out["epoch"] == 12
    np.testing.assert_allclose(m.q.sum(1), 1.0, rtol=1e-5)
    m.fit(inputs, pt_epochs=1, epochs=1, use_bsr="auto")  # CSR on the CPU, as JAX off the TPU
    assert calls["spmm"] == 12 * 14 and isinstance(m.adj, CSRMatrix)


@pytest.mark.parametrize("sparse", [True, False])
def test_scdsc_preprocess_matches_jax_pipeline(sparse):
    counts, types = _counts(seed=10)
    x = sp.csr_matrix(counts) if sparse else counts
    adata = AnnData(X=x.copy(), obs={"idx": np.arange(200), "Group": types},
                    var={"gidx": np.arange(260)})
    data = Data(adata)
    JScDSC.preprocessing_pipeline(n_top_genes=80, n_neighbors=8, log_level="WARNING")(data)
    ad = data.data
    (adj, xt, x_raw, n_counts), cells = scdsc_preprocess(x, n_top_genes=80, n_neighbors=8,
                                                         device="cpu")
    np.testing.assert_array_equal(cells, ad.obs["idx"].to_numpy())
    # dense: the JAX AnnData keeps its subsets in Fortran order (another
    # summation order in numpy); sparse: bit for bit
    tol = {"rtol": 0.0, "atol": 0.0} if sparse else {"rtol": 1e-5, "atol": 1e-5}
    np.testing.assert_allclose(xt, ad.X, **tol)
    raw = ad.raw.X.toarray() if sp.issparse(ad.raw.X) else ad.raw.X
    np.testing.assert_allclose(x_raw, raw, **tol)
    np.testing.assert_allclose(n_counts, ad.obs["n_counts"].to_numpy(), **tol)
    jadj = sp.csr_matrix(ad.obsp["NeighborGraph"])
    for field in ("indices", "indptr"):
        np.testing.assert_array_equal(getattr(adj, field), getattr(jadj, field))
    np.testing.assert_allclose(adj.data, jadj.data, rtol=1e-4, atol=1e-6)
