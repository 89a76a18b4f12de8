"""Port parity for DSTG (dance_tpu_torch.modules.spatial.cell_type_deconvo.dstg):
the GCN's forward and gradients, the weight transfer, 3-epoch fits from the
same weights on CSR and on BSR tiles, BSR against CSR, the validation split,
the masked cross-entropy, the SpMM launches of a fit, and the device
defaults.

Inputs are made with numpy from a seed and handed to both packages; flax
weights are copied into the torch net (dstg_flax_to_torch, through a
patched ``DSTG._make_net``). The JAX BSR path runs its Pallas kernel in
interpret mode on the CPU. Tolerances: forwards and gradients at rtol 1e-5
(sums in another order), fits at rtol 1e-4 and atol 1e-5, as the other fit
tests; BSR against CSR at 1e-4, as tests/modules/test_spatial.py:289 holds
the JAX model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dance_tpu.modules.spatial.cell_type_deconvo import dstg as jdstg
from dance_tpu.ops import pallas_kernels as jpk
from dance_tpu.ops.sparse import csr_from_scipy as jcsr_from_scipy
from dance_tpu_torch.modules.spatial.cell_type_deconvo import DSTG
from dance_tpu_torch.modules.spatial.cell_type_deconvo import dstg as tdstg
from dance_tpu_torch.ops import bsr as tbsr
from dance_tpu_torch.ops.sparse import CSRMatrix, csr_from_scipy
from dance_tpu_torch.utils.params import dstg_flax_to_torch

CPU = torch.device("cpu")


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _inputs(seed=0, n=200, d=20, k=4, n_labelled=140):
    """Features, portions over the labelled rows and a symmetric graph with
    self-loops, as tests/modules/test_spatial.py:289 makes them."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, d)).astype(np.float32)
    y = np.zeros((n, k), np.float32)
    y[:n_labelled] = rng.dirichlet(np.ones(k), n_labelled)
    adj = sp.random(n, n, density=0.03, random_state=seed, format="csr", dtype=np.float32)
    return x, y, sp.csr_matrix(adj + adj.T + sp.eye(n, dtype=np.float32))


def _jax_init(x, y, adj, nhid, seed=0, dropout=0.0):
    net = jdstg._GCN(hidden=nhid, out_dim=y.shape[1], dropout=dropout)
    key = jax.random.key(seed)
    return net, net.init({"params": key, "dropout": key}, jcsr_from_scipy(adj),
                         jnp.asarray(x))["params"]


def _load_into(model, state, monkeypatch):
    make = model._make_net

    def made(*args):
        net = make(*args)
        net.load_state_dict(state)
        return net

    monkeypatch.setattr(model, "_make_net", made)


@pytest.mark.parametrize("use_bsr", [False, True])
def test_gcn_forward_and_grads_match_jax(use_bsr):
    x, y, adj = _inputs(1)
    jnet, params = _jax_init(x, y, adj, nhid=16)
    jadj = jpk.bsr_from_scipy(adj) if use_bsr else jcsr_from_scipy(adj)

    def jloss(p):
        pred = jnet.apply({"params": p}, jadj, jnp.asarray(x))
        return -(jnp.asarray(y) * jnp.log(pred + 1e-10)).sum(), pred

    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    tnet = tdstg._GCN(x.shape[1], 16, y.shape[1], dropout=0.0)
    tnet.load_state_dict(dstg_flax_to_torch(_np_tree(params)))
    tadj = tbsr.bsr_from_scipy(adj) if use_bsr else csr_from_scipy(adj)
    pred = tnet(tadj, torch.from_numpy(x))
    (-(torch.from_numpy(y) * torch.log(pred + 1e-10)).sum()).backward()
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    want_grads = dstg_flax_to_torch(_np_tree(jgrads))
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=1e-5,
                                   atol=1e-6 * float(np.abs(want_grads[name].numpy()).max()))


def test_dstg_flax_to_torch_rejects_unknown_parameters():
    with pytest.raises(KeyError):
        dstg_flax_to_torch({"Dense_2": {"kernel": np.zeros((2, 2))}})


@pytest.mark.parametrize("use_bsr,weight_decay", [(False, 0.0), (True, 0.0), (False, 1e-3)])
def test_fit_matches_jax(use_bsr, weight_decay, monkeypatch):
    """3 epochs from the same weights: Adam, or AdamW with weight decay."""
    x, y, adj = _inputs(2)
    _, init = _jax_init(x, y, adj, nhid=16)
    jm = jdstg.DSTG(nhid=16, seed=0)
    jm.fit((x, adj), y, max_epochs=3, weight_decay=weight_decay, use_bsr=use_bsr)
    tm = DSTG(nhid=16, seed=0, device="cpu")
    _load_into(tm, dstg_flax_to_torch(_np_tree(init)), monkeypatch)
    tm.fit((x, adj), y, max_epochs=3, weight_decay=weight_decay, use_bsr=use_bsr)
    want = dstg_flax_to_torch(_np_tree(jm.params))
    for name, p in tm.net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(tm.predict(), jm.predict(), rtol=1e-4, atol=1e-5)
    if use_bsr:
        np.testing.assert_array_equal(tm._perm, np.asarray(jm._perm))
    assert len(tm.history) == 3 and all(np.isfinite(h["loss"]) for h in tm.history)
    s, pred = tm.score(None, y, return_pred=True, test_idx=np.arange(140, 200))
    assert pred.shape == (60, 4) and s == pytest.approx(
        jm.score(None, y, test_idx=np.arange(140, 200)), rel=1e-4)


def test_bsr_matches_csr():
    """As tests/modules/test_spatial.py:289 holds the JAX model: 10 epochs on
    the RCM-banded tiles and on CSR give the same portions."""
    x, y, adj = _inputs(0)
    preds = {}
    for use_bsr in (False, True):
        m = DSTG(nhid=16, seed=0, device="cpu")
        m.fit((x, adj), y, max_epochs=10, use_bsr=use_bsr)
        preds[use_bsr] = m.predict()
        assert isinstance(m.adj, tbsr.BSRMatrix if use_bsr else CSRMatrix)
    np.testing.assert_allclose(preds[False], preds[True], atol=1e-4)
    np.testing.assert_allclose(preds[True].sum(1), 1.0, rtol=1e-5)


def test_fit_counts_spmm_launches_and_auto_is_csr(monkeypatch):
    """Two aggregations forward and two ``Aᵀḡ`` an epoch (both layers' inputs
    carry gradient), two in ``predict``; ``"auto"`` is CSR on the CPU."""
    calls = {"spmm": 0}
    spmm = tbsr.bsr_spmm

    def count(*args, **kw):
        calls["spmm"] += 1
        return spmm(*args, **kw)

    monkeypatch.setattr(tbsr, "bsr_spmm", count)
    x, y, adj = _inputs(3)
    m = DSTG(nhid=8, seed=0, device="cpu")
    m.fit((x, adj), y, max_epochs=5, use_bsr=True)
    m.predict()
    assert calls["spmm"] == 4 * 5 + 2
    m.fit((x, adj), y, max_epochs=2)  # "auto": CSR on the CPU, as JAX's off the TPU
    assert calls["spmm"] == 22 and isinstance(m.adj, CSRMatrix) and m._perm is None


def test_dropout_draws_from_the_seeded_generator():
    x, y, adj = _inputs(4)
    runs = [DSTG(nhid=8, dropout=0.5, seed=s, device="cpu").fit((x, adj), y, max_epochs=4)
            .predict() for s in (0, 0, 1)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.allclose(runs[0], runs[2])


@pytest.mark.parametrize("ratio,seed", [(0.3, 0), (0.5, 3), (0.0, 1)])
def test_split_mask_for_validation_matches_jax(ratio, seed):
    mask = np.zeros(100, bool)
    mask[:60] = True
    want = jdstg.split_mask_for_validation(mask, valid_ratio=ratio, random_seed=seed)
    got = tdstg.split_mask_for_validation(mask, valid_ratio=ratio, random_seed=seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not (got[0] & got[1]).any() and not (got[0] | got[1])[60:].any()
    with pytest.raises(ValueError):
        tdstg.split_mask_for_validation(mask, valid_ratio=1.5)


def test_masked_softmax_cross_entropy_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((30, 4)).astype(np.float32)
    labels = rng.dirichlet(np.ones(4), 30).astype(np.float32)
    mask = rng.random(30) < 0.4
    want = jdstg.masked_softmax_cross_entropy(logits, labels, mask)
    got = tdstg.masked_softmax_cross_entropy(torch.from_numpy(logits), labels, mask)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_dstg_needs_a_card_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='auto'"):
        DSTG()
    assert DSTG(device="cpu").device == CPU
