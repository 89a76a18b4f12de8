"""Port parity for DSTG (dance_tpu_torch.modules.spatial.cell_type_deconvo.dstg):
the GCN's forward and gradients, the weight transfer, 3-epoch fits from the
same weights on CSR and on BSR tiles, BSR against CSR, the validation split,
the masked cross-entropy, the SpMM launches of a fit, the device defaults,
and the reference-named link-graph helpers on arrays (the CCA, its top
genes, the kNN bundle, MNN pairs, the gene-confirmed edge list).

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


# --------------------------------------------------------------------------
# the reference-named link-graph helpers on arrays (dstg_graph.py:119-202,
# preprocess.py:292-368): the JAX side on pandas frames of genes x spots with
# named spots and genes, the port on the arrays, spots and genes by index.
# Float64 on both sides: the CCA at 1e-8 (two SVDs of one matrix), the kNN
# bundles and edge lists exactly; top-gene sets as sets (JAX returns
# ``list(set(...))``, whose order follows string hashes).
# --------------------------------------------------------------------------

def _link_case(seed=0, n_genes=60, n1=70, n2=50):
    from torch_cases import deconvo_case

    x_ref, _, x_spots, _, _ = deconvo_case(n_ref=n1, n_genes=n_genes, n_spots=n2, seed=seed)
    return np.log1p(x_ref).T.astype(np.float64), np.log1p(x_spots).T.astype(np.float64)


def _frames(pseudo, real):
    import pandas as pd

    genes = [f"gene{j}" for j in range(pseudo.shape[0])]
    return (pd.DataFrame(pseudo, index=genes, columns=[f"p{i}" for i in range(pseudo.shape[1])]),
            pd.DataFrame(real, index=genes, columns=[f"r{i}" for i in range(real.shape[1])]))


def test_l2norm_and_cca_embed_match_jax():
    from dance_tpu.transforms import preprocess as jpre
    from dance_tpu_torch.transforms import preprocess as tpre

    pseudo, real = _link_case(seed=1)
    rows = np.vstack([pseudo[:5], np.zeros((1, pseudo.shape[1]))])
    np.testing.assert_array_equal(tpre.l2norm(rows), jpre.l2norm(rows))
    (jemb, jd), jload = jpre.ccaEmbed(*_frames(pseudo, real), num_cc=8)
    (emb, d), load = tpre.ccaEmbed(pseudo, real, num_cc=8, device=CPU)
    np.testing.assert_allclose(emb, jemb.to_numpy(), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(d, jd, rtol=1e-10)
    np.testing.assert_allclose(load, jload.to_numpy(), rtol=1e-8, atol=1e-8)
    assert (emb[0] >= 0).all() and emb.shape == (120, 8)


@pytest.mark.parametrize("dim_genes,max_genes", [(100, 200), (6, 20)])
def test_sort_and_select_top_genes_match_jax(dim_genes, max_genes):
    import pandas as pd

    from dance_tpu.transforms import preprocess as jpre
    from dance_tpu_torch.transforms import preprocess as tpre

    load = np.random.default_rng(2).standard_normal((60, 5))
    frame = pd.DataFrame(load, index=[f"gene{j}" for j in range(60)])
    for dim, num in ((0, 7), (3, 10)):
        want = [int(g[4:]) for g in jpre.sortGenes(frame, dim, num)]
        np.testing.assert_array_equal(tpre.sortGenes(load, dim, num), want)
    want = {int(g[4:]) for g in jpre.selectTopGenes(frame, range(5), dim_genes, max_genes)}
    got = tpre.selectTopGenes(load, range(5), dim_genes, max_genes)
    assert set(got.tolist()) == want and list(got) == sorted(got)


def test_query_knn_knn_and_mnn_match_jax():
    import pandas as pd

    from dance_tpu.transforms.graph import dstg_graph as jdg
    from dance_tpu_torch.transforms.graph import dstg_graph as tdg

    emb = np.random.default_rng(3).standard_normal((90, 6))
    names = np.array([f"s{i}" for i in range(90)])
    frame = pd.DataFrame(emb, index=names)
    s1, s2 = np.arange(50), np.arange(50, 90)
    want = jdg.knn(frame, names[s1], names[s2], k=6)
    got = tdg.knn(emb, s1, s2, k=6)
    for w, g in zip(want[:4], got[:4]):
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[0], w[0])
    d1, i1 = tdg.query_knn(emb, 1)
    assert i1.shape == (90, 1) and (i1[:, 0] == np.arange(90)).all() and (d1 == 0).all()
    colnames = names[np.r_[0:40, 50:90]]  # ten spots of set 1 missing: they have no pairs
    want_e = jdg.mnn(want, colnames, 5).to_numpy()
    got_e = tdg.mnn(got, np.r_[0:40, 50:90])
    np.testing.assert_array_equal(got_e, want_e)
    assert len(got_e) > 0 and got_e[:, 0].max() < 40


def test_filter_edge_construct_link_graph_and_preprocess_adj_match_jax():
    from dance_tpu.transforms.graph import dstg_graph as jdg
    from dance_tpu_torch.transforms.graph import dstg_graph as tdg

    pseudo, real = _link_case(seed=4)
    jp, jr = _frames(pseudo, real)
    for k_filter in (200, 8):
        want = jdg.construct_link_graph(jp, jr, k_filter=k_filter, num_cc=10)
        got = tdg.construct_link_graph(pseudo, real, k_filter=k_filter, num_cc=10, device=CPU)
        np.testing.assert_array_equal(got, want[["spot1", "spot2"]].to_numpy())
        assert len(got) > 0
    adj = sp.random(30, 30, density=0.2, random_state=4)
    adj = adj + adj.T
    for a in (adj, adj.toarray()):
        want, got = jdg.preprocess_adj(a), tdg.preprocess_adj(a)
        np.testing.assert_array_equal(got.toarray(), want.toarray())
