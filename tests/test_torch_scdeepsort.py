"""Port parity for the scDeepSort slice: Graph, AdaptiveSAGE, GNN/ScDeepSort.

Inputs are made with numpy from a seed and handed to both packages; the flax
weights are copied into the torch modules (flax_to_torch), since the two
frameworks draw other initial weights from the same seed. The JAX BSR path
runs the Pallas kernels in interpret mode on the CPU, as tests/test_gnn.py
does. Tolerances are stated per test: graph arrays bit-exact, float32
forward and gradients at 1e-5 relative (sums in another order), training
trajectories at 1e-4.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dance_tpu.graph import Graph as JGraph
from dance_tpu.modules.single_modality.cell_type_annotation import ScDeepSort as JScDeepSort
from dance_tpu.nn.gnn import AdaptiveSAGE as JAdaptiveSAGE
from dance_tpu_torch.graph import Graph
from dance_tpu_torch.modules.single_modality.cell_type_annotation import GNN, ScDeepSort
from dance_tpu_torch.nn.gnn import AdaptiveSAGE
from dance_tpu_torch.ops import bsr as tbsr
from dance_tpu_torch.ops.sparse import AdaptiveBSR, csr_from_scipy
from dance_tpu_torch.utils import acc, resolve_device
from dance_tpu_torch.utils.params import flax_to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(seed=0, n_cells=60, n_genes=25, dim=6, density=0.25):
    rng = np.random.default_rng(seed)
    expr = sp.random(n_cells, n_genes, density=density, random_state=seed,
                     dtype=np.float32, format="csr")
    return (expr, rng.random((n_cells, dim), dtype=np.float32),
            rng.random((n_genes, dim), dtype=np.float32), rng)


def _graphs(seed=0, **kw):
    expr, cf, gf, rng = _inputs(seed, **kw)
    return (JGraph.from_cell_feature_matrix(expr, cf, gf),
            Graph.from_cell_feature_matrix(expr, cf, gf), rng)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


# --------------------------------------------------------------------------
# Graph
# --------------------------------------------------------------------------


@pytest.mark.parametrize("normalize_edges", [True, False])
@pytest.mark.parametrize("add_self_loop", [True, False])
def test_graph_bit_identical(normalize_edges, add_self_loop):
    expr, cf, gf, _ = _inputs(3)
    j = JGraph.from_cell_feature_matrix(expr, cf, gf, normalize_edges=normalize_edges,
                                        add_self_loop=add_self_loop)
    t = Graph.from_cell_feature_matrix(expr, cf, gf, normalize_edges=normalize_edges,
                                       add_self_loop=add_self_loop)
    for field in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(t.adj, field), getattr(j.adj, field))
    assert t.adj.dtype == j.adj.dtype and t.adj.shape == j.adj.shape
    assert t.info == j.info and set(t.ndata) == set(j.ndata)
    for k in j.ndata:
        np.testing.assert_array_equal(t.ndata[k], j.ndata[k])


def test_subgraph_and_to_device_match_jax():
    j, t, rng = _graphs(4)
    idx = np.sort(rng.choice(t.num_nodes, 40, replace=False))
    js, ts = j.subgraph(idx), t.subgraph(idx)
    for field in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(ts.adj, field), getattr(js.adj, field))
    jd, td = j.to_device(), t.to_device("cpu")
    np.testing.assert_array_equal(td.adj.data.numpy(), np.asarray(jd.adj.data))
    np.testing.assert_array_equal(td.adj.indices.numpy(), np.asarray(jd.adj.indices))
    np.testing.assert_array_equal(td.adj.indptr.numpy(), np.asarray(jd.adj.indptr))
    np.testing.assert_array_equal(td.adj.row_ids().numpy(), np.asarray(jd.adj.row_ids()))
    for k in jd.ndata:
        np.testing.assert_array_equal(td.ndata[k].numpy(), np.asarray(jd.ndata[k]))


def test_to_adaptive_bsr_matches_jax():
    j, t, _ = _graphs(5, n_cells=200, n_genes=90)
    ja, ta = j.to_adaptive_bsr(), t.to_adaptive_bsr(device="cpu")
    assert isinstance(ta, AdaptiveBSR) and ta.n_genes == ja.n_genes
    assert ta.bsr.shape == ja.bsr.shape and ta.shape == ja.shape
    np.testing.assert_array_equal(ta.bsr.tiles.numpy(), np.asarray(ja.bsr.blocks))
    np.testing.assert_array_equal(ta.bsr.block_rows.numpy(), np.asarray(ja.bsr.block_rows))
    np.testing.assert_array_equal(ta.bsr.block_cols.numpy(), np.asarray(ja.bsr.block_cols))
    for field in ("w_diag", "gene_idx", "deg"):
        np.testing.assert_array_equal(getattr(ta, field).numpy(), np.asarray(getattr(ja, field)))


def test_edge_alpha_index_matches_jax():
    _, t, _ = _graphs(6)
    adj = csr_from_scipy(t.adj)
    rows, cols = adj.row_ids().numpy(), adj.indices.numpy()
    gene_id, n_genes = t.ndata["cell_id"], t.info["num_genes"]
    np.testing.assert_array_equal(
        AdaptiveSAGE.edge_alpha_index(rows, cols, gene_id, n_genes).numpy(),
        JAdaptiveSAGE.edge_alpha_index(rows, cols, gene_id, n_genes))


# --------------------------------------------------------------------------
# AdaptiveSAGE: forward and gradients with transferred weights
# --------------------------------------------------------------------------


@pytest.mark.parametrize("branch", ["bsr", "csr", "dense"])
def test_adaptive_sage_forward_and_grads_match_jax(branch):
    j, t, rng = _graphs(7)
    n_genes = t.info["num_genes"]
    alpha = rng.normal(1.0, 0.3, n_genes + 2).astype(np.float32)
    h = np.asarray(t.ndata["features"])
    w_out = rng.standard_normal((t.num_nodes, 8)).astype(np.float32)

    jd = j.to_device()
    jadj = jd.adj if branch == "csr" else j.to_adaptive_bsr(dense=branch == "dense")
    gene_id = jd.ndata["cell_id"]
    jlayer = JAdaptiveSAGE(out_dim=8, dropout=0.0)
    params = jlayer.init(jax.random.key(0), jadj, jnp.asarray(h), gene_id,
                         jnp.asarray(alpha))["params"]

    def jloss(params, h, alpha):
        return jnp.sum(jlayer.apply({"params": params}, jadj, h, gene_id, alpha) * w_out)

    jout = jlayer.apply({"params": params}, jadj, jnp.asarray(h), gene_id, jnp.asarray(alpha))
    jg_params, jg_h, jg_alpha = jax.grad(jloss, argnums=(0, 1, 2))(
        params, jnp.asarray(h), jnp.asarray(alpha))

    layer = AdaptiveSAGE(h.shape[1], 8, dropout=0.0)
    p = _np_tree(params)
    layer.load_state_dict({"linear.weight": torch.tensor(p["Dense_0"]["kernel"].T),
                           "linear.bias": torch.tensor(p["Dense_0"]["bias"]),
                           "norm.weight": torch.tensor(p["LayerNorm_0"]["scale"]),
                           "norm.bias": torch.tensor(p["LayerNorm_0"]["bias"])})
    tadj = (csr_from_scipy(t.adj) if branch == "csr"
            else t.to_adaptive_bsr(dense=branch == "dense", device="cpu"))
    th = torch.from_numpy(h.copy()).requires_grad_(True)
    talpha = torch.from_numpy(alpha.copy()).requires_grad_(True)
    tgene = torch.from_numpy(t.ndata["cell_id"].astype(np.int64))
    out = layer(tadj, th, tgene, talpha)
    (out * torch.from_numpy(w_out)).sum().backward()

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jg_h), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(talpha.grad.numpy(), np.asarray(jg_alpha), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(layer.linear.weight.grad.numpy(),
                               np.asarray(jg_params["Dense_0"]["kernel"]).T,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(layer.norm.weight.grad.numpy(),
                               np.asarray(jg_params["LayerNorm_0"]["scale"]),
                               rtol=1e-4, atol=1e-5)


def test_layernorm_eps_is_flax():
    assert AdaptiveSAGE(4, 4).norm.eps == 1e-6


# --------------------------------------------------------------------------
# The slice as a whole: JAX and port training steps from the same weights
# --------------------------------------------------------------------------


def _jax_train_state(model: JScDeepSort, graph: JGraph, labels, val_ratio=0.2):
    """Rebuild the inputs JAX ``fit`` hands to ``_train_step``."""
    n_genes, n_cells = graph.info["num_genes"], graph.info["num_cells"]
    perm = np.random.default_rng(model.seed).permutation(n_cells) + n_genes
    train_idx = perm[int(n_cells * val_ratio):]
    full = -np.ones(n_genes + n_cells, np.int32)
    full[n_genes:] = labels
    mask = np.isin(np.arange(len(full)), train_idx).astype(np.float32)
    dg, gene_id, conv_adj = model._dev_cache
    return conv_adj, dg.ndata["features"], gene_id, jnp.asarray(full), jnp.asarray(mask)


@pytest.mark.parametrize("use_bsr,weight_decay,bf16", [
    pytest.param(True, 0.0, False, id="True-0.0"),
    pytest.param(True, 1e-2, False, id="True-0.01"),
    pytest.param(False, 0.0, False, id="False-0.0"),
    pytest.param(True, 0.0, True, id="True-0.0-bf16")])
def test_slice_three_steps_match_jax(use_bsr, weight_decay, bf16):
    """Three Adam steps of each package from the same weights; with ``bf16``
    both stream the SpMM in bf16 (``bsr_dtype``), forward and backward."""
    j, t, rng = _graphs(1, n_cells=80, n_genes=30)
    labels = rng.integers(0, 3, 80)
    jm = JScDeepSort(dim_in=6, dim_hid=16, num_layers=2, seed=0)
    jm.fit(j, labels, epochs=0, lr=1e-2, weight_decay=weight_decay, use_bsr=use_bsr,
           bsr_dtype=jnp.bfloat16 if bf16 else None)
    tm = ScDeepSort(dim_in=6, dim_hid=16, num_layers=2, seed=0, device="cpu")
    tm.fit(t, labels, epochs=0, lr=1e-2, weight_decay=weight_decay, use_bsr=use_bsr,
           bsr_dtype=torch.bfloat16 if bf16 else None)
    assert all(layer.bsr_dtype == (torch.bfloat16 if bf16 else None)
               for layer in tm.model.layers)
    tm.model.load_state_dict(flax_to_torch(_np_tree(jm.params)))

    adj, feats, gene_id, full, mask = _jax_train_state(jm, j, labels)
    params, opt_state = jm.params, jm._tx.init(jm.params)
    key = jax.random.key(0)
    for step in range(3):
        params, opt_state, jloss = jm._train_step(params, opt_state, adj, feats, gene_id,
                                                  full, mask, key, jm._alpha_idx)
        tloss = tm.train_step()
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4, atol=1e-4,
                                   err_msg=f"loss at step {step}")
    want = flax_to_torch(_np_tree(params))
    got = tm.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    jm.params = params
    np.testing.assert_allclose(tm.predict_proba(t), jm.predict_proba(j), rtol=1e-4,
                               atol=1e-4)


def test_flax_to_torch_covers_state_dict():
    j, t, rng = _graphs(2)
    labels = rng.integers(0, 4, 60)
    jm = JScDeepSort(dim_in=6, dim_hid=16, num_layers=3, seed=0)
    jm.fit(j, labels, epochs=0, use_bsr=True)
    state = flax_to_torch(_np_tree(jm.params))
    model = GNN(6, 4, 16, 3, t.info["num_genes"])
    ref = model.state_dict()
    assert set(state) == set(ref)
    for k, v in ref.items():
        assert state[k].shape == v.shape and state[k].dtype == torch.float32, k
    model.load_state_dict(state)


# --------------------------------------------------------------------------
# Port behaviour
# --------------------------------------------------------------------------


def test_bsr_and_csr_branches_train_alike():
    _, t, rng = _graphs(8, n_cells=80, n_genes=30)
    labels = rng.integers(0, 3, 80)
    runs = []
    for use_bsr in (True, False):
        m = ScDeepSort(dim_in=6, dim_hid=16, num_layers=2, seed=0, device="cpu")
        m.fit(t, labels, epochs=4, lr=1e-2, use_bsr=use_bsr)
        runs.append(([h["loss"] for h in m.history], m.predict_proba(t)))
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-5)
    np.testing.assert_allclose(runs[0][1], runs[1][1], rtol=1e-4, atol=1e-5)


def test_fit_counts_one_spmm_per_layer_and_direction(monkeypatch):
    """Each epoch: two forward SpMMs and two backward dB SpMMs (alpha scales
    h, so the first layer's input needs its gradient too), plus two for the
    validation forward; dA is never computed for AdaptiveBSR's constant tiles."""
    calls = {"spmm": 0, "sddmm": 0}
    spmm, sddmm = tbsr.bsr_spmm, tbsr.bsr_sddmm

    def count(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(tbsr, "bsr_spmm", count("spmm", spmm))
    monkeypatch.setattr(tbsr, "bsr_sddmm", count("sddmm", sddmm))
    _, t, rng = _graphs(9)
    m = ScDeepSort(dim_in=6, dim_hid=8, num_layers=2, seed=0, device="cpu")
    m.fit(t, rng.integers(0, 3, 60), epochs=3, use_bsr=True)
    assert calls == {"spmm": 3 * (4 + 2), "sddmm": 0}


def test_val_ratio_zero_keeps_trained_weights():
    """The JAX fit returns the initial weights when val_ratio=0
    (scdeepsort.py:178-195); the port keeps the last ones."""
    _, t, rng = _graphs(10)
    labels = rng.integers(0, 3, 60)
    init = ScDeepSort(dim_in=6, dim_hid=8, num_layers=2, seed=0, device="cpu")
    init.fit(t, labels, epochs=0, val_ratio=0.0)
    trained = ScDeepSort(dim_in=6, dim_hid=8, num_layers=2, seed=0, device="cpu")
    trained.fit(t, labels, epochs=3, lr=1e-2, val_ratio=0.0)
    assert len(trained.history) == 3 and "val_acc" not in trained.history[0]
    a, b = init.model.state_dict(), trained.model.state_dict()
    assert all(not torch.equal(a[k], b[k]) for k in ("alpha", "head.weight"))


def test_best_val_selection_restores_best_epoch():
    _, t, rng = _graphs(11)
    labels = rng.integers(0, 3, 60)
    m = ScDeepSort(dim_in=6, dim_hid=8, num_layers=2, seed=0, device="cpu")
    m.fit(t, labels, epochs=6, lr=5e-2, val_ratio=0.3)
    best = max(h["val_acc"] for h in m.history)
    perm = np.random.default_rng(0).permutation(60)
    val = perm[:int(60 * 0.3)]
    pred = m.predict_proba(t).argmax(1)
    assert acc(labels[val], pred[val]) == pytest.approx(best)


def test_fit_rejects_options_outside_the_slice():
    _, t, rng = _graphs(12)
    m = ScDeepSort(dim_in=6, dim_hid=8, num_layers=2, device="cpu")
    with pytest.raises(ValueError, match="use_bsr must be"):
        m.fit(t, rng.integers(0, 3, 60), epochs=1, use_bsr="sometimes")
    with pytest.raises(ValueError, match="ROADMAP"):
        m.fit(t, rng.integers(0, 3, 60), epochs=1, use_bsr=True, bsr_dtype=torch.float16)
    # bsr_dtype is dropped off the BSR and dense formats, as JAX drops it
    # (``bsr_dtype if use_bsr else None``, scdeepsort.py:148-150)
    m.fit(t, rng.integers(0, 3, 60), epochs=1, use_bsr=False, bsr_dtype=torch.bfloat16)
    assert all(layer.bsr_dtype is None for layer in m.model.layers)
    m.fit(t, rng.integers(0, 3, 60), epochs=1, use_bsr=True, bsr_dtype=torch.bfloat16)
    assert all(layer.bsr_dtype is torch.bfloat16 for layer in m.model.layers)


def test_save_load_score_and_unsure_predict(tmp_path):
    _, t, rng = _graphs(13)
    labels = rng.integers(0, 3, 60)
    m = ScDeepSort(dim_in=6, dim_hid=8, num_layers=2, seed=0, device="cpu")
    m.fit(t, labels, epochs=2, lr=1e-2)
    path = m.save_model(str(tmp_path / "m.pt"))
    probs = m.predict_proba(t)
    other = ScDeepSort(dim_in=6, dim_hid=8, num_layers=2, seed=1, device="cpu")
    with pytest.raises(ValueError, match="fit"):
        other.load_model(path)
    other.fit(t, labels, epochs=0)
    other.load_model(path)
    np.testing.assert_array_equal(other.predict_proba(t), probs)
    assert m.score(t, labels) == acc(labels, m.predict(t))
    unsure = m.predict(t, unsure_rate=3.0 * 0.99)
    np.testing.assert_array_equal(unsure == -1, probs.max(1) < 0.99)
    with pytest.raises(NotImplementedError, match="acc"):
        m.score(t, labels, score_func="unknown_metric")  # every JAX metric name is ported


def test_acc_matches_jax():
    from dance_tpu.utils.metrics import acc as jacc
    rng = np.random.default_rng(0)
    y, p = rng.integers(0, 4, 50), rng.integers(0, 4, 50)
    assert acc(y, p) == jacc(y, p)
    onehot = np.eye(4)[y]
    assert acc(onehot, p) == jacc(onehot, p)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device("auto").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device("auto")
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")


def test_port_imports_no_jax():
    # every module of the package, found by walking it, so new ones are covered
    code = (
        "import importlib, pkgutil, sys, dance_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(dance_tpu_torch.__path__,\n"
        "                                               'dance_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert {'dance_tpu_torch.transforms.pseudobulk', 'dance_tpu_torch.transforms.filter',\n"
        "        'dance_tpu_torch.transforms.graph.dstg_graph', 'dance_tpu_torch.utils.optim',\n"
        "        'dance_tpu_torch.modules.spatial.cell_type_deconvo.dstg',\n"
        "        'dance_tpu_torch.modules.spatial.cell_type_deconvo.stdgcn',\n"
        "        'dance_tpu_torch.modules.single_modality.cell_type_annotation.scheteronet',\n"
        "        'dance_tpu_torch.modules.single_modality.imputation.graphsci',\n"
        "        'dance_tpu_torch.transforms.mask', 'dance_tpu_torch.nn.mlp',\n"
        "        'dance_tpu_torch.transforms.graph.feature_feature_graph',\n"
        "        'dance_tpu_torch.transforms.graph.heteronet_graph',\n"
        "        'dance_tpu_torch.modules.single_modality.cell_type_annotation.actinn',\n"
        "        'dance_tpu_torch.modules.single_modality.clustering.scdeepcluster',\n"
        "        'dance_tpu_torch.modules.single_modality.clustering.scdcc',\n"
        "        'dance_tpu_torch.modules.single_modality.imputation.deepimpute',\n"
        "        'dance_tpu_torch.transforms.gene_holdout', 'dance_tpu_torch.transforms.preprocess',\n"
        "        'dance_tpu_torch.nn.zinb_ae', 'dance_tpu_torch.utils.metrics',\n"
        "        'dance_tpu_torch.utils.scib_metrics',\n"
        "        'dance_tpu_torch.modules.multi_modality.match_modality.scmogcn',\n"
        "        'dance_tpu_torch.modules.spatial.spatial_domain.louvain',\n"
        "        'dance_tpu_torch.nn.vae', 'dance_tpu_torch.transforms.graph.scmogcn_graph',\n"
        "        'dance_tpu_torch.modules.multi_modality.predict_modality.babel',\n"
        "        'dance_tpu_torch.modules.multi_modality.predict_modality.cmae',\n"
        "        'dance_tpu_torch.modules.multi_modality.predict_modality.scmm',\n"
        "        'dance_tpu_torch.modules.multi_modality.match_modality.cmae',\n"
        "        'dance_tpu_torch.modules.multi_modality.match_modality.scmm',\n"
        "        'dance_tpu_torch.modules.multi_modality.joint_embedding.scmogcnv2',\n"
        "        'dance_tpu_torch.modules.multi_modality.joint_embedding.dcca',\n"
        "        'dance_tpu_torch.modules.multi_modality.joint_embedding.jae',\n"
        "        'dance_tpu_torch.modules.multi_modality.joint_embedding.scmvae',\n"
        "        'dance_tpu_torch.ops.mixture',\n"
        "        'dance_tpu_torch.modules.spatial.spatial_domain.spagcn',\n"
        "        'dance_tpu_torch.modules.spatial.spatial_domain.stlearn',\n"
        "        'dance_tpu_torch.modules.spatial.spatial_domain.EfNST',\n"
        "        'dance_tpu_torch.modules.single_modality.imputation.scgnn2',\n"
        "        'dance_tpu_torch.transforms.spatial_feature',\n"
        "        'dance_tpu_torch.transforms.graph.spatial_graph',\n"
        "        'dance_tpu_torch.ops.linear_model', 'dance_tpu_torch.ops.forest',\n"
        "        'dance_tpu_torch.ops.nmf', 'dance_tpu_torch.transforms.stats',\n"
        "        'dance_tpu_torch.transforms.scn_feature',\n"
        "        'dance_tpu_torch.modules.single_modality.cell_type_annotation.svm',\n"
        "        'dance_tpu_torch.modules.single_modality.cell_type_annotation.celltypist',\n"
        "        'dance_tpu_torch.modules.single_modality.cell_type_annotation.singlecellnet',\n"
        "        'dance_tpu_torch.modules.single_modality.imputation.magic',\n"
        "        'dance_tpu_torch.modules.spatial.cell_type_deconvo.spotlight',\n"
        "        'dance_tpu_torch.modules.spatial.cell_type_deconvo.spatialdecon',\n"
        "        'dance_tpu_torch.modules.spatial.cell_type_deconvo.card',\n"
        "        'dance_tpu_torch.sc.pp', 'dance_tpu_torch.sc.tl',\n"
        "        'dance_tpu_torch.data', 'dance_tpu_torch.data.container',\n"
        "        'dance_tpu_torch.data.base', 'dance_tpu_torch.data.io',\n"
        "        'dance_tpu_torch.registry', 'dance_tpu_torch.config',\n"
        "        'dance_tpu_torch.transforms.base', 'dance_tpu_torch.transforms.misc',\n"
        "        'dance_tpu_torch.transforms.interface',\n"
        "        'dance_tpu_torch.transforms.graph.cell_feature_graph',\n"
        "        'dance_tpu_torch.datasets', 'dance_tpu_torch.datasets.synthetic',\n"
        "        'dance_tpu_torch.datasets.singlemodality',\n"
        "        'dance_tpu_torch.datasets.base', 'dance_tpu_torch.pipeline',\n"
        "        'dance_tpu_torch.exceptions', 'dance_tpu_torch.atlas',\n"
        "        'dance_tpu_torch.atlas.sc_similarity.anndata_similarity',\n"
        "        'dance_tpu_torch.utils.wrappers', 'dance_tpu_torch.utils.status'} <= set(names)\n"
        "from dance_tpu_torch.modules.multi_modality.predict_modality import (\n"
        "    BabelWrapper, CMAE, MMVAE, ScMoGCNWrapper)\n"
        "from dance_tpu_torch.modules.multi_modality.match_modality import CMAE, MMVAE\n"
        "from dance_tpu_torch.modules.multi_modality.joint_embedding.scmogcnv2 import (\n"
        "    ScMoGCNWrapperV2)\n"
        "from dance_tpu_torch.modules.multi_modality.joint_embedding import (\n"
        "    DCCA, JAEWrapper, ScMoGCNWrapper, scMVAE)\n"
        "from dance_tpu_torch.modules.spatial.spatial_domain import (\n"
        "    EfNsSTRunner, SpaGCN, StKmeans, StLouvain, sme_preprocess)\n"
        "from dance_tpu_torch.modules.single_modality.imputation import MAGIC, ScGNN2\n"
        "from dance_tpu_torch.modules.single_modality.cell_type_annotation import (\n"
        "    SVM, Celltypist, SingleCellNet, singlecellnet_preprocess, svm_preprocess)\n"
        "from dance_tpu_torch.modules.spatial.cell_type_deconvo import (\n"
        "    Card, SPOTlight, SpatialDecon, card_preprocess)\n"
        "from dance_tpu_torch.transforms import (CellGiottoTopicProfile, CellTypeNums,\n"
        "    FilterGenesCommon, GeneStats, SCNFeature)\n"
        "from dance_tpu_torch.transforms import (FilterGenesMatch, morphology_feature_cnn,\n"
        "    sme_feature, sme_graph, spagcn_graph)\n"
        "from dance_tpu_torch.sc.pp import (calculate_qc_metrics, combat, neighbors, pca,\n"
        "    regress_out, scrublet, subsample)\n"
        "from dance_tpu_torch.sc.tl import (leiden, louvain, rank_genes_groups, score_genes,\n"
        "    score_genes_cell_cycle, umap)\n"
        "from dance_tpu_torch.modules.spatial.cell_type_deconvo import (stdGCNMarkGenes,\n"
        "    stdgcn_marker_genes)\n"
        "from dance_tpu_torch.transforms.graph.dstg_graph import (construct_link_graph,\n"
        "    filter_edge, mnn, preprocess_adj, query_knn)\n"
        "from dance_tpu_torch.transforms.preprocess import ccaEmbed, l2norm, selectTopGenes\n"
        "from dance_tpu_torch.ops.linalg import gram_schmidt_gauss_proj, pca_transform\n"
        "bad = {'jax', 'flax', 'optax', 'sklearn', 'pandas', 'h5py', 'yaml', 'wandb', 'openpyxl',\n"
        "       'dance_tpu'}\n"
        "print(len(names), sorted(m for m in sys.modules if m.split('.')[0] in bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, env={**os.environ, "PYTHONPATH": REPO})
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 80 and bad == "[]"


def test_import_settles_first_multithreaded_exp():
    # A fresh interpreter on several threads: after ``import dance_tpu_torch``
    # the first large torch.exp is right to float32 rounding (ROADMAP Queue 3).
    code = (
        "import numpy as np, torch\n"
        "torch.set_num_threads(4)\n"
        "import dance_tpu_torch\n"
        "x = np.random.default_rng(0).standard_normal((13, 128, 128)).astype(np.float32) * 5\n"
        "got = torch.exp(torch.from_numpy(x)).numpy()\n"
        "print(float((np.abs(got - np.exp(x.astype(np.float64))) / np.exp(x)).max()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, env={**os.environ, "PYTHONPATH": REPO})
    assert float(out.stdout.strip()) < 1e-6

