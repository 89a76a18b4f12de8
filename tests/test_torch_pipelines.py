"""The four ported model pipelines on the port's container against JAX's on
JAX's container: ScDeepSort, GraphSC, Stagate and ACTINN
``preprocessing_pipeline`` (dance_tpu_torch.modules.*), each also against
the port's own array front on the same counts; ``BaseMethod.preprocess``;
and the scDeepSort example flow (examples/single_modality/
cell_type_annotation/scdeepsort.py:17-31): preprocess, the train and test
subgraphs, three training steps against JAX's with the flax weights carried
across (utils/params.py), then the test predictions.

Tolerances: names, masks, splits and graph structure exact; the host steps
(filters, normalisation, HVGs, spatial graphs) exact, as they run the same
numpy arithmetic; PCA-derived features within rtol/atol 1e-4 (as
tests/test_torch_graphsc.py); edge weights within 1e-6; the container
against the array front bit for bit (the same functions on the same
device); training steps and probabilities at 1e-4 (as
tests/test_torch_scdeepsort.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import dance_tpu.datasets.synthetic as jsyn
from dance_tpu.data import AnnData as JAnnData
from dance_tpu.data import Data as JData
from dance_tpu.modules.single_modality.cell_type_annotation import ACTINN as JACTINN
from dance_tpu.modules.single_modality.cell_type_annotation import ScDeepSort as JScDeepSort
from dance_tpu.modules.single_modality.clustering import GraphSC as JGraphSC
from dance_tpu.modules.spatial.spatial_domain import Stagate as JStagate
from dance_tpu_torch.data import AnnData, Data, Frame
from dance_tpu_torch.datasets import synthetic as tsyn
from dance_tpu_torch.graph import Graph
from dance_tpu_torch.modules.single_modality.cell_type_annotation import (ACTINN, ScDeepSort,
                                                                         actinn_preprocess)
from dance_tpu_torch.modules.single_modality.clustering import (GraphSC, ScDSC, ScTAG,
                                                                graphsc_preprocess)
from dance_tpu_torch.modules.spatial.cell_type_deconvo import DSTG
from dance_tpu_torch.modules.spatial.spatial_domain import Stagate, stagate_preprocess
from dance_tpu_torch.transforms import weighted_feature_pca
from dance_tpu_torch.utils.params import flax_to_torch
from torch_cases import typed_counts

CPU = torch.device("cpu")


def _dense(m):
    return m.toarray() if sp.issparse(m) else np.asarray(m)


def _pair(counts, names=None, obs=None):
    """The same counts in both packages' containers (``obs`` columns in both)."""
    names = [f"g{i}" for i in range(counts.shape[1])] if names is None else list(names)
    obs = obs or {}
    j = JAnnData(counts.copy(), obs=pd.DataFrame(obs) if obs else None,
                 var=pd.DataFrame(index=names))
    t = AnnData(counts.copy(), obs=Frame(obs) if obs else None, var=Frame(index=names))
    return j, t


def assert_graph_close(tg: Graph, jg, exact_features: bool = False):
    assert tg.info == jg.info
    np.testing.assert_array_equal(tg.adj.indptr, jg.adj.indptr)
    np.testing.assert_array_equal(tg.adj.indices, jg.adj.indices)
    np.testing.assert_allclose(tg.adj.data, jg.adj.data, rtol=1e-6, atol=1e-6)
    for key in ("cell_id", "feat_id"):
        np.testing.assert_array_equal(tg.ndata[key], jg.ndata[key])
    if exact_features:
        np.testing.assert_array_equal(tg.ndata["features"], jg.ndata["features"])
    else:
        np.testing.assert_allclose(tg.ndata["features"], jg.ndata["features"], rtol=1e-4,
                                   atol=1e-4)


def assert_graph_equal(a: Graph, b: Graph):
    assert a.info == b.info and (a.adj != b.adj).nnz == 0
    assert a.adj.dtype == b.adj.dtype
    for key in b.ndata:
        np.testing.assert_array_equal(a.ndata[key], b.ndata[key], err_msg=key)


# --------------------------------------------------------------------------
# scDeepSort
# --------------------------------------------------------------------------


def test_scdeepsort_pipeline_matches_jax_and_the_array_front():
    jd = jsyn.annotation_data(120, 40, 3, seed=1)
    td = tsyn.annotation_data(120, 40, 3, seed=1)
    jpipe = JScDeepSort.preprocessing_pipeline(n_components=8, log_level="WARNING")
    tpipe = ScDeepSort.preprocessing_pipeline(n_components=8, log_level="WARNING", device="cpu")
    assert tpipe.hexdigest() == jpipe.hexdigest()
    jpipe(jd), tpipe(td)
    for ch in ("obsm", "varm"):
        np.testing.assert_allclose(getattr(td.data, ch)["WeightedFeaturePCA"],
                                   getattr(jd.data, ch)["WeightedFeaturePCA"], rtol=1e-4,
                                   atol=1e-4)
    tg = td.data.uns["PCACellFeatureGraph"]
    assert_graph_close(tg, jd.data.uns["PCACellFeatureGraph"])
    (tx, ty), (jx, jy) = td.get_train_data(), jd.get_train_data()
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(td.get_y("test"), jd.get_y("test"))
    # the array front: the PCA of the training cells, then the graph
    x = td.data.X
    cell_feat, gene_feat = weighted_feature_pca(x[td.train_idx], x, 8, device="cpu")
    assert_graph_equal(tg, Graph.from_cell_feature_matrix(x, cell_feat, gene_feat))


def _subgraph(graph, n_genes, cells):
    g = graph.subgraph(np.concatenate([np.arange(n_genes), n_genes + np.asarray(cells)]))
    g.info = {"num_genes": n_genes, "num_cells": len(cells)}
    return g


def _jax_train_state(model: JScDeepSort, graph, labels, val_ratio=0.2):
    """The inputs JAX ``fit`` hands to ``_train_step`` (as
    tests/test_torch_scdeepsort.py rebuilds them)."""
    n_genes, n_cells = graph.info["num_genes"], graph.info["num_cells"]
    perm = np.random.default_rng(model.seed).permutation(n_cells) + n_genes
    train_idx = perm[int(n_cells * val_ratio):]
    full = -np.ones(n_genes + n_cells, np.int32)
    full[n_genes:] = labels
    mask = np.isin(np.arange(len(full)), train_idx).astype(np.float32)
    dg, gene_id, conv_adj = model._dev_cache
    return conv_adj, dg.ndata["features"], gene_id, jnp.asarray(full), jnp.asarray(mask)


@pytest.mark.parametrize("use_bsr", [True, False])
def test_scdeepsort_example_flow_matches_jax(use_bsr):
    """The example's flow in both packages: ``preprocess``, the train and test
    subgraphs, then three Adam steps from the same weights and the test
    predictions."""
    jd = jsyn.annotation_data(100, 30, 3, seed=2)
    td = tsyn.annotation_data(100, 30, 3, seed=2)
    jm = JScDeepSort(8, 16, 2, seed=0)
    tm = ScDeepSort(8, 16, 2, seed=0, device="cpu")
    jm.preprocess(jd, n_components=8, log_level="WARNING")
    tm.preprocess(td, n_components=8, log_level="WARNING")  # the model's device, the CPU
    runs = {}
    for name, d in (("jax", jd), ("torch", td)):
        graph = d.data.uns["PCACellFeatureGraph"]
        n_genes = graph.info["num_genes"]
        runs[name] = (_subgraph(graph, n_genes, d.train_idx), _subgraph(graph, n_genes, d.test_idx),
                      d.get_y("train").argmax(1), d.get_y("test").argmax(1))
    (jtrain, jtest, jlab, jtest_lab), (ttrain, ttest, tlab, ttest_lab) = runs["jax"], runs["torch"]
    np.testing.assert_array_equal(tlab, jlab)
    np.testing.assert_array_equal(ttest_lab, jtest_lab)
    jm.fit(jtrain, jlab, epochs=0, lr=1e-2, use_bsr=use_bsr)
    tm.fit(ttrain, tlab, epochs=0, lr=1e-2, use_bsr=use_bsr)
    tm.model.load_state_dict(flax_to_torch(jax.tree_util.tree_map(np.asarray, jm.params)))
    adj, feats, gene_id, full, mask = _jax_train_state(jm, jtrain, jlab)
    params, opt_state = jm.params, jm._tx.init(jm.params)
    key = jax.random.key(0)
    for step in range(3):
        params, opt_state, jloss = jm._train_step(params, opt_state, adj, feats, gene_id,
                                                  full, mask, key, jm._alpha_idx)
        np.testing.assert_allclose(float(tm.train_step()), float(jloss), rtol=1e-4, atol=1e-4,
                                   err_msg=f"loss at step {step}")
    want = flax_to_torch(jax.tree_util.tree_map(np.asarray, params))
    got = tm.model.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    jm.params = params
    np.testing.assert_allclose(tm.predict_proba(ttest), jm.predict_proba(jtest), rtol=1e-4,
                               atol=1e-4)
    assert tm.predict(ttest).shape == (len(td.test_idx),)


# --------------------------------------------------------------------------
# graph-sc
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("weights", ["log_per_cell", "per_cell", "none"])
def test_graphsc_pipeline_matches_jax_and_the_array_front(weights, sparse):
    counts, types, _ = typed_counts(160, 60, seed=3)
    x = sp.csr_matrix(counts) if sparse else counts
    j, t = _pair(x)
    j.obsm["Group"], t.obsm["Group"] = types, types
    jd, td = JData(j, train_size="all"), Data(t, train_size="all")
    kw = dict(n_top_genes=30, normalize_weights=weights, n_components=8, log_level="WARNING")
    jpipe, tpipe = JGraphSC.preprocessing_pipeline(**kw), GraphSC.preprocessing_pipeline(
        **kw, device="cpu")
    assert tpipe.hexdigest() == jpipe.hexdigest()
    jpipe(jd), tpipe(td)
    np.testing.assert_array_equal(td.data.obs_names, jd.data.obs_names.to_numpy())
    np.testing.assert_array_equal(td.data.var_names, jd.data.var_names.to_numpy())
    np.testing.assert_array_equal(_dense(td.X), _dense(jd.X))
    for col in jd.data.var.columns:
        np.testing.assert_array_equal(td.data.var[col], jd.data.var[col].to_numpy(),
                                      err_msg=col)
    np.testing.assert_array_equal(td.data.obs["n_counts"], jd.data.obs["n_counts"].to_numpy())
    np.testing.assert_allclose(td.data.obsm["WeightedFeaturePCA"],
                               jd.data.obsm["WeightedFeaturePCA"], rtol=1e-4, atol=1e-4)
    (tg, ty), (jg, jy) = td.get_train_data(), jd.get_train_data()
    assert_graph_close(tg, jg)
    np.testing.assert_array_equal(ty, jy)
    graph, cells = graphsc_preprocess(x, n_top_genes=30, normalize_weights=weights,
                                      n_components=8, device="cpu")
    assert_graph_equal(tg, graph)
    np.testing.assert_array_equal(ty, types[cells])


# --------------------------------------------------------------------------
# STAGATE
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("model_name,kw", [("knn", {"n_neighbors": 5}),
                                           ("radius", {"radius": 15.0})], ids=["knn", "radius"])
def test_stagate_pipeline_matches_jax_and_the_array_front(model_name, kw, sparse):
    counts, types, _ = typed_counts(150, 50, seed=4)
    xy = (np.random.default_rng(4).random((150, 2)) * 100).astype(np.float32)
    x = sp.csr_matrix(counts) if sparse else counts
    j, t = _pair(x, obs={"label": types})
    j.obsm["spatial_pixel"], t.obsm["spatial_pixel"] = xy, xy
    jd, td = JData(j, train_size="all"), Data(t, train_size="all")
    opts = dict(n_top_genes=25, model_name=model_name, log_level="WARNING", **kw)
    jpipe, tpipe = JStagate.preprocessing_pipeline(**opts), Stagate.preprocessing_pipeline(
        **opts, device="cpu")
    assert tpipe.hexdigest() == jpipe.hexdigest()
    jpipe(jd), tpipe(td)
    np.testing.assert_array_equal(td.data.var_names, jd.data.var_names.to_numpy())
    np.testing.assert_array_equal(_dense(td.X), _dense(jd.X))
    for col in jd.data.var.columns:
        np.testing.assert_array_equal(td.data.var[col], jd.data.var[col].to_numpy(),
                                      err_msg=col)
    tadj, jadj = td.data.obsp["StagateGraph"], jd.data.obsp["StagateGraph"]
    assert (tadj != jadj).nnz == 0 and tadj.dtype == jadj.dtype
    ((tx, tadj_d), ty), ((jx, jadj_d), jy) = td.get_train_data(), jd.get_train_data()
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(tadj_d, jadj_d)
    np.testing.assert_array_equal(ty, jy)
    fx, fadj = stagate_preprocess(x, xy, n_top_genes=25, model_name=model_name, **kw)
    np.testing.assert_array_equal(tx, fx)
    np.testing.assert_array_equal(tadj_d, fadj.toarray())


# --------------------------------------------------------------------------
# ACTINN
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_actinn_pipeline_matches_jax_and_the_array_front(sparse):
    counts, types, names = typed_counts(200, 60, seed=5)
    x = sp.csr_matrix(counts) if sparse else counts
    j, t = _pair(x, names)
    onehot = np.eye(3, dtype=np.float32)[types]
    j.obsm["cell_type"] = pd.DataFrame(onehot, index=j.obs_names, columns=["a", "b", "c"])
    t.obsm["cell_type"] = Frame(onehot, index=t.obs_names, columns=["a", "b", "c"])
    jd, td = JData(j, train_size=120, val_size=40), Data(t, train_size=120, val_size=40)
    jpipe = JACTINN.preprocessing_pipeline(log_level="WARNING")
    tpipe = ACTINN.preprocessing_pipeline(log_level="WARNING", device="cpu")
    assert tpipe.hexdigest() == jpipe.hexdigest()
    jpipe(jd), tpipe(td)
    np.testing.assert_array_equal(td.data.var_names, jd.data.var_names.to_numpy())
    for col in ("n_cells", "n_counts"):
        np.testing.assert_array_equal(td.data.var[col], jd.data.var[col].to_numpy())
    np.testing.assert_array_equal(td.data.uns["gene_summary"], jd.data.uns["gene_summary"])
    for split in ("train", "val", "test"):
        (tx, ty), (jx, jy) = td.get_data(split), jd.get_data(split)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    fx, fnames = actinn_preprocess(x, names)
    np.testing.assert_array_equal(td.get_x(), fx)
    np.testing.assert_array_equal(td.data.var_names, fnames)


# --------------------------------------------------------------------------
# The base contract and the device rule
# --------------------------------------------------------------------------


@pytest.mark.parametrize("model", [ScDeepSort, GraphSC, Stagate, ACTINN])
def test_pipelines_resolve_their_device(model):
    assert model.preprocessing_pipeline(device="cpu")  # builds on the named CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.preprocessing_pipeline()


@pytest.mark.parametrize("model,front", [(ScTAG, "sctag_preprocess"),
                                         (ScDSC, "scdsc_preprocess"),
                                         (DSTG, "dstg_preprocess")])
def test_unported_pipelines_raise_naming_the_array_front(model, front):
    with pytest.raises(NotImplementedError, match=front):
        model.preprocessing_pipeline()
    with pytest.raises(NotImplementedError, match=front):
        model.__new__(model).preprocess(tsyn.clustering_data(20, 10))


def test_preprocess_takes_the_models_device_unless_named():
    data = tsyn.clustering_data(60, 30, seed=6)
    model = GraphSC(n_clusters=3, device="cpu")
    model.preprocess(data, n_top_genes=20, n_components=5, log_level="WARNING")
    g, y = data.get_train_data()
    assert isinstance(g, Graph) and g.ndata["features"].shape[1] == 5
    assert y.shape == (g.info["num_cells"],)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.preprocess(tsyn.clustering_data(60, 30, seed=6), device="auto")
