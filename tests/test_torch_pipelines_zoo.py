"""The container pipelines of the models that reach kernel #1 (scTAG, scDSC,
DSTG, stdGCN, scHeteroNet and both scMoGNNs) and of the other seven
multimodal models, on the port's container against JAX's on JAX's, and
against the port's own array fronts (dance_tpu_torch.modules.*).

Tolerances, as tests/test_torch_pipelines.py: names, masks, splits and graph
structure exact; the host steps (filters, normalisation, HVGs, mixtures,
profiles, markers) exact, except on a dense matrix, which JAX's AnnData
keeps in Fortran order after a subset, so that numpy sums a row's float32
values in another order (1e-5, as tests/test_torch_sctag.py); PCA- and
CCA-derived features within rtol/atol 1e-4; edge weights within 1e-6 (a
Gaussian kNN weight follows the PCA's distances: 1e-4); the container
against the port's array front bit for bit (the same functions on the same
device).

DSTG's and stdGCN's JAX pipelines do not run on a container of reference
cells and spots (each takes the profile of the pseudo split, whose spots
carry no type): the tests show it, and hold the port's pipelines against
JAX's step lists with the port's one difference made (the profile of the
reference split; DSTG then drops the reference cells), as
tests/test_torch_deconvo_graph.py does.
"""

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp

import dance_tpu.datasets.synthetic as jsyn
from dance_tpu.data import AnnData as JAnnData
from dance_tpu.data import Data as JData
from dance_tpu.modules.multi_modality.joint_embedding import dcca as jdcca
from dance_tpu.modules.multi_modality.joint_embedding import jae as jjae
from dance_tpu.modules.multi_modality.joint_embedding import scmogcn as jje_scmogcn
from dance_tpu.modules.multi_modality.joint_embedding import scmogcnv2 as jscmogcnv2
from dance_tpu.modules.multi_modality.joint_embedding import scmvae as jscmvae
from dance_tpu.modules.multi_modality.predict_modality import babel as jbabel
from dance_tpu.modules.multi_modality.predict_modality import cmae as jcmae
from dance_tpu.modules.multi_modality.predict_modality import scmm as jscmm
from dance_tpu.modules.multi_modality.predict_modality import scmogcn as jpm_scmogcn
from dance_tpu.modules.single_modality.cell_type_annotation import scHeteroNet as JscHeteroNet
from dance_tpu.modules.single_modality.clustering import ScDSC as JScDSC
from dance_tpu.modules.single_modality.clustering import ScTAG as JScTAG
from dance_tpu.modules.spatial.cell_type_deconvo import DSTG as JDSTG
from dance_tpu.modules.spatial.cell_type_deconvo import StdGCN as JStdGCN
from dance_tpu.transforms import RemoveSplit as JRemoveSplit
from dance_tpu_torch.data import AnnData, Data, Frame
from dance_tpu_torch.datasets import synthetic as tsyn
from dance_tpu_torch.modules.multi_modality.joint_embedding import dcca, jae, scmvae
from dance_tpu_torch.modules.multi_modality.joint_embedding import scmogcn as je_scmogcn
from dance_tpu_torch.modules.multi_modality.joint_embedding import scmogcnv2
from dance_tpu_torch.modules.multi_modality.predict_modality import babel, cmae, scmm
from dance_tpu_torch.modules.multi_modality.predict_modality import scmogcn as pm_scmogcn
from dance_tpu_torch.modules.single_modality.cell_type_annotation import (
    scHeteroNet, scheteronet_preprocess)
from dance_tpu_torch.modules.single_modality.clustering import (ScDSC, ScTAG,
                                                                scdsc_preprocess,
                                                                sctag_preprocess)
from dance_tpu_torch.modules.spatial.cell_type_deconvo import (DSTG, StdGCN, deconvo_container,
                                                               dstg_preprocess,
                                                               stdgcn_preprocess)
from dance_tpu_torch.modules.spatial.cell_type_deconvo.stdgcn import stdgcn_inputs
from dance_tpu_torch.registry import REGISTRY
from torch_cases import deconvo_case, typed_counts


def _dense(m):
    return m.toarray() if sp.issparse(m) else np.asarray(m)


def _host_tol(sparse: bool) -> dict:
    return {"rtol": 0.0, "atol": 0.0} if sparse else {"rtol": 1e-5, "atol": 1e-5}


def _same_graph(got, want, rtol: float = 1e-6, atol: float = 1e-6):
    got, want = sp.csr_matrix(got), sp.csr_matrix(want)
    for field in ("indptr", "indices"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    np.testing.assert_allclose(got.data, want.data, rtol=rtol, atol=atol)


# --------------------------------------------------------------------------
# scTAG and scDSC
# --------------------------------------------------------------------------

def _clustering_counts():
    counts, types, _ = typed_counts(180, 90, seed=31)
    counts[0, 6], counts[:, 6] = 2, 0  # a gene under 3 counts
    return counts, types


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("model", ["sctag", "scdsc"])
def test_zinb_pipelines_match_jax_and_the_array_front(model, sparse):
    counts, types = _clustering_counts()
    x = sp.csr_matrix(counts) if sparse else counts
    j = JAnnData(x.copy())
    t = AnnData(x.copy())
    onehot = np.eye(3, dtype=np.float32)[types]
    j.obsm["Group"], t.obsm["Group"] = onehot, onehot
    jd, td = JData(j, train_size="all"), Data(t, train_size="all")
    if model == "sctag":
        kw = dict(n_top_genes=40, n_components=6, n_neighbors=8, log_level="WARNING")
        jpipe, tpipe = JScTAG.preprocessing_pipeline(**kw), ScTAG.preprocessing_pipeline(
            **kw, device="cpu")
        front = sctag_preprocess(x, n_top_genes=40, n_components=6, n_neighbors=8,
                                 device="cpu")
    else:
        kw = dict(n_top_genes=40, n_neighbors=8, log_level="WARNING")
        jpipe, tpipe = JScDSC.preprocessing_pipeline(**kw), ScDSC.preprocessing_pipeline(**kw)
        front = scdsc_preprocess(x, n_top_genes=40, n_neighbors=8, device="cpu")
    assert tpipe.hexdigest() == jpipe.hexdigest()
    jpipe(jd), tpipe(td)
    np.testing.assert_array_equal(td.data.obs_names, jd.data.obs_names.to_numpy())
    np.testing.assert_array_equal(td.data.var_names, jd.data.var_names.to_numpy())
    ((tadj, tx, traw, tn), ty), ((jadj, jx, jraw, jn), jy) = (td.get_train_data(),
                                                             jd.get_train_data())
    tol = _host_tol(sparse)
    for got, want in ((tx, jx), (traw, jraw), (tn, jn)):
        np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_array_equal(ty, jy)
    if model == "sctag":
        np.testing.assert_allclose(td.data.obsm["CellPCA"], jd.data.obsm["CellPCA"],
                                   rtol=1e-4, atol=1e-4)
    weights = {"rtol": 1e-4, "atol": 1e-6} if model == "sctag" or not sparse else {}
    _same_graph(td.data.obsp["NeighborGraph"], jd.data.obsp["NeighborGraph"], **weights)
    np.testing.assert_array_equal(tadj, _dense(td.data.obsp["NeighborGraph"]))
    # the container against the array front, bit for bit
    (fadj, fx, fraw, fn), cells = front
    assert (fadj != td.data.obsp["NeighborGraph"]).nnz == 0
    for got, want in ((tx, fx), (traw, fraw), (tn, fn)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ty, onehot[cells])


# --------------------------------------------------------------------------
# DSTG and stdGCN
# --------------------------------------------------------------------------

def _jax_container(x_ref, labels, x_spots, coords=None):
    """JAX's container of reference cells (split "ref") and spots ("test"),
    as tests/test_torch_deconvo_graph.py builds it."""
    genes = pd.DataFrame(index=[f"g{i}" for i in range(x_ref.shape[1])])
    ref = JAnnData(x_ref, obs=pd.DataFrame({"cellType": labels},
                                           index=[f"c{i}" for i in range(len(x_ref))]),
                   var=genes.copy())
    data = JData(ref, full_split_name="ref")
    spots = JAnnData(x_spots, obs=pd.DataFrame(index=[f"s{i}" for i in range(len(x_spots))]),
                     var=genes.copy())
    data.append(JData(spots), mode="new_split", new_split_name="test", join="outer")
    return data


def _jax_portions(jd, x_ref, labels, n_pseudo):
    """The portions JAX's ``PseudoMixture`` computes and its ``Data.append``
    drops, from its own draws."""
    from dance_tpu.transforms.pseudobulk import PseudoMixture as JPseudoMixture
    rng = np.random.default_rng(0)
    cts = [JPseudoMixture.gen_mix(x_ref, np.asarray(labels).astype(str), 2, 10, rng)[1]
           for _ in range(n_pseudo)]
    frame = pd.DataFrame(cts, columns=sorted(set(labels))).fillna(0)
    return frame.div(frame.sum(axis=1), axis=0).to_numpy()


def _repaired(steps, drop_ref: bool):
    """JAX's step list with the port's one difference."""
    steps = list(steps)
    steps[1].split_name = "ref"
    if drop_ref:
        steps.insert(3, JRemoveSplit(split_name="ref"))
    return steps


def test_jax_deconvolution_pipelines_fail_on_a_reference_and_spots_container():
    """JAX's DSTG pipeline finds no marker gene in the pseudo split's profile
    and fails at the PCA; JAX's stdGCN pipeline runs and keeps no gene."""
    x_ref, labels, x_spots, _, _ = deconvo_case(seed=32, n_ref=120, n_spots=40)
    with pytest.raises(ValueError):
        JDSTG.preprocessing_pipeline(n_pseudo=20, k_filter=10, num_cc=5,
                                     log_level="WARNING")(_jax_container(x_ref, labels,
                                                                         x_spots))
    jd = _jax_container(x_ref, labels, x_spots)
    JStdGCN.preprocessing_pipeline(n_pseudo=20, log_level="WARNING")(jd)
    assert jd.data.shape[1] == 0


@pytest.mark.parametrize("model", ["dstg", "stdgcn"])
def test_deconvolution_pipelines_match_jax_steps_and_the_array_front(model):
    x_ref, labels, x_spots, _, coords = deconvo_case(seed=33, n_ref=160, n_spots=60)
    n_pseudo = 40
    jd = _jax_container(x_ref, labels, x_spots)
    td = deconvo_container(x_ref, labels, x_spots, coords)
    if model == "dstg":
        kw = dict(n_pseudo=n_pseudo, k_filter=20, num_cc=8, log_level="WARNING")
        jpipe, tpipe = JDSTG.preprocessing_pipeline(**kw), DSTG.preprocessing_pipeline(
            **kw, device="cpu")
    else:
        jpipe = JStdGCN.preprocessing_pipeline(n_pseudo=n_pseudo, log_level="WARNING")
        tpipe = StdGCN.preprocessing_pipeline(n_pseudo=n_pseudo, log_level="WARNING")
    jsteps = _repaired(jpipe.transforms, drop_ref=model == "dstg")
    assert [t.hexdigest() for t in tpipe.transforms] == [t.hexdigest() for t in jsteps]
    for step in jsteps:
        step(jd)
    tpipe(td)
    assert td.splits.keys() == jd._split_idx_dict.keys()
    for split in td.splits:
        np.testing.assert_array_equal(td.get_split_idx(split), jd.get_split_idx(split))
    np.testing.assert_array_equal(td.data.var_names, jd.data.var_names.to_numpy())
    np.testing.assert_array_equal(td.data.varm["FilterGenesMarker"].to_numpy(),
                                  jd.data.varm["FilterGenesMarker"].to_numpy())
    pseudo = td.get_split_idx("pseudo")
    np.testing.assert_array_equal(_dense(td.data.X), _dense(jd.data.X))
    portions = td.data.obsm["cell_type_portion"]
    assert portions.columns == sorted(set(labels))
    np.testing.assert_array_equal(portions.to_numpy()[pseudo],
                                  _jax_portions(jd, x_ref, labels, n_pseudo))
    assert not np.delete(portions.to_numpy(), pseudo, axis=0).any()
    if model == "dstg":
        np.testing.assert_allclose(td.data.obsm["CellPCA"], jd.data.obsm["CellPCA"], rtol=1e-4,
                                   atol=1e-4)
        # JAX writes the graph [pseudo; real] as it is; the port in the container's order
        order = np.concatenate([pseudo, td.get_split_idx("test")])
        tadj = sp.csr_matrix(td.data.obsp["DSTGraph"])[order][:, order]
        _same_graph(tadj, jd.data.obsp["DSTGraph"])
        got = dstg_preprocess(x_ref, labels, x_spots, n_pseudo=n_pseudo, k_filter=20, num_cc=8,
                              device="cpu")
        (x, adj), y = td.get_x(return_type="default"), td.get_y()
        np.testing.assert_array_equal(got.x, x[order])
        assert (got.adj != sp.csr_matrix(adj)[order][:, order]).nnz == 0
        np.testing.assert_array_equal(got.y, y[order].astype(np.float32))
        np.testing.assert_array_equal(np.nonzero(got.genes)[0],
                                      [int(g[1:]) for g in td.data.var_names])
    else:
        (x, xy), y = td.get_data()
        np.testing.assert_array_equal(xy[pseudo], 0)
        np.testing.assert_array_equal(xy[td.get_split_idx("test")], coords)
        (fx, fxy), fy = stdgcn_preprocess(x_ref, labels, x_spots, coords, n_pseudo=n_pseudo)
        ((cx, cxy), cy) = stdgcn_inputs(td)
        for got, want in ((fx, cx), (fxy, cxy), (fy, cy)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(fx[:n_pseudo], x[pseudo])


# --------------------------------------------------------------------------
# scHeteroNet
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_scheteronet_pipeline_matches_jax_and_the_array_front(sparse):
    counts, types, _ = typed_counts(220, 70, n_types=4, seed=34)
    types[types == 3] = np.arange((types == 3).sum()) % 3  # move most of type 3 away
    types[:6] = 3  # a rare type, dropped
    counts[:, 2], counts[0, 2] = 0, 2
    x = sp.csr_matrix(counts) if sparse else counts
    names = [f"t{k}" for k in range(4)]
    onehot = np.eye(4, dtype=np.float32)[types]
    j, t = JAnnData(x.copy()), AnnData(x.copy())
    j.obsm["cell_type"] = pd.DataFrame(onehot, index=j.obs_names, columns=names)
    t.obsm["cell_type"] = Frame(onehot, index=t.obs_names, columns=names)
    jd, td = JData(j), Data(t)
    jpipe = JscHeteroNet.preprocessing_pipeline(log_level="WARNING")
    tpipe = scHeteroNet.preprocessing_pipeline(log_level="WARNING")
    assert tpipe.hexdigest() == jpipe.hexdigest()
    jpipe(jd), tpipe(td)
    np.testing.assert_array_equal(td.data.obs_names, jd.data.obs_names.to_numpy())
    np.testing.assert_array_equal(td.data.var_names, jd.data.var_names.to_numpy())
    assert not np.isin(np.arange(6).astype(str), td.data.obs_names).any()
    np.testing.assert_array_equal(_dense(td.data.raw.X), _dense(jd.data.raw.X))
    for col in ("n_counts", "size_factors"):
        np.testing.assert_array_equal(td.data.obs[col], jd.data.obs[col].to_numpy())
    for col in jd.data.var.columns:
        want = jd.data.var[col].to_numpy()
        assert td.data.var[col].dtype == want.dtype, col
        np.testing.assert_allclose(td.data.var[col], want, rtol=0, atol=0, err_msg=col)
    tg, jg = td.data.uns["HeteronetGraph"], jd.data.uns["HeteronetGraph"]
    np.testing.assert_array_equal(tg.ndata["feat"], jg.ndata["feat"])
    assert (tg.adj != jg.adj).nnz == 0
    np.testing.assert_array_equal(td.get_y(), jd.get_y())
    inp = scheteronet_preprocess(x, np.asarray(names)[types])
    assert (inp.graph.adj != tg.adj).nnz == 0
    np.testing.assert_array_equal(inp.x, tg.ndata["feat"])
    np.testing.assert_array_equal(inp.size_factors, td.data.obs["size_factors"])
    np.testing.assert_array_equal(inp.labels, td.get_y().argmax(1))
    np.testing.assert_array_equal(inp.cells, td.data.obs_names.astype(np.int64))


# --------------------------------------------------------------------------
# the multimodal SetConfig pipelines
# --------------------------------------------------------------------------

MULTIMODAL = {
    "scmogcn_predict": (jpm_scmogcn.ScMoGCNWrapper, pm_scmogcn.ScMoGCNWrapper),
    "babel": (jbabel.BabelWrapper, babel.BabelWrapper),
    "cmae": (jcmae.CMAE, cmae.CMAE),
    "scmm": (jscmm.MMVAE, scmm.MMVAE),
    "scmogcn_je": (jje_scmogcn.ScMoGCNWrapper, je_scmogcn.ScMoGCNWrapper),
    "scmogcnv2": (jscmogcnv2.ScMoGCNWrapperV2, scmogcnv2.ScMoGCNWrapperV2),
    "dcca": (jdcca.DCCA, dcca.DCCA),
    "jae": (jjae.JAEWrapper, jae.JAEWrapper),
    "scmvae": (jscmvae.scMVAE, scmvae.scMVAE),
}


@pytest.mark.parametrize("name", sorted(MULTIMODAL))
def test_multimodal_pipelines_match_jax(name):
    """One ``SetConfig`` each: the digest, then the train and test data of
    the same ``MuData`` against JAX's and against the arrays the fronts
    take (each modality's ``X``, the cell types)."""
    jmodel, tmodel = MULTIMODAL[name]
    jpipe = jmodel.preprocessing_pipeline(log_level="WARNING")
    tpipe = tmodel.preprocessing_pipeline(log_level="WARNING")
    assert tpipe.hexdigest() == jpipe.hexdigest()
    jd, td = jsyn.multimodal_data(60, 30, 8, seed=35), tsyn.multimodal_data(60, 30, 8, seed=35)
    jpipe(jd), tpipe(td)
    for split in ("train", "test"):
        (tx, ty), (jx, jy) = td.get_data(split), jd.get_data(split)
        for got, want in zip(tx if isinstance(tx, list) else [tx],
                             jx if isinstance(jx, list) else [jx]):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(ty, jy)
        idx = td.get_split_idx(split)
        if name in ("scmogcn_predict", "babel", "cmae", "scmm"):
            np.testing.assert_array_equal(tx, td.data.mod["mod1"].X[idx])
            np.testing.assert_array_equal(ty, td.data.mod["mod2"].X[idx])
        else:
            for got, mod in zip(tx, ("mod1", "mod2")):
                np.testing.assert_array_equal(got, td.data.mod[mod].X[idx])
            np.testing.assert_array_equal(ty, td.data.mod["mod1"].obs["cell_type"][idx])


def test_the_new_container_transforms_are_registered_under_jax_keys():
    import dance_tpu.registry as jreg
    import dance_tpu.transforms  # noqa: F401  (registers JAX's transforms)

    names = {"CellPCA", "NeighborGraph", "PseudoMixture", "CellTopicProfile",
             "FilterGenesMarker", "DSTGraph", "FilterCellsScanpy", "FilterGenesScanpy",
             "HighlyVariableGenesLogarithmizedByTopGenes", "FilterCellsType", "Log1P",
             "NormalizeTotal", "UpdateSizeFactors", "HeteronetGraph",
             # the last sixteen pipelines' classes
             "CellwiseMaskData", "GeneHoldout", "FeatureFeatureGraph", "SCNFeature",
             "FilterGenesMatch", "FilterGenesCommon", "SpaGCNGraph", "SpaGCNGraph2D",
             "SMEGraph", "MorphologyFeatureCNN", "SMEFeature"}

    def keys(registry):
        return {k for k in registry.children("preprocessor", non_leaf_node=False)
                if k.rsplit(".", 1)[-1] in names}

    got = keys(REGISTRY)
    assert len(got) == len(names) and got == keys(jreg.REGISTRY)
    # 39, then the nine transforms the tuning configs name and the two
    # single-modality datasets (tests/test_torch_pipeline.py, test_torch_datasets.py)
    assert len(list(REGISTRY.children("", non_leaf_node=False))) == 50
