"""The container pipelines of the last sixteen models: the single-modality
rest (GraphSCI, DeepImpute, MAGIC, scGNN2, scDeepCluster, scDCC, SVM,
CellTypist, SingleCellNet) and the spatial rest (Louvain, SpaGCN, CARD,
SpatialDecon, SPOTlight, EfNST and stLearn's shared SME pipeline), on the
port's container against JAX's on JAX's, and against the port's own array
fronts (dance_tpu_torch.modules.*).

Each case holds: the same ``hexdigest()`` as JAX's pipeline; the container's
outputs (``X``, names, the ``obs``/``var``/``obsm``/``obsp``/``varm``/
``uns``/``layers`` channels the pipeline writes, the configured
``get_train_data`` or ``get_data``) against JAX's on the same numpy inputs,
made from a seed; and the array front's output against the container's, bit
for bit (the same functions on the same device).

Tolerances: names, masks, splits, gene lists and graph structure exact; the
host steps (filters, normalisation, log1p, scale, masks, gene holdouts,
profiles, gene pairs, correlation graphs) exact on a sparse matrix, which
JAX's AnnData keeps in row order, as tests/test_torch_pipelines_zoo.py
holds them; PCA-derived features, the morphology CNN's features after its
30 Adam epochs and the SME feature at 1e-4 of their largest value
(tests/test_torch_stlearn.py); Gaussian kNN weights, which follow the PCA's
distances, at 1e-4; the distance matrices on the squared distances at 1e-5
of the largest (tests/test_torch_spagcn.py). JAX's DeepImpute pipeline
leaves ``GeneHoldout`` unseeded: the test seeds its draw as the port's
pipeline does. The morphology CNN runs its 30 Adam epochs on the 64 x 64
tiles of 48 spots in the stLearn case, from JAX's kernel draws; EfNST's case
stubs it with the same features on both sides.
"""

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from dance_tpu.data import AnnData as JAnnData
from dance_tpu.data import Data as JData
from dance_tpu.modules.single_modality import cell_type_annotation as jcta
from dance_tpu.modules.single_modality import clustering as jclu
from dance_tpu.modules.single_modality import imputation as jimp
from dance_tpu.modules.spatial import cell_type_deconvo as jdec
from dance_tpu.modules.spatial import spatial_domain as jsd
from dance_tpu.modules.spatial.spatial_domain import stlearn as jstlearn
from dance_tpu.transforms import spatial_feature as jsf
from dance_tpu_torch.data import AnnData, Data, Frame
from dance_tpu_torch.modules.single_modality import cell_type_annotation as tcta
from dance_tpu_torch.modules.single_modality import clustering as tclu
from dance_tpu_torch.modules.single_modality import imputation as timp
from dance_tpu_torch.modules.spatial import cell_type_deconvo as tdec
from dance_tpu_torch.modules.spatial import spatial_domain as tsd
from dance_tpu_torch.modules.spatial.spatial_domain import stlearn as tstlearn
from dance_tpu_torch.transforms import spatial_feature as S
from test_torch_stlearn import _jax_encoder
from torch_cases import deconvo_case, spatial_slide, typed_counts

CPU = torch.device("cpu")


def _dense(m):
    return m.toarray() if sp.issparse(m) else np.asarray(m)


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(_dense(got), _dense(want), err_msg=msg)


def _close(got, want, rel=1e-4, msg=""):
    want = _dense(want)
    np.testing.assert_allclose(_dense(got), want, rtol=0, atol=rel * np.abs(want).max(),
                               err_msg=msg)


def _sq_close(got, want):
    got, want = _dense(got), _dense(want)
    np.testing.assert_allclose(got ** 2, want ** 2, rtol=0, atol=1e-5 * float((want ** 2).max()))


def _pair(x, names=None, **kw):
    """The same matrix, gene names and ``obs`` columns in a JAX and a port
    AnnData."""
    j, t = JAnnData(x.copy()), AnnData(x.copy())
    if names is not None:
        j.var_names = pd.Index(np.asarray(names, dtype=object))
        t.var_names = np.asarray(names).astype(str)
    for key, val in kw.items():
        j.obs[key], t.obs[key] = val, val
    return j, t


def _run(jpipe, tpipe, jd, td):
    assert tpipe.hexdigest() == jpipe.hexdigest()
    jpipe(jd), tpipe(td)
    np.testing.assert_array_equal(td.data.obs_names, jd.data.obs_names.to_numpy())
    np.testing.assert_array_equal(td.data.var_names, jd.data.var_names.to_numpy())


def _onehot(types, obs_names):
    cols = [f"t{k}" for k in range(int(types.max()) + 1)]
    onehot = np.eye(len(cols), dtype=np.float32)[types]
    return (pd.DataFrame(onehot, index=obs_names, columns=cols),
            Frame(onehot, index=np.asarray(obs_names).astype(str), columns=cols))


# --------------------------------------------------------------------------
# c: the single-modality rest
# --------------------------------------------------------------------------

def _imputation_counts():
    counts, _, _ = typed_counts(300, 60, seed=41)
    counts[:, 2] = 0
    counts[:280, 3], counts[280:, 3] = 0, 4  # in 20 cells: over a tenth of 60 genes
    counts[7] = 0
    return sp.csr_matrix(counts)


def _imputation_common(jd, td):
    for name in ("X",):
        _eq(td.data.X, jd.data.X, name)
    _eq(td.data.raw.X, jd.data.raw.X, "raw")
    for name in jd.data.layers.keys():
        _eq(td.data.layers[name], jd.data.layers[name], name)
    assert 7 not in td.data.obs_names.astype(int) and "2" not in td.data.var_names


def _front_imputation(inp, td):
    _eq(inp.x, td.data.X)
    _eq(inp.x_raw, td.data.raw.X)
    for name in ("train_mask", "valid_mask", "test_mask"):
        _eq(getattr(inp, name), td.data.layers[name], name)
    _eq(inp.cells, td.data.obs_names.astype(np.int64))
    _eq(inp.genes, td.data.var_names.astype(np.int64))


def _graphsci():
    x = _imputation_counts()
    j, t = _pair(x)
    jd, td = JData(j, train_size="all"), Data(t, train_size="all")
    kw = dict(seed=3, log_level="WARNING")
    _run(jimp.GraphSCI.preprocessing_pipeline(**kw), timp.GraphSCI.preprocessing_pipeline(**kw),
         jd, td)
    _imputation_common(jd, td)
    ((tg, tx, tm), ty), ((jg, jx, jm), jy) = td.get_train_data(), jd.get_train_data()
    assert (tg.adj != jg.adj).nnz == 0
    _eq(tg.ndata["feat"], jg.ndata["feat"])
    for got, want in zip((tx, tm, *ty), (jx, jm, *jy)):
        _eq(got, want)
    inp = timp.graphsci_preprocess(x, seed=3)
    _front_imputation(inp, td)
    assert (inp.graph.adj != tg.adj).nnz == 0


def _deepimpute():
    x = _imputation_counts()
    names = [f"g{k}" for k in range(x.shape[1])]
    j, t = _pair(x)
    jd, td = JData(j, train_size="all"), Data(t, train_size="all")
    kw = dict(sub_outputdim=16, n_top=3, seed=5, log_level="WARNING")
    jpipe = jimp.DeepImpute.preprocessing_pipeline(**kw)
    jpipe[4].random_state = 5  # JAX's holdout is unseeded
    _run(jpipe, timp.DeepImpute.preprocessing_pipeline(**kw), jd, td)
    _imputation_common(jd, td)
    for key in ("targets", "predictors"):
        assert len(td.data.uns[key]) == len(jd.data.uns[key]) == 4
        for got, want in zip(td.data.uns[key], jd.data.uns[key]):
            _eq(got, want, key)
    (tx, ty), (jx, jy) = td.get_train_data(), jd.get_train_data()
    for got, want in zip((*tx[:2], *tx[4:], *ty), (*jx[:2], *jx[4:], *jy)):
        _eq(got, want)
    inp = timp.deepimpute_preprocess(x, names, seed=5, sub_outputdim=16, n_top=3)
    _front_imputation(inp, td)
    for got, want in zip(inp.targets + inp.predictors,
                         td.data.uns["targets"] + td.data.uns["predictors"]):
        _eq(got, want)
    _eq(inp.gene_names, np.asarray(names)[inp.genes])


def _magic_or_scgnn2(jmodel, tmodel, front):
    x = _imputation_counts()
    j, t = _pair(x)
    jd, td = JData(j, train_size="all"), Data(t, train_size="all")
    kw = dict(seed=3, log_level="WARNING")
    _run(jmodel.preprocessing_pipeline(**kw), tmodel.preprocessing_pipeline(**kw), jd, td)
    _imputation_common(jd, td)
    ((tx, tm), ty), ((jx, jm), jy) = td.get_train_data(), jd.get_train_data()
    for got, want in zip((tx, tm, *ty), (jx, jm, *jy)):
        _eq(got, want)
    _front_imputation(front(x, seed=3), td)


def _zinb(model):
    counts, types, names = typed_counts(300, 70, seed=42)
    counts[:, 5] = 0
    x = sp.csr_matrix(counts)
    j, t = _pair(x, names)
    j.obsm["Group"], t.obsm["Group"] = types, types
    jd, td = JData(j, train_size="all"), Data(t, train_size="all")
    if model == "scdcc":
        kw = dict(n_top_genes=40, log_level="WARNING")
        jpipe, tpipe = jclu.ScDCC.preprocessing_pipeline(**kw), tclu.ScDCC.preprocessing_pipeline(**kw)
    else:
        jpipe = jclu.ScDeepCluster.preprocessing_pipeline(log_level="WARNING")
        tpipe = tclu.ScDeepCluster.preprocessing_pipeline(log_level="WARNING")
    _run(jpipe, tpipe, jd, td)
    ((tx, traw, tn), ty), ((jx, jraw, jn), jy) = td.get_train_data(), jd.get_train_data()
    for got, want in ((tx, jx), (traw, jraw), (tn, jn), (ty, jy)):
        _eq(got, want)
    for col in jd.data.var.columns:
        _eq(td.data.var[col], jd.data.var[col].to_numpy(), col)
    if model == "scdcc":
        assert td.data.shape[1] == 40
        inp = tclu.scdcc_preprocess(x, names, types, n_top_genes=40)
    else:
        inp = tclu.scdeepcluster_preprocess(x, names, types)
    for got, want in ((inp.x, tx), (inp.x_raw, traw), (inp.n_counts, tn), (inp.labels, ty)):
        _eq(got, want)
    _eq(inp.gene_names, td.data.var_names)
    _eq(inp.cells, td.data.obs_names.astype(np.int64))


def _annotation_case(seed):
    counts, types, names = typed_counts(300, 70, n_types=4, seed=seed)
    x = np.log1p(counts).astype(np.float32)
    j, t = _pair(x, names)
    j.obsm["cell_type"], t.obsm["cell_type"] = _onehot(types, j.obs_names)
    split = dict(train_size=200, val_size=0, test_size=100)
    return counts, x, types, names, JData(j, **split), Data(t, **split)


def _svm():
    _, x, _, _, jd, td = _annotation_case(43)
    kw = dict(n_components=12, log_level="WARNING")
    _run(jcta.SVM.preprocessing_pipeline(**kw),
         tcta.SVM.preprocessing_pipeline(**kw, device="cpu"), jd, td)
    _close(td.data.obsm["WeightedFeaturePCA"], jd.data.obsm["WeightedFeaturePCA"])
    (tx, ty), (jx, jy) = td.get_train_data(), jd.get_train_data()
    _close(tx, jx)
    _eq(ty, jy)
    feat = tcta.svm_preprocess(x, td.get_split_idx("train"), 12, device=CPU)
    _eq(feat, td.data.obsm["WeightedFeaturePCA"])


def _celltypist():
    _, _, _, _, jd, td = _annotation_case(44)
    _run(jcta.Celltypist.preprocessing_pipeline(log_level="WARNING"),
         tcta.Celltypist.preprocessing_pipeline(log_level="WARNING"), jd, td)
    for split in ("train", "test"):
        (tx, ty), (jx, jy) = td.get_data(split), jd.get_data(split)
        _eq(tx, jx)
        _eq(ty, jy)


def _singlecellnet():
    counts, _, types, names, _, _ = _annotation_case(45)
    j, t = _pair(counts, names)
    j.obsm["cell_type"], t.obsm["cell_type"] = _onehot(types, j.obs_names)
    split = dict(train_size=200, val_size=0, test_size=100)
    jd, td = JData(j, **split), Data(t, **split)
    kw = dict(num_top_genes=6, num_top_gene_pairs=8, log_level="WARNING")
    _run(jcta.SingleCellNet.preprocessing_pipeline(**kw),
         tcta.SingleCellNet.preprocessing_pipeline(**kw), jd, td)
    _eq(td.data.X, jd.data.X)
    tf, jf = td.data.obsm["SCNFeature"], jd.data.obsm["SCNFeature"]
    assert list(tf.columns) == list(jf.columns) and len(tf.columns) > 8
    _eq(tf.to_numpy(), jf.to_numpy())
    for split in ("train", "test"):
        (tx, ty), (jx, jy) = td.get_data(split), jd.get_data(split)
        _eq(tx, jx)
        _eq(ty, jy)
    feat, pairs = tcta.singlecellnet_preprocess(counts, names, [f"t{k}" for k in types],
                                                td.get_split_idx("train"), num_top_genes=6,
                                                num_top_gene_pairs=8)
    _eq(feat, tf.to_numpy())
    assert pairs == list(tf.columns)


SINGLE_MODALITY = {
    "graphsci": _graphsci,
    "deepimpute": _deepimpute,
    "magic": lambda: _magic_or_scgnn2(jimp.MAGIC, timp.MAGIC, timp.magic_preprocess),
    "scgnn2": lambda: _magic_or_scgnn2(jimp.ScGNN2, timp.ScGNN2, timp.scgnn2_preprocess),
    "scdeepcluster": lambda: _zinb("scdeepcluster"),
    "scdcc": lambda: _zinb("scdcc"),
    "svm": _svm,
    "celltypist": _celltypist,
    "singlecellnet": _singlecellnet,
}


@pytest.mark.parametrize("name", list(SINGLE_MODALITY))
def test_single_modality_pipelines_match_jax_and_the_array_front(name):
    SINGLE_MODALITY[name]()


# --------------------------------------------------------------------------
# d: the spatial rest
# --------------------------------------------------------------------------

def _slide(n_rows, n_cols, seed, names=None):
    counts, xy, xy_pixel, image, dom = spatial_slide(n_rows=n_rows, n_cols=n_cols, g=50,
                                                     seed=seed)
    j, t = _pair(counts, names, label=dom)
    for a in (j, t):
        a.obsm["spatial"] = xy
        a.obsm["spatial_pixel"] = xy_pixel
        a.uns["image"] = image
    return (counts, xy, xy_pixel, image), JData(j, train_size="all"), Data(t, train_size="all")


def _louvain():
    (counts, *_), jd, td = _slide(17, 18, seed=46)
    kw = dict(dim=10, n_neighbors=8, log_level="WARNING")
    _run(jsd.Louvain.preprocessing_pipeline(**kw),
         tsd.Louvain.preprocessing_pipeline(**kw, device="cpu"), jd, td)
    _eq(td.data.X, jd.data.X)
    _close(td.data.obsm["CellPCA"], jd.data.obsm["CellPCA"])
    tg, jg = sp.csr_matrix(td.data.obsp["NeighborGraph"]), sp.csr_matrix(jd.data.obsp["NeighborGraph"])
    _eq(tg.indptr, jg.indptr), _eq(tg.indices, jg.indices)
    np.testing.assert_allclose(tg.data, jg.data, rtol=1e-4, atol=1e-4)
    (tx, ty), (jx, jy) = td.get_train_data(), jd.get_train_data()
    np.testing.assert_allclose(_dense(tx), _dense(jx), rtol=1e-4, atol=1e-4)
    _eq(ty, jy)
    adj = tsd.louvain_preprocess(counts, dim=10, n_neighbors=8, device=CPU)
    assert (adj != td.data.obsp["NeighborGraph"]).nnz == 0


def _spagcn():
    names = np.array([f"g{i}" for i in range(50)], dtype=object)
    names[[3, 7, 11]] = ["MT-CO1", "ERCC-0001", "mt-x"]
    (counts, xy, xy_pixel, image), jd, td = _slide(17, 18, seed=47, names=names)
    kw = dict(beta=9, dim=10, log_level="WARNING")
    _run(jsd.SpaGCN.preprocessing_pipeline(**kw),
         tsd.SpaGCN.preprocessing_pipeline(**kw, device="cpu"), jd, td)
    assert "mt-x" in td.data.var_names and td.data.shape[1] == 48
    (tx, tadj, tadj2), ty = td.get_train_data()
    (jx, jadj, jadj2), jy = jd.get_train_data()
    _close(tx, jx)
    _sq_close(tadj, jadj)
    _sq_close(tadj2, jadj2)
    _eq(ty, jy)
    inp = tsd.spagcn_preprocess(counts, names, xy, xy_pixel, image, beta=9, dim=10, device=CPU)
    for got, want in ((inp.embed, tx), (inp.adj, tadj), (inp.adj_2d, tadj2)):
        _eq(got, want)
    _eq(names[inp.genes], td.data.var_names)


def _deconvo(seed, names=None):
    x_ref, labels, x_spots, portions, coords = deconvo_case(n_genes=80, seed=seed)
    x_spots[:, 5] = 0  # a gene no spot expresses
    n_ref = len(x_ref)
    names = np.array([f"g{k}" for k in range(80)]) if names is None else names
    x = np.vstack([x_ref, x_spots]).astype(np.float32)
    cell_types = np.r_[labels, ["spot"] * len(x_spots)]
    j, t = _pair(x, names, cellType=cell_types)
    portion = np.vstack([np.zeros((n_ref, portions.shape[1])), portions]).astype(np.float32)
    xy = np.vstack([np.zeros((n_ref, 2)), coords]).astype(np.float32)
    jd, td = JData(j), Data(t)
    for d in (jd, td):
        d.data.obsm["spatial"] = xy
        d.data.obsm["cell_type_portion"] = portion
        d.set_split_idx("ref", list(range(n_ref)))
        d.set_split_idx("test", list(range(n_ref, len(x))))
    return (x_ref, labels, x_spots, coords, names), jd, td


def _card():
    names = np.array([("mt-" if k % 13 == 0 else "g") + str(k) for k in
                      np.random.default_rng(0).permutation(80)])
    (x_ref, labels, x_spots, coords, names), jd, td = _deconvo(48, names)
    _run(jdec.Card.preprocessing_pipeline(log_level="WARNING"),
         tdec.Card.preprocessing_pipeline(log_level="WARNING"), jd, td)
    tp, jp = td.data.varm["CellTopicProfile"], jd.data.varm["CellTopicProfile"]
    assert list(tp.columns) == list(jp.columns)
    _eq(tp.to_numpy(), jp.to_numpy())
    for col in jd.data.var.columns:
        _eq(td.data.var[col], jd.data.var[col].to_numpy(), col)
    _eq(td.data.uns["gene_summary"], jd.data.uns["gene_summary"])
    (tx, ty), (jx, jy) = td.get_data("test"), jd.get_data("test")
    for got, want in zip((*tx, ty), (*jx, jy)):
        _eq(got, want)
    inp = tdec.card_preprocess(x_ref, labels, x_spots, coords, names)
    _eq(inp.x, tx[0]), _eq(inp.spatial, tx[1]), _eq(inp.basis, tp.to_numpy())
    _eq(inp.genes, td.data.var_names)
    assert inp.cell_types == list(tp.columns)


def _spatialdecon():
    (x_ref, labels, *_), jd, td = _deconvo(49)
    kw = dict(ct_profile_split="ref", log_level="WARNING")
    _run(jdec.SpatialDecon.preprocessing_pipeline(**kw),
         tdec.SpatialDecon.preprocessing_pipeline(**kw), jd, td)
    tp, jp = td.data.varm["CellTopicProfile"], jd.data.varm["CellTopicProfile"]
    assert list(tp.columns) == list(jp.columns) and len(tp.columns) == 3
    _eq(tp.to_numpy(), jp.to_numpy())
    (tx, ty), (jx, jy) = td.get_data("test"), jd.get_data("test")
    _eq(tx, jx), _eq(ty, jy)
    profile, cts = tdec.spatialdecon_preprocess(x_ref, labels)
    _eq(profile, tp.to_numpy())
    assert cts == list(tp.columns)


def _spotlight():
    _, jd, td = _deconvo(50)
    _run(jdec.SPOTlight.preprocessing_pipeline(log_level="WARNING"),
         tdec.SPOTlight.preprocessing_pipeline(log_level="WARNING"), jd, td)
    for split in ("ref", "test"):
        (tx, ty), (jx, jy) = td.get_data(split), jd.get_data(split)
        _eq(tx, jx), _eq(ty, jy)


def _efnst(monkeypatch):
    """The morphology CNN is stubbed with the same features on both sides:
    the stLearn case holds it."""
    feat = np.random.default_rng(51).standard_normal((48, 10)).astype(np.float32)
    monkeypatch.setattr(jsf.MorphologyFeatureCNN, "__call__", lambda self, data: (
        data.data.obsm.__setitem__(self.out, feat), data)[1])
    monkeypatch.setattr(S, "morphology_feature_cnn", lambda *a, **k: feat)
    (counts, xy, xy_pixel, image), jd, td = _slide(8, 6, seed=51)
    counts[:, 4] = 0
    jd.data.X[:, 4] = 0
    td.data.X[:, 4] = 0
    kw = dict(pca_n_comps=10, k=6, log_level="WARNING")
    _run(jsd.EfNsSTRunner.preprocessing_pipeline(**kw),
         tsd.EfNsSTRunner.preprocessing_pipeline(**kw, device="cpu"), jd, td)
    assert "4" not in td.data.var_names
    _eq(td.data.X, jd.data.X)
    (tpca, tmorph, tg), ty = td.get_train_data()
    (jpca, jmorph, jg), jy = jd.get_train_data()
    _close(tpca, jpca)
    _close(tmorph, jmorph)
    _eq(tg, jg), _eq(ty, jy)
    inp = tsd.efnst_preprocess(counts, xy, xy_pixel, image, pca_n_comps=10, k=6, device=CPU)
    _eq(inp.cell_pca, tpca), _eq(inp.morph, tmorph), _eq(inp.graph, tg)
    _eq(inp.genes, td.data.var_names.astype(np.int64))


def _stlearn(monkeypatch):
    _jax_encoder(monkeypatch)
    (counts, xy, xy_pixel, image), jd, td = _slide(8, 6, seed=52)
    jpipe = jstlearn._sme_pipeline(n_components=10, log_level="WARNING")
    for model in (tstlearn.StKmeans, tstlearn.StLouvain):
        assert model.preprocessing_pipeline(10).hexdigest() == jpipe.hexdigest()
    _run(jpipe, tstlearn.StKmeans.preprocessing_pipeline(10, log_level="WARNING", device="cpu"),
         jd, td)
    _close(td.data.X, jd.data.X, 1e-5)
    for key in ("CellPCA", "MorphologyFeatureCNN", "SMEFeature"):
        _close(td.data.obsm[key], jd.data.obsm[key], msg=key)
    _close(td.data.obsp["SMEGraph"], jd.data.obsp["SMEGraph"], msg="SMEGraph")
    (tx, ty), (jx, jy) = td.get_train_data(), jd.get_train_data()
    _close(tx, jx), _eq(ty, jy)
    inp = tsd.sme_preprocess(counts, xy, xy_pixel, image, n_components=10, device=CPU)
    for got, key in ((inp.feature, "SMEFeature"), (inp.cell_pca, "CellPCA"),
                     (inp.morph, "MorphologyFeatureCNN")):
        _eq(got, td.data.obsm[key], key)
    _eq(inp.adj, td.data.obsp["SMEGraph"]), _eq(inp.x, td.data.X)
    _eq(inp.genes, td.data.var_names.astype(np.int64))


SPATIAL = {
    "louvain": _louvain,
    "spagcn": _spagcn,
    "card": _card,
    "spatialdecon": _spatialdecon,
    "spotlight": _spotlight,
    "efnst": _efnst,
    "stlearn": _stlearn,
}


@pytest.mark.parametrize("name", list(SPATIAL))
def test_spatial_pipelines_match_jax_and_the_array_front(name, monkeypatch):
    case = SPATIAL[name]
    case(monkeypatch) if name in ("efnst", "stlearn") else case()
