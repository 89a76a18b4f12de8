"""Port parity for the Data-container ground: the pandas-free Frame, AnnData,
concat and MuData (dance_tpu_torch.data.container), the split-aware Data
(data.base), the registry, Config, the transform base and the structural
transforms (transforms.misc), AnnDataTransform's in-place adaptors
(transforms.interface), the cell-gene graph transforms
(transforms.graph.cell_feature_graph), Graph.from_adjacency and the row
normalization, the synthetic generators (datasets) and the small utilities.

The same numpy inputs, made from a seed, go through the JAX package's
container and transforms and through the port's. Tolerances: container
operations, names, splits, masks, graph structure and the generators'
arrays exact; host float arithmetic that runs the same numpy calls exact;
PCA-derived features within rtol/atol 1e-4 (as tests/test_torch_graphsc.py);
edge weights within 1e-6.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import dance_tpu.datasets.synthetic as jsyn
from dance_tpu import registry as jreg
from dance_tpu.config import Config as JConfig
from dance_tpu.data import AnnData as JAnnData
from dance_tpu.data import Data as JData
from dance_tpu.data import MuData as JMuData
from dance_tpu.data import concat as jconcat
from dance_tpu.graph import Graph as JGraph
from dance_tpu.sc import pp as jpp
from dance_tpu.transforms import misc as jmisc
from dance_tpu.transforms.graph import cell_feature_graph as jcfg
from dance_tpu.utils import default as jdefault
from dance_tpu.utils import hexdigest as jhexdigest
from dance_tpu.utils import is_numeric as jis_numeric
from dance_tpu_torch import registry as treg
from dance_tpu_torch.config import Config
from dance_tpu_torch.data import AnnData, Data, Frame, MuData, concat, read_h5ad, write_h5ad
from dance_tpu_torch.datasets import synthetic as tsyn
from dance_tpu_torch.datasets.singlemodality import cell_label_to_df
from dance_tpu_torch.graph import Graph
from dance_tpu_torch.transforms import interface as tinterface
from dance_tpu_torch.transforms import misc as tmisc
from dance_tpu_torch.transforms.base import AnnDataAdaptor, BaseTransform
from dance_tpu_torch.transforms.graph import cell_feature_graph as tcfg
from dance_tpu_torch.utils import default, hexdigest, is_numeric
from dance_tpu_torch.utils.status import deprecated, experimental
from dance_tpu_torch.utils.wrappers import CastOutputType, TimeIt, as_1d_array
from torch_cases import typed_counts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CPU = torch.device("cpu")


def _inputs(seed=0, n=30, g=12, sparse=False):
    """Counts, obs and var columns, an obsm array, a label one-hot, varm, obsp, a layer."""
    rng = np.random.default_rng(seed)
    x = rng.poisson(1.0, (n, g)).astype(np.float32)
    obs = {"kind": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
           "depth": rng.random(n)}
    var = {"gidx": np.arange(g), "w": rng.random(g).astype(np.float32)}
    cells = [f"c{i}" for i in rng.permutation(n)]
    genes = [f"g{i}" for i in rng.permutation(g)]
    extra = {"obsm": rng.random((n, 3)), "varm": rng.random((g, 2)),
             "obsp": sp.random(n, n, density=0.2, random_state=seed, format="csr"),
             "layer": rng.random((n, g)), "labels": rng.integers(0, 4, n)}
    return (sp.csr_matrix(x) if sparse else x), obs, var, cells, genes, extra


def _pair(seed=0, sparse=False, **kw):
    """The same AnnData in both packages."""
    x, obs, var, cells, genes, ex = _inputs(seed, sparse=sparse, **kw)
    types = [f"t{i}" for i in range(4)]
    onehot = np.eye(4, dtype=np.float32)[ex["labels"]]
    j = JAnnData(x.copy(), obs=pd.DataFrame(obs, index=cells), var=pd.DataFrame(var, index=genes))
    t = AnnData(x.copy(), obs=Frame(obs, index=cells), var=Frame(var, index=genes))
    for a, frame in ((j, pd.DataFrame(onehot, index=cells, columns=types)),
                     (t, Frame(onehot, index=cells, columns=types))):
        a.obsm["emb"] = ex["obsm"].copy()
        a.obsm["cell_type"] = frame
        a.varm["load"] = ex["varm"].copy()
        a.obsp["graph"] = ex["obsp"].copy()
        a.layers["counts"] = ex["layer"].copy()
        a.uns["note"] = {"k": 1}
    return j, t


def _dense(m):
    return m.toarray() if sp.issparse(m) else np.asarray(m)


def assert_frame_equal(frame: Frame, df: pd.DataFrame):
    """A Frame against a DataFrame: the index, the column names, each column."""
    np.testing.assert_array_equal(np.asarray(frame.index), df.index.to_numpy().astype(str))
    assert frame.columns == list(df.columns)
    for col in df.columns:
        np.testing.assert_array_equal(frame[col], df[col].to_numpy(), err_msg=str(col))


def assert_adata_equal(t: AnnData, j: JAnnData):
    assert t.shape == j.shape
    if j.X is not None:
        assert sp.issparse(t.X) == sp.issparse(j.X)
        np.testing.assert_array_equal(_dense(t.X), _dense(j.X))
    assert_frame_equal(t.obs, j.obs)
    assert_frame_equal(t.var, j.var)
    for attr in ("obsm", "varm", "obsp", "varp", "layers"):
        tm, jm = getattr(t, attr), getattr(j, attr)
        assert list(tm) == list(jm), attr
        for k in jm:
            if isinstance(jm[k], pd.DataFrame):
                assert_frame_equal(tm[k], jm[k])
            else:
                np.testing.assert_array_equal(_dense(tm[k]), _dense(jm[k]), err_msg=f"{attr}[{k}]")
    assert t.uns.keys() == j.uns.keys()


# --------------------------------------------------------------------------
# Frame, AnnData, concat, MuData
# --------------------------------------------------------------------------


def test_frame_matches_dataframe():
    rng = np.random.default_rng(0)
    cols = {"a": rng.random(6), "b": np.arange(6), "c": np.array(list("uvwxyz"))}
    names = [f"r{i}" for i in range(6)]
    t, j = Frame(cols, index=names), pd.DataFrame(cols, index=names)
    assert_frame_equal(t, j)
    assert len(t) == len(j) and t.shape == j.shape and t.empty == j.empty
    idx = np.array([4, 0, 2])
    assert_frame_equal(t.take(idx), j.iloc[idx])
    assert_frame_equal(t.take(np.arange(6) % 2 == 0), j.iloc[np.arange(6) % 2 == 0])
    assert_frame_equal(t.loc(["r3", "r1"]), j.loc[["r3", "r1"]])
    t["d"], j["d"] = 7, 7  # a scalar is broadcast
    assert_frame_equal(t, j)
    assert_frame_equal(t[["b", "a"]], j[["b", "a"]])
    mat = rng.random((5, 3)).astype(np.float32)
    tm, jm = Frame(mat, columns=["x", "y", "z"]), pd.DataFrame(mat, columns=["x", "y", "z"])
    np.testing.assert_array_equal(tm.to_numpy(), jm.to_numpy())
    assert_frame_equal(tm.add_prefix("m:"), jm.add_prefix("m:"))
    copy = t.copy()
    copy["a"][0] = -1.0
    assert t["a"][0] != -1.0  # a copy owns its columns
    empty = Frame(index=["p", "q"])
    assert empty.empty == pd.DataFrame(index=["p", "q"]).empty and empty.to_numpy().shape == (2, 0)
    with pytest.raises(ValueError, match="rows"):
        t["e"] = np.arange(5)
    with pytest.raises(ValueError, match="index"):
        t.index = ["x"]
    with pytest.raises(KeyError, match="not found"):
        t.loc(["nope"])


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("kind", ["positions", "mask", "names", "slice", "both_axes", "vars"])
def test_anndata_getitem_matches_jax(kind, sparse):
    j, t = _pair(1, sparse)
    rng = np.random.default_rng(5)
    rows = rng.choice(30, 11, replace=False)
    key = {"positions": rows,
           "mask": np.isin(np.arange(30), rows),
           "names": np.asarray(j.obs_names)[rows].tolist(),
           "slice": slice(3, 25, 2),
           "both_axes": (rows, np.array([5, 0, 7])),
           "vars": (slice(None), np.asarray(j.var_names)[[2, 9, 4]].tolist())}[kind]
    assert_adata_equal(t[key], j[key])


def test_anndata_inplace_subsets_names_and_transpose_match_jax():
    j, t = _pair(2)
    keep = np.arange(30) % 3 != 0
    j._inplace_subset_obs(keep), t._inplace_subset_obs(keep)
    genes = np.asarray(j.var_names)[[1, 4, 8, 2]]
    j._inplace_subset_var(genes), t._inplace_subset_var(genes)
    assert_adata_equal(t, j)
    assert_adata_equal(t.T, j.T)
    assert_adata_equal(t.copy(), j.copy())
    dup = ["a", "b", "a", "c", "a"]
    ja, ta = JAnnData(np.zeros((5, 1)), obs=pd.DataFrame(index=dup)), AnnData(np.zeros((5, 1)),
                                                                              obs=Frame(index=dup))
    ja.obs_names_make_unique(), ta.obs_names_make_unique()
    np.testing.assert_array_equal(ta.obs_names, ja.obs_names.to_numpy())
    ta.raw_to(), ja.raw_to()
    np.testing.assert_array_equal(ta.raw.X, ja.raw.X)
    with pytest.raises(ValueError, match="leading dim"):
        t.obsm["bad"] = np.zeros((3, 2))
    with pytest.raises(ValueError, match="New X shape"):
        t.X = np.zeros((2, 2))
    with pytest.raises(NotImplementedError, match="h5py"):
        t.write_h5ad("unused.h5ad")
    with pytest.raises(NotImplementedError, match="h5py"):
        read_h5ad("unused.h5ad")
    with pytest.raises(NotImplementedError, match="h5py"):
        write_h5ad(t, "unused.h5ad")


@pytest.mark.parametrize("join,label", [("inner", None), ("outer", "batch")])
def test_concat_matches_jax(join, label):
    j1, t1 = _pair(3)
    j2, t2 = _pair(4)
    # inner: the second has 9 of the genes, in its own order; outer: all of
    # them in its own order (JAX's outer join raises on a gene one part lacks)
    genes = np.asarray(j2.var_names)[:9 if join == "inner" else 12]
    j2, t2 = j2[:, genes], t2[:, genes]
    keys = ["first", "second"] if label else None
    jc = jconcat([j1, j2], join=join, label=label, keys=keys)
    tc = concat([t1, t2], join=join, label=label, keys=keys)
    np.testing.assert_array_equal(_dense(tc.X), _dense(jc.X))
    assert_frame_equal(tc.obs, jc.obs)
    np.testing.assert_array_equal(tc.var_names, jc.var_names.to_numpy())


def test_mudata_matches_jax():
    rng = np.random.default_rng(6)
    x1, x2 = rng.random((8, 5)), rng.random((8, 3))
    names = [f"c{i}" for i in (3, 1, 10, 0, 7, 2, 5, 4)]  # not sorted: the join sorts
    obs1, obs2 = {"kind": np.arange(8)}, {"score": rng.random(8)}
    g1, g2 = [f"r{i}" for i in range(5)], [f"a{i}" for i in range(3)]
    jm = JMuData({"rna": JAnnData(x1, obs=pd.DataFrame(obs1, index=names),
                                  var=pd.DataFrame(index=g1)),
                  "adt": JAnnData(x2, obs=pd.DataFrame(obs2, index=names),
                                  var=pd.DataFrame(index=g2))})
    tm = MuData({"rna": AnnData(x1, obs=Frame(obs1, index=names), var=Frame(index=g1)),
                 "adt": AnnData(x2, obs=Frame(obs2, index=names), var=Frame(index=g2))})
    assert_frame_equal(tm.obs, jm.obs)
    assert tm.shape == jm.shape
    np.testing.assert_array_equal(tm.var.index, jm.var.index.to_numpy())
    rows = np.array([6, 1, 2])
    for key in (rows, (rows, np.array([0, 6, 2])), (rows, np.arange(8) % 2 == 1),
                (slice(None), ["a2", "r1"])):
        ts, js = tm[key], jm[key]
        assert_frame_equal(ts.obs, js.obs)
        for k in js.mod:
            assert_adata_equal(ts.mod[k], js.mod[k])
    assert tm["rna"] is tm.mod["rna"]
    assert_frame_equal(tm.copy().obs, jm.copy().obs)
    tm.mod["rna"].obs["extra"], jm.mod["rna"].obs["extra"] = 1.5, 1.5
    tm.update(), jm.update()
    assert_frame_equal(tm.obs, jm.obs)


def test_mudata_outer_join_fills_missing_cells_as_pandas():
    a = {"v": np.arange(3)}
    jm = JMuData({"m1": JAnnData(np.ones((3, 1)), obs=pd.DataFrame(a, index=["x", "y", "z"])),
                  "m2": JAnnData(np.ones((3, 1)), obs=pd.DataFrame(
                      {"w": np.array(["p", "q", "r"], dtype=object)}, index=["y", "z", "w"]))})
    tm = MuData({"m1": AnnData(np.ones((3, 1)), obs=Frame(a, index=["x", "y", "z"])),
                 "m2": AnnData(np.ones((3, 1)), obs=Frame({"w": np.array(["p", "q", "r"],
                                                                         dtype=object)},
                                                          index=["y", "z", "w"]))})
    np.testing.assert_array_equal(tm.obs.index, jm.obs.index.to_numpy())
    np.testing.assert_array_equal(tm.obs["m1:v"], jm.obs["m1:v"].to_numpy())
    assert [str(v) for v in tm.obs["m2:w"]] == [str(v) for v in jm.obs["m2:w"]]


# --------------------------------------------------------------------------
# Data: splits, config, get_feature, append, pop, filter_cells
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(train_size=20), dict(train_size=10, val_size=5),
                                dict(train_size=-1, val_size=4, test_size=6),
                                dict(train_size="all"), dict(full_split_name="ref"),
                                dict(split_index_range_dict={"a": (0, 7), "b": (7, 30)}),
                                dict()],
                         ids=["train", "train_val", "minus_one", "all", "full", "ranges", "none"])
def test_data_splits_match_jax(kw):
    j, t = _pair(7)
    jd, td = JData(j, **kw), Data(t, **kw)
    assert td.splits == jd.splits
    for name in ("train", "val", "test"):
        assert td.get_split_idx(name) == jd.get_split_idx(name)
    for name in jd.splits:
        np.testing.assert_array_equal(td.get_split_mask(name), jd.get_split_mask(name))
        assert_adata_equal(td.get_split_data(name), jd.get_split_data(name))
    assert td.cells == jd.cells and td.num_cells == jd.num_cells
    assert td.num_features == jd.num_features
    if "train_size" in kw and kw["train_size"] != "all":
        with pytest.raises(KeyError, match="Unknown split"):
            td.get_split_idx("nope", error_on_miss=True)


def test_data_split_errors_and_mask_devices():
    _, t = _pair(8)
    with pytest.raises(ValueError, match="At most one"):
        Data(t, train_size=-1, test_size=-1)
    with pytest.raises(ValueError, match="invalid"):
        Data(t, train_size=40)
    with pytest.raises(TypeError, match="int"):
        Data(t, train_size=0.5)
    with pytest.raises(TypeError, match="AnnData or MuData"):
        Data(np.zeros(3))
    d = Data(t, train_size=20)
    mask = d.get_split_mask("train", return_type="torch", device="cpu")
    assert mask.device == CPU and int(mask.sum()) == 20
    with pytest.raises(ValueError, match="jax"):
        d.get_split_mask("train", return_type="jax")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            d.get_split_mask("train", return_type="torch")


def test_set_config_and_its_refusal_match_jax():
    j, t = _pair(9)
    jd, td = JData(j), Data(t)
    for d in (jd, td):
        d.set_config(label_channel="cell_type", feature_channel="emb")
        d.set_config(label_channel="cell_type")  # the same value: no change, no error
    assert td.config == jd.config
    for d in (jd, td):
        with pytest.raises(KeyError, match="refusing"):
            d.set_config(label_channel="other")
        with pytest.raises(KeyError, match="Unknown config"):
            d.set_config(labels="x")
        with pytest.raises(TypeError, match="Inconsistent config types"):
            d.set_config(feature_channel=["a"], feature_channel_type="obsm", overwrite=True)
        with pytest.raises(ValueError, match="Inconsistent config lengths"):
            d.set_config(feature_channel=["a", "b"], feature_channel_type=["obsm"],
                         overwrite=True)
        d.set_config(label_channel="other", overwrite=True)
    assert td.config == jd.config
    assert td.data.uns["dance_config"] is td.config


CHANNELS = [("X", None), ("raw_X", None), ("obs", "depth"), ("var", "w"), ("obsm", "emb"),
            ("obsm", "cell_type"), ("varm", "load"), ("obsp", "graph"), ("layers", "counts"),
            ("uns", "note"), (None, None)]


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("return_type", ["numpy", "sparse", "default"])
@pytest.mark.parametrize("channel_type,channel", CHANNELS,
                         ids=[f"{a}-{b}" for a, b in CHANNELS])
def test_get_feature_matches_jax(channel_type, channel, return_type, sparse):
    j, t = _pair(10, sparse)
    j.raw_to(), t.raw_to()
    jd, td = JData(j, train_size=18), Data(t, train_size=18)
    kw = dict(channel=channel, channel_type=channel_type, return_type=return_type)
    for split in (None, "train") if return_type != "default" else (None,):
        try:
            want = jd.get_feature(split_name=split, **kw)
        except Exception as err:  # the same refusal in both
            with pytest.raises(type(err)):
                td.get_feature(split_name=split, **kw)
            continue
        got = td.get_feature(split_name=split, **kw)
        if channel_type == "uns":
            assert got == want
        elif isinstance(want, pd.DataFrame):
            assert_frame_equal(got, want)
        else:
            assert sp.issparse(got) == sp.issparse(want)
            np.testing.assert_array_equal(_dense(got), _dense(want))


def test_get_feature_torch_and_jax_return_types():
    _, t = _pair(11)
    d = Data(t, train_size=10)
    got = d.get_feature(channel="emb", split_name="train", return_type="torch", device="cpu")
    assert got.device == CPU and got.shape == (10, 3)
    np.testing.assert_array_equal(got.numpy(), t.obsm["emb"][:10])
    with pytest.raises(TypeError, match="non-numeric"):
        d.get_feature(channel="kind", channel_type="obs", return_type="torch", device="cpu")
    with pytest.raises(ValueError, match="jax"):
        d.get_feature(channel="emb", return_type="jax")
    with pytest.raises(ValueError, match="split_name"):
        d.get_feature(channel="emb", split_name="train", return_type="default")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            d.get_feature(channel="emb", return_type="torch")


@pytest.mark.parametrize("config", [
    {"feature_channel": [None, "graph"], "feature_channel_type": ["X", "obsp"],
     "label_channel": "depth", "label_channel_type": "obs"},
    {"feature_channel": ["emb", "counts"], "feature_channel_type": ["obsm", "layers"],
     "label_channel": "cell_type"},
    {"label_channel": "cell_type"}], ids=["stagate_like", "two_channels", "label_only"])
def test_get_x_y_and_split_getters_match_jax(config):
    j, t = _pair(12, sparse=True)
    jd, td = JData(j, train_size=12, val_size=6), Data(t, train_size=12, val_size=6)
    jd.set_config_from_dict(config), td.set_config_from_dict(config)
    for name in ("get_train_data", "get_val_data", "get_test_data"):
        jx, jy = getattr(jd, name)()
        tx, ty = getattr(td, name)()
        jx = jx if isinstance(jx, list) else [jx]
        tx = tx if isinstance(tx, list) else [tx]
        assert len(tx) == len(jx)
        for a, b in zip(tx, jx):
            np.testing.assert_array_equal(_dense(a), _dense(b))
        np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(td.y, jd.y)
    tx = td.get_x("train", return_type="torch", device="cpu")
    for a, b in zip(tx if isinstance(tx, list) else [tx],
                    jd.get_x("train") if isinstance(jd.get_x("train"), list)
                    else [jd.get_x("train")]):
        np.testing.assert_array_equal(a.numpy(), _dense(b))


@pytest.mark.parametrize("mode", ["merge", "rename", "new_split", None])
def test_append_matches_jax(mode):
    (j1, t1), (j2, t2) = _pair(13), _pair(14)
    jd, td = JData(j1, train_size=20), Data(t1, train_size=20)
    jo, to = JData(j2, train_size=10, val_size=5), Data(t2, train_size=10, val_size=5)
    kw = {"rename": dict(rename_dict={"train": "ref_train", "val": "ref_val",
                                      "test": "ref_test"}),
          "new_split": dict(new_split_name="query")}.get(mode, {})
    jd.append(jo, mode=mode, label_batch=True, **kw)
    td.append(to, mode=mode, label_batch=True, **kw)
    assert td.splits == jd.splits
    np.testing.assert_array_equal(td.X, jd.X)
    np.testing.assert_array_equal(td.data.obs_names, jd.data.obs_names.to_numpy())
    np.testing.assert_array_equal(td.data.obs["batch"], jd.data.obs["batch"].to_numpy())
    np.testing.assert_array_equal(td.data.obs["depth"], jd.data.obs["depth"].to_numpy())
    if mode == "new_split":
        with pytest.raises(ValueError, match="already in use"):
            td.append(to, mode="new_split", new_split_name="query")
    if mode == "rename":
        with pytest.raises(KeyError, match="Missing rename"):
            Data(t1.copy(), train_size=5).append(to, mode="rename", rename_dict={"train": "x"})


def test_pop_filter_cells_and_copy_match_jax():
    j, t = _pair(15)
    jd, td = JData(j, train_size=12, val_size=8), Data(t, train_size=12, val_size=8)
    jd.pop(split_name="val"), td.pop(split_name="val")
    assert td.splits == jd.splits
    assert_adata_equal(td.data, jd.data)
    mask = np.random.default_rng(1).random(td.shape[0]) < 0.6
    jd.filter_cells(mask), td.filter_cells(mask)
    assert td.splits == jd.splits
    assert_adata_equal(td.data, jd.data)
    tc = td.copy()
    tc.data.obsm["emb"][0, 0] = -5.0
    assert td.data.obsm["emb"][0, 0] != -5.0
    assert td.obsm is td.data.obsm and td.X is td.data.X
    with pytest.raises(ValueError, match="Mask length"):
        td.filter_cells(np.ones(3, bool))


# --------------------------------------------------------------------------
# Registry, Config, utilities
# --------------------------------------------------------------------------


def test_registry_keys_resolve_like_jax():
    import dance_tpu.transforms  # noqa: F401  (registers JAX's transforms)
    import dance_tpu_torch.transforms  # noqa: F401

    ours = set(treg.REGISTRY.children("preprocessor", non_leaf_node=False))
    theirs = set(jreg.REGISTRY.children("preprocessor", non_leaf_node=False))
    assert {"preprocessor.feature.cell.WeightedFeaturePCA", "preprocessor.misc.Compose",
            "preprocessor.misc.SetConfig", "preprocessor.interface.AnnDataTransform",
            "preprocessor.graph.cell.PCACellFeatureGraph",
            "preprocessor.graph.spatial.StagateGraph",
            "preprocessor.filter.gene.FilterGenesPercentile"} <= ours
    assert ours <= theirs  # every port key is JAX's key
    for key in sorted(ours):
        scope, name = key.rsplit(".", 1)
        got = treg.resolve_from_registry(name, "_registry_" + scope)
        want = jreg.resolve_from_registry(name, "_registry_" + scope)
        assert got.__name__ == want.__name__ and got.__module__.startswith("dance_tpu_torch.")
    assert treg.REGISTRY is not jreg.REGISTRY


def test_dotdict_and_registry_semantics_match_jax():
    for mod in (treg, jreg):
        r = mod.Registry()
        reg = mod.register
        reg("a", "b", name="f", _registry=r)(len)
        reg("a", "c", _registry=r)(max)
        reg("d", _registry=r)(min)
        reg("a", "b", name="f", _registry=r)(len)  # the same object again: fine
        with pytest.raises(KeyError, match="already registered"):
            reg("a", "b", name="f", _registry=r)(abs)
        d = mod.DotDict({"x": {"y": 1}})
        d.set("x.z.w", 2)
        results = (list(r.children()), list(r.children("a", non_leaf_node=False)),
                   r.is_leaf_node("a.c.max"), d.get("x.z.w"), d.x.y,
                   d.get("q", missed_ok=True, default=5))
        if mod is treg:
            ours = results
        else:
            assert results == ours
        with pytest.raises(KeyError):
            d.get("x.q", missed_ok=False)
        with pytest.raises(ValueError):
            mod.DotDict({"a.b": 1})


def test_config_round_trips_json(tmp_path):
    cfg = {"a": 1, "b": {"c": [1, {"d": "e"}], "f": None}, "g": [0.5]}
    t, j = Config(cfg), JConfig(cfg)
    assert t.to_dict() == j.to_dict() and t.to_json() == j.to_json()
    path = tmp_path / "c.json"
    t.dump_json(path)
    assert Config.from_file(path).to_dict() == cfg == JConfig.from_file(path).to_dict()
    assert json.loads(path.read_text()) == cfg
    assert t.b.c[1].d == "e"
    assert t.merge({"b": {"f": 3}, "h": 4}).to_dict() == j.merge({"b": {"f": 3}, "h": 4}).to_dict()
    copy = t.copy()
    copy.b.c[1].d = "changed"
    assert t.b.c[1].d == "e"
    with pytest.raises(FileExistsError):
        t.dump_json(path, exist_handle="error")
    with pytest.raises(NotImplementedError, match="PyYAML"):
        t.to_yaml()
    with pytest.raises(NotImplementedError, match="PyYAML"):
        t.dump_yaml(tmp_path / "c.yaml")
    (tmp_path / "c.yaml").write_text("a: 1\n")
    with pytest.raises(NotImplementedError, match="PyYAML"):
        Config.from_file(tmp_path / "c.yaml")
    with pytest.raises(ValueError, match="Unknown config file"):
        Config.from_file(tmp_path / "c.txt")


def test_small_utilities_match_jax():
    for s in ("", "dance", "Compose(x)"):
        assert hexdigest(s) == jhexdigest(s)
    for v in ("1", "1e-3", "x", None, 3):
        assert is_numeric(v) == jis_numeric(v)
    assert default(None, 4) == jdefault(None, 4) and default(0, 4) == jdefault(0, 4)
    assert as_1d_array(lambda: [[1, 2], [3, 4]])().tolist() == [1, 2, 3, 4]
    assert CastOutputType(tuple)(lambda: [1, 2])() == (1, 2)
    assert TimeIt("sum")(sum)([1, 2]) == 3
    with pytest.warns(DeprecationWarning, match="deprecated"):
        deprecated(msg="x")(len)([1])
    with pytest.warns(UserWarning, match="experimental"):
        experimental(len)([1])


# --------------------------------------------------------------------------
# Transforms: the base, misc, AnnDataTransform, the cell-gene graphs
# --------------------------------------------------------------------------


def test_misc_transforms_match_jax():
    counts, _, names = typed_counts(60, 20, seed=3)
    jd = JData(JAnnData(counts.copy(), var=pd.DataFrame(index=names)), train_size=40)
    td = Data(AnnData(counts.copy(), var=Frame(index=names)), train_size=40)
    for m, d in ((jmisc, jd), (tmisc, td)):
        m.SaveRaw()(d)
        with pytest.raises(AttributeError, match="Raw data already exists"):
            m.SaveRaw()(d)
        d.data._X = d.data.X * 2
        d.data._inplace_subset_var(np.asarray(d.data.var_names)[::2])
        m.UpdateRaw()(d)
        m.SetConfig({"label_channel": "x"})(d)
        m.RemoveSplit("test")(d)
    np.testing.assert_array_equal(td.X, jd.X)
    assert td.splits == jd.splits and td.config == jd.config
    for name, kw in (("SetConfig", {"config_dict": {"a": 1}}), ("RemoveSplit",
                                                                {"split_name": "x"})):
        t, j = getattr(tmisc, name)(**kw), getattr(jmisc, name)(**kw)
        assert repr(t) == repr(j) and t.hexdigest() == j.hexdigest()
    tcomp = tmisc.Compose(tmisc.SetConfig({"a": 1}), tmisc.SaveRaw(), log_level="INFO")
    jcomp = jmisc.Compose(jmisc.SetConfig({"a": 1}), jmisc.SaveRaw(), log_level="INFO")
    assert tcomp.hexdigest() == jcomp.hexdigest() and repr(tcomp) == repr(jcomp)
    assert tcomp[1].log_level == "INFO"
    with pytest.raises(TypeError, match="BaseTransform"):
        tmisc.Compose(len)
    hist = tmisc.Compose(tmisc.SetConfig({"feature_channel": "f"}))\
        .transform_with_history(Data(AnnData(counts.copy())))
    assert list(hist) == ["original", "SetConfig"]
    assert "feature_channel" not in hist["original"].config


def test_align_mod_matches_jax():
    rng = np.random.default_rng(4)
    n1, n2 = [f"c{i}" for i in (0, 1, 2, 3, 4)], [f"c{i}" for i in (3, 1, 5, 0)]
    x1, x2 = rng.random((5, 2)), rng.random((4, 3))
    jd = JData(JMuData({"a": JAnnData(x1, obs=pd.DataFrame(index=n1)),
                        "b": JAnnData(x2, obs=pd.DataFrame(index=n2))}))
    td = Data(MuData({"a": AnnData(x1, obs=Frame(index=n1)),
                      "b": AnnData(x2, obs=Frame(index=n2))}))
    jmisc.AlignMod()(jd), tmisc.AlignMod()(td)
    for k in ("a", "b"):
        assert_adata_equal(td.data.mod[k], jd.data.mod[k])
    np.testing.assert_array_equal(td.data.obs.index, jd.data.obs.index.to_numpy())


ADAPTOR_CASES = [
    ("sc.pp.filter_cells", {"min_counts": 30}), ("sc.pp.filter_cells", {"max_genes": 30}),
    ("sc.pp.filter_genes", {"min_counts": 50}), ("scanpy.pp.filter_genes", {"min_cells": 40}),
    ("sc.pp.normalize_total", {}), ("sc.pp.normalize_total", {"target_sum": 1e4,
                                                              "key_added": "size"}),
    ("sc.pp.normalize_total", {"exclude_highly_expressed": True, "max_fraction": 0.1,
                               "key_added": "size"}),
    ("sc.pp.normalize_per_cell", {"min_counts": 20}), ("sc.pp.log1p", {"base": 2}),
    ("sc.pp.scale", {"max_value": 3}),
    ("sc.pp.highly_variable_genes", {"flavor": "seurat_v3", "n_top_genes": 12,
                                     "subset": True}),
    ("sc.pp.highly_variable_genes", {"flavor": "cell_ranger", "n_top_genes": 10,
                                     "log": True}),
    ("sc.pp.highly_variable_genes", {"flavor": "seurat", "subset": True, "log": True}),
    ("sc.pp.highly_variable_genes", {"flavor": "seurat", "n_top_genes": 10,
                                     "batch_key": "batch", "log": True}),
]


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("name,kwargs", ADAPTOR_CASES,
                         ids=[f"{n.split('.')[-1]}-{i}" for i, (n, _) in enumerate(ADAPTOR_CASES)])
def test_anndata_transform_adaptors_match_jax(name, kwargs, sparse):
    """Each in-place adaptor against JAX's in-place function: X, every obs and
    var column it writes, uns, and the subsets of every channel."""
    from dance_tpu.transforms import AnnDataTransform as JAnnDataTransform
    from dance_tpu_torch.transforms import AnnDataTransform

    kwargs = dict(kwargs)
    log = kwargs.pop("log", False)
    counts, _, names = typed_counts(80, 40, seed=5)
    x = np.log1p(counts) if log else counts
    x = sp.csr_matrix(x) if sparse else x
    batch = np.array(["p", "q"])[np.arange(80) % 2]
    j = JAnnData(x.copy(), obs=pd.DataFrame({"batch": batch}), var=pd.DataFrame(index=names))
    t = AnnData(x.copy(), obs=Frame({"batch": batch}), var=Frame(index=names))
    for a in (j, t):
        a.obsm["rows"] = np.arange(80)
        a.varm["cols"] = np.arange(40)
    jt, tt = JAnnDataTransform(name, **kwargs), AnnDataTransform(name, **kwargs)
    assert repr(tt) == repr(jt) and tt.hexdigest() == jt.hexdigest()
    jt(JData(j)), tt(Data(t))
    assert t.shape == j.shape
    np.testing.assert_array_equal(_dense(t.X), _dense(j.X))
    assert_frame_equal(t.obs, j.obs)
    assert t.var.columns == list(j.var.columns)
    for col in j.var.columns:
        np.testing.assert_array_equal(t.var[col], j.var[col].to_numpy(), err_msg=col)
    np.testing.assert_array_equal(t.obsm["rows"], j.obsm["rows"])
    np.testing.assert_array_equal(t.varm["cols"], j.varm["cols"])
    assert t.uns.get("log1p") == j.uns.get("log1p")


def test_anndata_transform_resolution():
    from dance_tpu_torch.transforms import AnnDataTransform

    with pytest.raises(KeyError, match="sc.pp.filter_genes"):
        AnnDataTransform("sc.pp.neighbors")
    assert AnnDataTransform("dance_tpu_torch.sc.pp.log1p").func is tinterface.log1p
    assert AnnDataTransform("numpy.log1p").func is np.log1p  # other names are imported
    # the name JAX records for its own in-place function resolves to the
    # port's adaptor; any other name under the JAX package is refused
    jname = f"{jpp.normalize_total.__module__}.{jpp.normalize_total.__qualname__}"
    assert AnnDataTransform(jname).func is tinterface.normalize_total
    with pytest.raises(KeyError, match="JAX package"):
        AnnDataTransform("dance_tpu.utils.hexdigest")
    code = ("import sys\n"
            "import numpy as np\n"
            "from dance_tpu_torch.data import AnnData, Data\n"
            "from dance_tpu_torch.transforms import AnnDataTransform\n"
            "d = Data(AnnData(np.ones((3, 2), np.float32)))\n"
            "AnnDataTransform('dance_tpu.sc.pp.log1p')(d)\n"
            "try:\n"
            "    AnnDataTransform('dance_tpu.sc.pp.neighbors')\n"
            "except KeyError:\n"
            "    pass\n"
            "assert np.allclose(d.data.X, np.log(2))\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'dance_tpu'))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, env={**os.environ, "PYTHONPATH": REPO})
    assert out.stdout.strip() == "[]"

    def double(adata, *, factor):
        adata._X = adata.X * factor

    t = AnnData(np.ones((3, 2)))
    AnnDataTransform(double, factor=3)(Data(t))
    np.testing.assert_array_equal(t.X, np.full((3, 2), 3.0))
    with pytest.warns(UserWarning, match="compatibility"):
        adaptor = AnnDataAdaptor(AnnDataTransform("sc.pp.log1p"), train_size="all")
    out = adaptor(AnnData(np.ones((3, 2))))
    np.testing.assert_array_equal(out.X, np.full((3, 2), np.log(2), np.float32))
    assert issubclass(AnnDataTransform, BaseTransform)


@pytest.mark.parametrize("normalize_edges", [True, False])
def test_cell_feature_graphs_match_jax(normalize_edges):
    counts, types, names = typed_counts(70, 30, seed=7)
    x = sp.csr_matrix(np.log1p(counts))
    jd = JData(JAnnData(x.copy(), var=pd.DataFrame(index=names)), train_size=50)
    td = Data(AnnData(x.copy(), var=Frame(index=names)), train_size=50)
    jcfg.PCACellFeatureGraph(8, "train", normalize_edges=normalize_edges,
                             feat_norm_mode="standardize", out="G")(jd)
    tcfg.PCACellFeatureGraph(8, "train", normalize_edges=normalize_edges,
                             feat_norm_mode="standardize", out="G", device="cpu")(td)
    for ch in ("obsm", "varm"):
        np.testing.assert_allclose(getattr(td.data, ch)["WeightedFeaturePCA"],
                                   getattr(jd.data, ch)["WeightedFeaturePCA"], rtol=1e-4,
                                   atol=1e-4)
    tg, jg = td.data.uns["G"], jd.data.uns["G"]
    assert tg.info == jg.info
    np.testing.assert_array_equal(tg.adj.indptr, jg.adj.indptr)
    np.testing.assert_array_equal(tg.adj.indices, jg.adj.indices)
    np.testing.assert_allclose(tg.adj.data, jg.adj.data, rtol=1e-6, atol=1e-6)
    for k in ("cell_id", "feat_id"):
        np.testing.assert_array_equal(tg.ndata[k], jg.ndata[k])
    np.testing.assert_allclose(tg.ndata["features"], jg.ndata["features"], rtol=1e-4, atol=1e-4)
    # the bipartite graph of a cells x features channel
    jd.data.obsm["feat"], td.data.obsm["feat"] = x.copy(), x.copy()
    jcfg.CellFeatureBipartiteGraph("feat")(jd), tcfg.CellFeatureBipartiteGraph("feat")(td)
    tb, jb = td.data.uns["g"], jd.data.uns["g"]
    assert (tb.adj != jb.adj).nnz == 0 and tb.info == jb.info
    np.testing.assert_array_equal(tb.ndata["id"], jb.ndata["id"])
    # the graph alone, from features already in obsm/varm
    tcfg.CellFeatureGraph("WeightedFeaturePCA", out="G2")(td)
    jcfg.CellFeatureGraph("WeightedFeaturePCA", out="G2")(jd)
    np.testing.assert_allclose(td.data.uns["G2"].adj.toarray(), jd.data.uns["G2"].adj.toarray(),
                               rtol=1e-6, atol=1e-6)
    assert repr(tcfg.PCACellFeatureGraph(8, "train")) == repr(jcfg.PCACellFeatureGraph(8, "train"))


def test_graph_from_adjacency_and_row_normalization_match_jax():
    adj = sp.random(12, 12, density=0.3, random_state=2, format="csr", dtype=np.float32)
    feats = np.random.default_rng(2).random((12, 4))
    t = Graph.from_adjacency(adj, feats, num_cells=12)
    j = JGraph.from_adjacency(adj, feats, num_cells=12)
    assert t.info == j.info and t.ndata["features"].dtype == np.float32
    np.testing.assert_array_equal(t.ndata["features"], j.ndata["features"])
    t.normalize_edges_row(), j.normalize_edges_row()
    np.testing.assert_array_equal(t.adj.toarray(), j.adj.toarray())


# --------------------------------------------------------------------------
# The synthetic generators, bit for bit
# --------------------------------------------------------------------------


GENERATORS = {
    "synthetic_expression": dict(n_cells=60, n_genes=20, n_types=3, seed=3),
    "annotation_data": dict(n_cells=60, n_genes=20, n_types=3, seed=3),
    "clustering_data": dict(n_cells=50, n_genes=15, seed=4),
    "imputation_data": dict(n_cells=40, n_genes=12, seed=5),
    "multimodal_data": dict(n_cells=40, n_genes=15, n_prot=6, seed=6),
    "spatial_data": dict(n_spots=50, n_genes=12, seed=7),
    "deconvo_data": dict(n_spots=20, n_genes=16, n_ref_cells=40, seed=8),
}


@pytest.mark.parametrize("name", list(GENERATORS))
def test_synthetic_generators_are_bit_identical(name):
    t = getattr(tsyn, name)(**GENERATORS[name])
    j = getattr(jsyn, name)(**GENERATORS[name])
    if name == "synthetic_expression":
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        return
    if name == "deconvo_data":
        for key, val in vars(j).items():
            if isinstance(val, pd.DataFrame):
                assert_frame_equal(getattr(t, key), val)
            else:
                np.testing.assert_array_equal(getattr(t, key), val, err_msg=key)
        return
    assert t.splits == j.splits
    if name == "multimodal_data":
        assert_frame_equal(t.data.obs, j.data.obs)
        for k in j.data.mod:
            assert_adata_equal(t.data.mod[k], j.data.mod[k])
        return
    assert_adata_equal(t.data, j.data)
    if name == "spatial_data":
        np.testing.assert_array_equal(t.data.uns["image"], j.data.uns["image"])


def test_cell_label_to_df_matches_jax():
    from dance_tpu.datasets.singlemodality import cell_label_to_df as jcell_label_to_df

    labels = ["a", {"a", "c"}, "b", "zz", ["c"]]
    t = cell_label_to_df(labels, ["a", "b", "c"], index=[f"r{i}" for i in range(5)])
    j = jcell_label_to_df(labels, ["a", "b", "c"], index=[f"r{i}" for i in range(5)])
    assert_frame_equal(t, j)
    np.testing.assert_array_equal(t.to_numpy(), j.to_numpy())
