"""The port's dataset loaders and processed-data cache
(dance_tpu_torch.datasets) against the JAX package's (dance_tpu.datasets),
on CSV files written here in the benchmarks' layouts from numpy seeds.

- The cache key: the same md5 as JAX's for the same dataset and
  ``ScDeepSort.preprocessing_pipeline``; a round trip through the port's
  own ``<root>/cache_torch/`` gives an equal ``Data`` (the cell-gene graph
  in ``uns`` included) and writes nothing under JAX's ``<root>/cache/``.
- ``CellTypeAnnotationDataset`` on two train files and a test file whose
  genes are reordered, partly missing and partly new, and one of whose
  labels is not in training: X, the names, ``obsm["cell_type"]`` and the
  splits exactly equal to JAX's.
- ``ImputationDataset`` on ``.csv`` and ``.csv.gz``: X, names and splits
  exactly equal.
- The ``.h5`` and ``map.xlsx`` branches and ``ClusteringDataset`` raise
  ``NotImplementedError``; a missing file ``FileNotFoundError``;
  ``AVAILABLE_DATA`` equals JAX's.
"""

import gzip
import os

import numpy as np
import pandas as pd
import pytest
import torch

import dance_tpu.datasets as JD
import dance_tpu_torch.datasets as TD
from dance_tpu.modules.single_modality.cell_type_annotation import ScDeepSort as JScDeepSort
from dance_tpu.utils import hexdigest as jhexdigest
from dance_tpu_torch.modules.single_modality.cell_type_annotation import ScDeepSort

CPU = torch.device("cpu")


def _write_pair(base, species, tissue, ds_id, counts, genes, cells, labels):
    """``{species}_{tissue}{id}_data.csv`` (genes x cells) and
    ``..._celltype.csv``, as the scDeepSort benchmark ships them."""
    os.makedirs(base, exist_ok=True)
    stem = os.path.join(base, f"{species}_{tissue}{ds_id}")
    pd.DataFrame(counts.T, index=genes, columns=cells).to_csv(f"{stem}_data.csv")
    pd.DataFrame({"Cell": cells, "Cell_type": labels},
                 index=np.arange(len(cells))).to_csv(f"{stem}_celltype.csv")


def _annotation_files(root, seed=0):
    rng = np.random.default_rng(seed)
    genes = [f"Gene{k}" for k in range(30)]
    types = np.array(["B cell", "T cell", "Macrophage"])
    for ds_id, n in ((11, 40), (12, 25)):
        counts = rng.poisson(rng.gamma(0.5, 2.0, (n, 30))).astype(np.int64)
        cells = [f"c{ds_id}_{i}" for i in range(n)]
        _write_pair(os.path.join(root, "train", "mouse"), "mouse", "Spleen", ds_id, counts,
                    genes, cells, types[rng.integers(0, 3, n)])
    # the test file: genes reordered, five missing, two new; a label unseen in training
    test_genes = [genes[i] for i in rng.permutation(30)[:25]] + ["New1", "New2"]
    n = 20
    counts = rng.poisson(1.5, (n, len(test_genes))).astype(np.float64) + 0.5
    labels = types[rng.integers(0, 3, n)].astype(object)
    labels[3] = "Neuron"
    _write_pair(os.path.join(root, "test", "mouse"), "mouse", "Spleen", 7, counts, test_genes,
                [f"t{i}" for i in range(n)], labels)
    return dict(train_dataset=[11, 12], test_dataset=[7], species="mouse", tissue="Spleen",
                data_dir=str(root))


def _assert_same_data(td, jd):
    np.testing.assert_array_equal(td.data.X, jd.data.X)
    assert td.data.X.dtype == jd.data.X.dtype
    np.testing.assert_array_equal(td.data.obs_names, np.asarray(jd.data.obs_names))
    np.testing.assert_array_equal(td.data.var_names, np.asarray(jd.data.var_names))
    for split in ("train", "val", "test"):
        assert list(td.get_split_idx(split) or []) == list(jd.get_split_idx(split) or [])


def test_annotation_dataset_matches_jax(tmp_path):
    kw = _annotation_files(tmp_path)
    jd = JD.CellTypeAnnotationDataset(**kw).load_data()
    td = TD.CellTypeAnnotationDataset(**kw).load_data()
    _assert_same_data(td, jd)
    assert td.data.shape == (85, 30)
    jl, tl = jd.data.obsm["cell_type"], td.data.obsm["cell_type"]
    assert tl.columns == list(jl.columns)
    np.testing.assert_array_equal(tl.to_numpy(), jl.to_numpy())
    np.testing.assert_array_equal(tl.index, jl.index.to_numpy())
    assert tl.to_numpy()[65 + 3].sum() == 0  # the unseen label maps to none


def test_cache_key_and_round_trip(tmp_path):
    kw = _annotation_files(tmp_path, seed=1)
    jds, tds = JD.CellTypeAnnotationDataset(**kw), TD.CellTypeAnnotationDataset(**kw)
    assert tds.hexdigest() == jds.hexdigest()
    assert repr(tds) == repr(jds)
    jpipe = JScDeepSort.preprocessing_pipeline(n_components=8)
    tpipe = ScDeepSort.preprocessing_pipeline(n_components=8, device=CPU)
    assert tpipe.hexdigest() == jpipe.hexdigest()
    key = jhexdigest(jds.hexdigest() + jpipe.hexdigest())
    path = tds.cache_path(tpipe)
    assert path == os.path.join(str(tmp_path.resolve()), "cache_torch", f"{key}.pkl")

    first = tds.load_data(transform=tpipe, cache=True)
    assert os.path.isfile(path) and not os.path.exists(tmp_path / "cache")
    mtime = os.path.getmtime(path)
    again = TD.CellTypeAnnotationDataset(**kw).load_data(
        transform=ScDeepSort.preprocessing_pipeline(n_components=8, device=CPU), cache=True)
    assert os.path.getmtime(path) == mtime
    _assert_same_data(again, first)
    g1, g2 = first.data.uns["PCACellFeatureGraph"], again.data.uns["PCACellFeatureGraph"]
    assert g1.info == g2.info and (g1.adj != g2.adj).nnz == 0
    for k in g1.ndata:
        np.testing.assert_array_equal(g2.ndata[k], g1.ndata[k])
    np.testing.assert_array_equal(again.data.obsm["cell_type"].to_numpy(),
                                  first.data.obsm["cell_type"].to_numpy())
    assert again.config == first.config
    redone = TD.CellTypeAnnotationDataset(**kw).load_data(transform=tpipe, cache=True,
                                                         redo_cache=True)
    _assert_same_data(redone, first)


@pytest.mark.parametrize("suffix", [".csv", ".csv.gz"])
def test_imputation_dataset_matches_jax(tmp_path, suffix):
    rng = np.random.default_rng(3)
    counts = rng.poisson(rng.gamma(0.4, 3.0, (50, 70))).astype(np.int64)
    frame = pd.DataFrame(counts.T, index=[f"g{k}" for k in range(70)],
                         columns=[f"cell_{i}" for i in range(50)])
    path = tmp_path / f"toy{suffix}"
    if suffix.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            frame.to_csv(f)
    else:
        frame.to_csv(path)
    kw = dict(data_dir=str(tmp_path), dataset="toy", train_size=0.3)
    jd = JD.ImputationDataset(**kw).load_data()
    td = TD.ImputationDataset(**kw).load_data()
    _assert_same_data(td, jd)
    assert TD.ImputationDataset(**kw).hexdigest() == JD.ImputationDataset(**kw).hexdigest()


def test_unported_branches_raise(tmp_path):
    (tmp_path / "toy.h5").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="h5py"):
        TD.ImputationDataset(data_dir=str(tmp_path), dataset="toy").load_data()
    with pytest.raises(NotImplementedError, match="h5py"):
        TD.ClusteringDataset(data_dir=str(tmp_path), dataset="toy")
    kw = _annotation_files(tmp_path, seed=2)
    ds = TD.CellTypeAnnotationDataset(**kw)
    assert ds.get_map_dict("Spleen") == {}
    os.makedirs(tmp_path / "map" / "mouse")
    (tmp_path / "map" / "mouse" / "map.xlsx").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="openpyxl"):
        ds.load_data()
    with pytest.raises(FileNotFoundError, match="mouse_Spleen99_data.csv"):
        TD.CellTypeAnnotationDataset(**{**kw, "train_dataset": [99]}).load_data()
    with pytest.raises(FileNotFoundError, match="pre-stage"):
        TD.ImputationDataset(data_dir=str(tmp_path), dataset="absent").load_data()


def test_available_data_matches_jax():
    assert TD.CellTypeAnnotationDataset.AVAILABLE_DATA == JD.CellTypeAnnotationDataset.AVAILABLE_DATA
    assert TD.ImputationDataset.AVAILABLE_DATA == JD.ImputationDataset.AVAILABLE_DATA
    assert TD.CellTypeAnnotationDataset.get_available_data() == \
        JD.CellTypeAnnotationDataset.get_available_data()


def test_registered_under_jax_keys():
    from dance_tpu.registry import REGISTRY as JREG
    from dance_tpu_torch.registry import REGISTRY as TREG
    for name in ("CellTypeAnnotationDataset", "ImputationDataset"):
        key = f"dataset.singlemodality.{name}"
        assert TREG.get(key) is getattr(TD, name) and JREG.get(key) is getattr(JD, name)
    assert TREG.get("dataset.singlemodality.ClusteringDataset") is None


def test_read_csv_matrix_quoted_names(tmp_path):
    frame = pd.DataFrame(np.arange(12.0).reshape(3, 4) / 7, index=['a,"1"', "b", "c c"],
                         columns=["x", "y,z", "w", "v"])
    frame.to_csv(tmp_path / "q.csv")
    rows, cols, vals = TD.singlemodality.read_csv_matrix(str(tmp_path / "q.csv"))
    # numbers correctly rounded, as pandas' round-trip parser reads them (its
    # default parser can be an ulp off)
    back = pd.read_csv(tmp_path / "q.csv", index_col=0, float_precision="round_trip")
    assert rows == list(back.index) and cols == list(back.columns)
    np.testing.assert_array_equal(vals, back.to_numpy())
