"""Single-modality datasets from local files (counterpart:
dance_tpu/datasets/singlemodality.py): :func:`cell_label_to_df`, the
scDeepSort CSV pairs of :class:`CellTypeAnnotationDataset` and the CSV
branch of :class:`ImputationDataset`, both registered under JAX's keys.

JAX reads the CSVs with pandas' ``read_csv(index_col=0)``; the port reads
them with the ``csv`` module (the header and the first column) and one
``np.loadtxt`` over the numbers, then does what pandas does after: the
``"<species>_<tissue><id>_"`` prefix on each file's index, ``concat`` of the
files (an outer join of their columns in order of appearance, 0 for a gap),
and the alignment of the test genes onto the train genes, in train order
(``align(join="left", fill_value=0)``). The dataset tables ``AVAILABLE_DATA``
come from copies of JAX's metadata CSVs (``dance_tpu_torch/metadata/``).

Where this differs from the JAX package:

- A name is kept as the text in the file: pandas turns an index of numbers
  into integers (``"01"`` becomes ``1``). A number field must not be empty
  (pandas reads NaN, and the container fills 0). Names are unique in a file.
- ``map.xlsx`` (the test-label mapping) needs openpyxl, an ``.h5`` file
  h5py: ``get_map_dict`` returns ``{}`` when the file is absent, as JAX's,
  and raises ``NotImplementedError`` when it is there; so does
  :class:`ImputationDataset` on an ``.h5`` file, and
  :class:`ClusteringDataset` (``.h5`` only) on construction.
- Nothing is downloaded: a missing raw file raises ``FileNotFoundError``
  naming it.
"""

import csv
import gzip
import io
import os.path as osp
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from dance_tpu_torch.data import AnnData, Data
from dance_tpu_torch.data.container import Frame
from dance_tpu_torch.datasets.base import BaseDataset
from dance_tpu_torch.registry import register_dataset
from dance_tpu_torch.settings import logger

METADIR = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "metadata")

# The staged files of each imputation dataset after unzipping (a copy of
# dance_tpu/datasets/catalogs.py:64-85).
IMPUTATION_DATASET_TO_FILE = {
    "pbmc_data": "5k_pbmc_protein_v3_filtered_feature_bc_matrix.h5",
    "mouse_embryo_data": [
        osp.join("GSE65525", name) for name in (
            "GSM1599494_ES_d0_main.csv",
            "GSM1599497_ES_d2_LIFminus.csv",
            "GSM1599498_ES_d4_LIFminus.csv",
            "GSM1599499_ES_d7_LIFminus.csv",
        )
    ],
    "mouse_brain_data": "neuron_10k_v3_filtered_feature_bc_matrix.h5",
    "human_stemcell_data": "GSE75748/GSE75748_sc_time_course_ec.csv.gz",
    "human_breast_TGFb_data": "GSE114397_HMLE_TGFb.csv",
    "human_breast_Dox_data": "GSM3141014_Zeb1_Dox.csv",
    "human_melanoma_data": "human_melanoma_data.csv",
    "mouse_visual_data": [
        "GSM2746905_B4_11_0h_counts.csv",
        "GSM2746913_B6_18_1h_counts.csv",
    ],
}


def _metadata_rows(name: str, header: bool = True) -> List:
    with open(osp.join(METADIR, name), newline="") as f:
        return list(csv.DictReader(f) if header else csv.reader(f))


def _no_h5py(what: str):
    raise NotImplementedError(f"{what} needs h5py, which the port does not use (the card's "
                              f"machine has no h5py); stage the data as CSV")


def cell_label_to_df(cell_labels, idx_to_label: List[str], index=None) -> Frame:
    """Multi-hot label frame, one float32 column a type: a cell may map to a
    set of admissible types (counterpart: singlemodality.py:29)."""
    mat = np.zeros((len(cell_labels), len(idx_to_label)), dtype=np.float32)
    pos = {label: i for i, label in enumerate(idx_to_label)}
    for i, label in enumerate(cell_labels):
        labels = label if isinstance(label, (set, list, tuple)) else [label]
        for sub in labels or []:
            if sub in pos:
                mat[i, pos[sub]] = 1
    return Frame(mat, index=index, columns=idx_to_label)


def _open_text(path: str):
    return gzip.open(path, "rt", newline="") if path.endswith(".gz") else open(path, newline="")


def _first_field(line: str) -> Tuple[str, str]:
    """A line's first CSV field and the fields after it."""
    if line.startswith('"'):
        fields = next(csv.reader([line]))
        return fields[0], ",".join(fields[1:])
    head, _, rest = line.partition(",")
    return head, rest


def read_csv_matrix(path: str) -> Tuple[List[str], List[str], np.ndarray]:
    """A numeric CSV with a header row and an index column, as pandas'
    ``read_csv(path, index_col=0)`` reads it: ``(index, columns, values)``,
    the values float64 (rows, columns). ``.gz`` is read through gzip."""
    with _open_text(path) as f:
        lines = f.read().splitlines()
    columns = next(csv.reader([lines[0]]))[1:]
    names, rows = [], []
    for line in lines[1:]:
        if not line:
            continue
        name, rest = _first_field(line)
        names.append(name)
        rows.append(rest)
    if not rows:
        return names, columns, np.zeros((0, len(columns)))
    values = np.loadtxt(io.StringIO("\n".join(rows)), delimiter=",", dtype=np.float64,
                        ndmin=2)
    if values.shape != (len(names), len(columns)):
        raise ValueError(f"{path}: {values.shape} values under {len(columns)} columns and "
                         f"{len(names)} rows")
    return names, columns, values


def read_csv_columns(path: str) -> Dict[str, List[Optional[str]]]:
    """The columns of a text CSV with an index column (pandas'
    ``read_csv(path, index_col=0)``), an empty field as None (pandas' NaN)."""
    with _open_text(path) as f:
        rows = list(csv.reader(f))
    body = [r for r in rows[1:] if r]
    return {c: [r[i + 1] if r[i + 1] != "" else None for r in body]
            for i, c in enumerate(rows[0][1:])}


class _Table:
    """Row names, column names and a float64 matrix: what pandas holds after
    ``read_csv`` and ``concat``."""

    def __init__(self, index: List[str], columns: List[str], values: np.ndarray):
        self.index, self.columns, self.values = index, columns, values

    @property
    def T(self) -> "_Table":
        return _Table(self.columns, self.index, self.values.T)

    def reindex_columns(self, columns: List[str]) -> np.ndarray:
        """The values under ``columns``, 0 where a column is missing."""
        pos = {c: i for i, c in enumerate(self.columns)}
        idx = np.array([pos.get(c, -1) for c in columns], dtype=np.int64)
        out = np.zeros((len(self.index), len(columns)), dtype=self.values.dtype)
        out[:, idx >= 0] = self.values[:, idx[idx >= 0]]
        return out

    @classmethod
    def concat(cls, tables: List["_Table"]) -> "_Table":
        """pandas' ``concat`` of rows: the columns' union in order of
        appearance, 0 for a gap (JAX's ``fillna(0)``)."""
        columns: Dict[str, None] = {}
        for t in tables:
            columns.update(dict.fromkeys(t.columns))
        columns = list(columns)
        index = [name for t in tables for name in t.index]
        if all(t.columns == columns for t in tables):
            values = np.concatenate([t.values for t in tables]) if tables else np.zeros((0, 0))
        else:
            values = np.concatenate([t.reindex_columns(columns) for t in tables])
        return cls(index, columns, values)


def _prefix(path: str) -> str:
    return "_".join(osp.basename(path).split("_")[:-1])


@register_dataset("singlemodality")
class CellTypeAnnotationDataset(BaseDataset):
    """The scDeepSort benchmark's annotation data from local files
    (counterpart: singlemodality.py:42): per dataset the pair
    ``{species}_{tissue}{id}_data.csv`` (genes x cells) and
    ``..._celltype.csv`` under ``<data_dir>/<train_dir|test_dir>/<species>/``.
    The test genes are aligned onto the train genes; a test cell type not
    seen in training maps through the tissue's table (``map.xlsx``, which
    needs openpyxl) or to no label."""

    _DISPLAY_ATTRS = ("species", "tissue", "train_dataset", "test_dataset")
    AVAILABLE_DATA = [{key: row[key] for key in ("split", "species", "tissue", "dataset")}
                      for row in _metadata_rows("scdeepsort.csv")]

    def __init__(self, full_download: bool = False, train_dataset: Optional[List] = None,
                 test_dataset: Optional[List] = None, valid_dataset: Optional[List] = None,
                 species: str = "mouse", tissue: str = "Spleen", train_dir: str = "train",
                 test_dir: str = "test", valid_dir: str = "valid", map_path: str = "map",
                 data_dir: str = "./", val_size: float = 0):
        super().__init__(data_dir, full_download)
        # the string attributes, in JAX's order, make the cache key
        self.data_dir = data_dir
        self.train_dataset = [str(i) for i in (train_dataset or [])]
        self.test_dataset = [str(i) for i in (test_dataset or [])]
        self.valid_dataset = ([str(i) for i in valid_dataset]
                              if valid_dataset is not None else None)
        self.species = species
        self.tissue = tissue
        self.train_dir = train_dir
        self.test_dir = test_dir
        self.valid_dir = valid_dir
        self.map_path = map_path
        self.val_size = val_size

    def _paths(self, subdir: str, ids: List[str]) -> List[Tuple[str, str]]:
        base = osp.join(self.data_dir, subdir, self.species)
        return [(osp.join(base, f"{self.species}_{self.tissue}{i}_data.csv"),
                 osp.join(base, f"{self.species}_{self.tissue}{i}_celltype.csv"))
                for i in ids]

    def _all_paths(self) -> List[str]:
        out = []
        for subdir, ids in ((self.train_dir, self.train_dataset),
                            (self.test_dir, self.test_dataset),
                            (self.valid_dir, self.valid_dataset or [])):
            for feat, label in self._paths(subdir, ids):
                out.extend([feat, label])
        return out

    def is_complete(self) -> bool:
        return all(osp.exists(p) for p in self._all_paths())

    def download(self):
        missing = [p for p in self._all_paths() if not osp.exists(p)]
        raise FileNotFoundError(f"Missing raw files {missing}; the port does not download: "
                                f"pre-stage the scDeepSort benchmark files under data_dir")

    @staticmethod
    def _load_features(paths: List[str]) -> _Table:
        """The cells x genes table of the data files (counterpart:
        ``_load_dfs(transpose=True)``, :117)."""
        tables = []
        for path in paths:
            logger.info("Loading data from %s", path)
            genes, cells, values = read_csv_matrix(path)
            tables.append(_Table([f"{_prefix(path)}_{c}" for c in cells], genes, values.T))
        return _Table.concat(tables)

    @staticmethod
    def _load_labels(paths: List[str], ct_col: str) -> List[Optional[str]]:
        """The ``ct_col`` column of the cell-type files, concatenated."""
        labels = []
        for path in paths:
            logger.info("Loading data from %s", path)
            labels.extend(read_csv_columns(path)[ct_col])
        return labels

    def get_map_dict(self, tissue: str) -> Dict[str, Set[str]]:
        path = osp.join(self.data_dir, self.map_path, self.species, "map.xlsx")
        if not osp.exists(path):
            return {}
        raise NotImplementedError(f"Reading {path} needs openpyxl, which the port does not use "
                                  f"(the card's machine has no openpyxl)")

    def _load_raw_data(self, ct_col: str = "Cell_type"):
        train_pairs = self._paths(self.train_dir, self.train_dataset)
        test_pairs = self._paths(self.test_dir, self.test_dataset)
        train_feat = self._load_features([p[0] for p in train_pairs])
        train_label = self._load_labels([p[1] for p in train_pairs], ct_col)
        test_feat = self._load_features([p[0] for p in test_pairs])
        test_label = self._load_labels([p[1] for p in test_pairs], ct_col)

        train_size = len(train_feat.index)
        x = np.concatenate([train_feat.values, test_feat.reindex_columns(train_feat.columns)])
        adata = AnnData(x.astype(np.float32), obs=Frame(index=train_feat.index + test_feat.index),
                        var=Frame(index=train_feat.columns))

        cell_types = set(train_label)
        idx_to_label = sorted(cell_types)
        mappings = self.get_map_dict(self.tissue)
        labels = list(train_label)
        for i in test_label:
            labels.append(i if i in cell_types else mappings.get(i))
        return adata, labels, idx_to_label, train_size, 0

    def _raw_to_dance(self, raw_data):
        adata, cell_labels, idx_to_label, train_size, valid_size = raw_data
        adata.obsm["cell_type"] = cell_label_to_df(cell_labels, idx_to_label,
                                                   index=adata.obs.index)
        return Data(adata, train_size=train_size, val_size=valid_size)


class ClusteringDataset:
    """The clustering benchmark's ``.h5`` files (counterpart:
    singlemodality.py:156): they need h5py, so construction raises."""

    def __init__(self, *args, **kwargs):
        _no_h5py("ClusteringDataset")


@register_dataset("singlemodality")
class ImputationDataset(BaseDataset):
    """The imputation benchmark's counts from a local ``{dataset}.csv`` or
    ``.csv.gz`` (genes x cells) or a staged file, split over cells with
    ``default_rng(0)`` (counterpart: singlemodality.py:213)."""

    _DISPLAY_ATTRS = ("dataset", "train_size")
    AVAILABLE_DATA = sorted(row[0] for row in _metadata_rows("imputation.csv", header=False))

    def __init__(self, data_dir: str = "data", dataset: str = "human_stemcell",
                 train_size: float = 0.1):
        super().__init__(data_dir, full_download=False)
        self.data_dir = data_dir
        self.dataset = dataset
        self.train_size = train_size

    def _candidate_paths(self) -> List[str]:
        base = osp.join(self.data_dir, self.dataset)
        paths = [f"{base}.csv", f"{base}.csv.gz", f"{base}.h5"]
        staged = IMPUTATION_DATASET_TO_FILE.get(self.dataset, [])
        for name in ([staged] if isinstance(staged, str) else staged):
            paths.append(osp.join(self.data_dir, self.dataset, name))
        return paths

    def is_complete(self) -> bool:
        return any(osp.exists(p) for p in self._candidate_paths())

    def download(self):
        raise FileNotFoundError(f"Missing raw data for {self.dataset}; the port does not "
                                f"download: pre-stage one of {self._candidate_paths()}")

    def _load_raw_data(self):
        for path in self._candidate_paths():
            if not osp.exists(path):
                continue
            if path.endswith(".h5"):
                _no_h5py(f"ImputationDataset({path!r})")
            genes, cells, values = read_csv_matrix(path)
            return AnnData(values.T.astype(np.float32), obs=Frame(index=cells),
                           var=Frame(index=genes))
        raise FileNotFoundError(self._candidate_paths())

    def _raw_to_dance(self, raw_data):
        adata = raw_data
        n = adata.n_obs
        n_train = int(n * self.train_size)
        perm = np.random.default_rng(0).permutation(n)
        data = Data(adata)
        data.set_split_idx("train", sorted(perm[:n_train].tolist()))
        data.set_split_idx("test", sorted(perm[n_train:].tolist()))
        return data


__all__ = ["CellTypeAnnotationDataset", "ClusteringDataset", "IMPUTATION_DATASET_TO_FILE",
           "ImputationDataset", "cell_label_to_df", "read_csv_columns", "read_csv_matrix"]
