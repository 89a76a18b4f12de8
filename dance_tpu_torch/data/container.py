"""Annotated-data containers without pandas (counterpart:
dance_tpu/data/container.py).

The JAX package's :class:`AnnData`/:class:`MuData` keep ``obs`` and ``var``
as pandas DataFrames. The machine with the card has no pandas, so here they
are :class:`Frame`\\ s: a string index and an ordered dict of 1-D numpy
columns. Everything else is the JAX container's surface and checks
(``:45-330``): ``X/obs/var/obsm/varm/obsp/varp/layers/uns/raw``, the names
and their ``*_make_unique``, subsetting by position, mask or name, the
in-place subsets, ``T``, :func:`concat` and the multimodal :class:`MuData`.
``X`` stays on the host, as numpy or scipy CSR.

Where this differs from the JAX package:

- An index is a numpy object array of ``str``, not a ``pd.Index``; a column
  is the numpy array as it was given (a list of strings becomes a ``<U``
  array, where pandas keeps ``object``). A scalar assigned to a column is
  broadcast, as in pandas.
- Index unions and joins follow pandas' rules for unique names: a union of
  two equal indexes keeps their order and any other union is sorted, an
  outer join of several frames (``MuData``'s joint ``obs``) is sorted, an
  intersection keeps the left order. Duplicate names are not supported
  there.
- ``write_h5ad`` raises ``NotImplementedError``: h5py is not on the card
  (:mod:`dance_tpu_torch.data.io`).
"""

from __future__ import annotations

import copy as _copy
from typing import Any, Dict, Iterable, Optional, Union

import numpy as np
import scipy.sparse as sp

ArrayLike = Union[np.ndarray, sp.spmatrix]


def as_index(names: Iterable) -> np.ndarray:
    """Names as an index: a 1-D numpy object array of ``str``."""
    names = list(names) if not isinstance(names, np.ndarray) else names.ravel().tolist()
    out = np.empty(len(names), dtype=object)
    out[:] = [str(n) for n in names]
    return out


def index_positions(index: np.ndarray, names, missing_ok: bool = False) -> np.ndarray:
    """The positions of ``names`` in ``index`` (the first occurrence of a
    repeated name); -1 for a missing name with ``missing_ok``, else
    ``KeyError``."""
    lookup: Dict[str, int] = {}
    for i, name in enumerate(index):
        lookup.setdefault(name, i)
    pos = np.array([lookup.get(str(n), -1) for n in np.asarray(names, dtype=object).ravel()],
                   dtype=np.int64)
    if not missing_ok and (pos < 0).any():
        missing = np.asarray(names, dtype=object).ravel()[pos < 0][:5]
        raise KeyError(f"names not found: {list(missing)}")
    return pos


def index_equal(a, b) -> bool:
    return len(a) == len(b) and bool(np.all(np.asarray(a, dtype=object)
                                            == np.asarray(b, dtype=object)))


def index_intersection(a, b) -> np.ndarray:
    """Names of ``a`` also in ``b``, in ``a``'s order (pandas' ``intersection``)."""
    if index_equal(a, b):
        return as_index(a)
    other, seen, out = set(b), set(), []
    for name in a:
        if name in other and name not in seen:
            seen.add(name)
            out.append(name)
    return as_index(out)


def index_union(a, b) -> np.ndarray:
    """pandas' ``union``: ``a`` when both are equal, the other when one is
    empty, else the sorted union."""
    if index_equal(a, b) or len(b) == 0:
        return as_index(a)
    if len(a) == 0:
        return as_index(b)
    return as_index(sorted(set(a) | set(b)))


class Frame:
    """A table of named 1-D numpy columns over a string index (the port's
    ``pd.DataFrame`` for ``obs``, ``var`` and label-valued ``obsm``).

    ``Frame(data, index, columns)``: ``data`` is None, a dict of columns, a
    2-D array (one column per entry of ``columns``, default ``0..k-1``) or
    another Frame; ``index`` defaults to ``"0".."n-1"``."""

    def __init__(self, data=None, index=None, columns=None):
        self._cols: Dict[Any, np.ndarray] = {}
        if isinstance(data, Frame):
            index = data.index if index is None else index
            data = {k: v.copy() for k, v in data.items()}
        elif data is not None and not isinstance(data, dict):
            mat = np.asarray(data)
            if mat.ndim != 2:
                raise ValueError(f"Frame data must be a dict or a 2-D array, got {mat.shape}")
            columns = list(range(mat.shape[1])) if columns is None else list(columns)
            if len(columns) != mat.shape[1]:
                raise ValueError(f"{len(columns)} column names for {mat.shape[1]} columns")
            data = {c: mat[:, i] for i, c in enumerate(columns)}
        data = data or {}
        if index is None:
            n = len(np.asarray(next(iter(data.values())))) if data else 0
            index = range(n)
        self._index = as_index(index)
        for key, val in data.items():
            self[key] = val

    # --- the index ------------------------------------------------------

    @property
    def index(self) -> np.ndarray:
        return self._index

    @index.setter
    def index(self, names):
        names = as_index(names)
        if len(names) != len(self._index):
            raise ValueError(f"index of length {len(names)} for a frame of {len(self._index)} "
                             f"rows")
        self._index = names

    # --- columns --------------------------------------------------------

    @property
    def columns(self) -> list:
        return list(self._cols)

    def items(self):
        return self._cols.items()

    def __contains__(self, key) -> bool:
        return key in self._cols

    def __getitem__(self, key):
        if isinstance(key, list):
            return Frame({k: self._cols[k] for k in key}, index=self._index)
        return self._cols[key]

    def __setitem__(self, key, value):
        value = np.asarray(value)
        if value.ndim == 0:
            value = np.full(len(self._index), value[()])
        if value.ndim != 1 or len(value) != len(self._index):
            raise ValueError(f"column {key!r} of shape {value.shape} for a frame of "
                             f"{len(self._index)} rows")
        self._cols[key] = value

    # --- shape and copies -----------------------------------------------

    def __len__(self) -> int:
        return len(self._index)

    @property
    def shape(self):
        return (len(self._index), len(self._cols))

    @property
    def empty(self) -> bool:
        """pandas' ``empty``: no rows or no columns."""
        return len(self._index) == 0 or not self._cols

    def take(self, idx) -> "Frame":
        """The rows at positions (or under a boolean mask) ``idx``."""
        idx = np.asarray(idx)
        idx = np.nonzero(idx)[0] if idx.dtype == bool else idx.astype(np.int64, copy=False)
        return Frame({k: v[idx] for k, v in self._cols.items()}, index=self._index[idx])

    def loc(self, names) -> "Frame":
        """The rows named ``names`` (``KeyError`` for a missing one)."""
        return self.take(index_positions(self._index, names))

    def copy(self) -> "Frame":
        return Frame(self)

    def to_numpy(self) -> np.ndarray:
        """The columns side by side, (rows, columns), in numpy's common dtype."""
        if not self._cols:
            return np.zeros((len(self._index), 0))
        return np.column_stack(list(self._cols.values()))

    def add_prefix(self, prefix: str) -> "Frame":
        return Frame({f"{prefix}{k}": v for k, v in self._cols.items()}, index=self._index)

    def __repr__(self):
        return f"Frame({len(self._index)} rows, columns {self.columns})"


def outer_join(frames) -> Frame:
    """pandas' ``join(how="outer")`` of frames with unique, disjoint-named
    columns: the sorted union of the indexes (one frame is kept as it is),
    a column missing from a row as NaN (a float or an object column)."""
    frames = list(frames)
    if not frames:
        return Frame()
    if len(frames) == 1:
        return frames[0]
    index = as_index(sorted(set().union(*(set(f.index) for f in frames))))
    out = Frame(index=index)
    for f in frames:
        pos = index_positions(f.index, index, missing_ok=True)
        hit = pos >= 0
        for key, col in f.items():
            if hit.all():
                out[key] = col[pos]
                continue
            fill = np.full(len(index), np.nan, dtype=np.float64 if col.dtype.kind in "biuf"
                           else object)
            fill[hit] = col[pos[hit]]
            out[key] = fill
    return out


def _take_rows(v, idx):
    """Row-subset any aligned value (a Frame's rows, else fancy indexing)."""
    if isinstance(v, Frame):
        return v.take(idx)
    return v[idx]


def _as_frame(x, n: int) -> Frame:
    if x is None:
        return Frame(index=range(n))  # the stringified integers anndata uses
    if isinstance(x, Frame):
        return x.copy()
    if isinstance(x, dict):
        return Frame(x)
    raise TypeError(f"Cannot interpret {type(x)} as a frame")


class AlignedMapping(dict):
    """Dict of arrays validated against a parent axis length."""

    def __init__(self, parent: "AnnData", axis: Optional[int], data: Optional[dict] = None):
        super().__init__()
        self._parent = parent
        self._axis = axis
        for k, v in (data or {}).items():
            self[k] = v

    def __setitem__(self, key, val):
        shape = getattr(val, "shape", None)
        axis = getattr(self, "_axis", None)
        parent = getattr(self, "_parent", None)
        if axis is not None and parent is not None and shape and len(shape) and shape[0]:
            expect = parent.shape[axis]
            if shape[0] != expect:
                raise ValueError(f"Value for {key!r} has leading dim {shape[0]}, "
                                 f"expected {expect}")
        super().__setitem__(key, val)

    def __reduce__(self):
        # copy/pickle as a plain dict: the parent link is rebuilt by AnnData
        return (dict, (), None, None, iter(dict(self).items()))


class Raw:
    """Frozen snapshot of (X, var): ``AnnData.raw``."""

    def __init__(self, adata: "AnnData"):
        self.X = adata.X.copy() if adata.X is not None else None
        self.var = adata.var.copy()
        self.varm = dict(adata.varm)

    @property
    def n_vars(self) -> int:
        return len(self.var)

    def to_adata(self) -> "AnnData":
        return AnnData(X=None if self.X is None else self.X.copy(), var=self.var.copy())


class AnnData:
    """Annotated cell-by-gene data matrix with the standard AnnData surface."""

    def __init__(self, X: Optional[ArrayLike] = None, obs=None, var=None, *, obsm=None,
                 varm=None, obsp=None, varp=None, layers=None, uns: Optional[dict] = None,
                 raw: Optional[Raw] = None, dtype=None, shape=None):
        if X is not None:
            if sp.issparse(X):
                X = X.tocsr()
            else:
                X = np.asarray(X)
                if X.ndim == 1:
                    X = X[:, None]
            if dtype is not None:
                X = X.astype(dtype)
            n_obs, n_vars = X.shape
        elif shape is not None:
            n_obs, n_vars = shape
        else:
            n_obs = len(obs) if obs is not None else 0
            n_vars = len(var) if var is not None else 0

        self._X = X
        self.obs = _as_frame(obs, n_obs)
        self.var = _as_frame(var, n_vars)
        if X is not None:
            if len(self.obs) != n_obs or len(self.var) != n_vars:
                raise ValueError(f"obs/var length ({len(self.obs)}, {len(self.var)}) does not "
                                 f"match X shape {X.shape}")
        self.obsm = AlignedMapping(self, 0, obsm)
        self.varm = AlignedMapping(self, 1, varm)
        self.obsp = AlignedMapping(self, 0, obsp)
        self.varp = AlignedMapping(self, 1, varp)
        self.layers = AlignedMapping(self, 0, layers)
        self.uns: Dict[str, Any] = dict(uns or {})
        self.raw = raw

    # --- basic properties -------------------------------------------------

    @property
    def X(self):
        return self._X

    @X.setter
    def X(self, val):
        if val is not None:
            if sp.issparse(val):
                val = val.tocsr()
            else:
                val = np.asarray(val)
            if val.shape != self.shape:
                raise ValueError(f"New X shape {val.shape} != {self.shape}")
        self._X = val

    @property
    def shape(self):
        if self._X is not None:
            return self._X.shape
        return (len(self.obs), len(self.var))

    @property
    def n_obs(self) -> int:
        return self.shape[0]

    @property
    def n_vars(self) -> int:
        return self.shape[1]

    @property
    def obs_names(self) -> np.ndarray:
        return self.obs.index

    @obs_names.setter
    def obs_names(self, names):
        self.obs.index = names

    @property
    def var_names(self) -> np.ndarray:
        return self.var.index

    @var_names.setter
    def var_names(self, names):
        self.var.index = names

    @staticmethod
    def _make_unique(index) -> np.ndarray:
        """De-duplicate by suffixing repeats: a, a-1, a-2, ... (as anndata)."""
        counts: Dict[str, int] = {}
        out = []
        for name in as_index(index):
            k = counts.get(name, 0)
            counts[name] = k + 1
            out.append(name if k == 0 else f"{name}-{k}")
        return as_index(out)

    def obs_names_make_unique(self):
        self.obs.index = self._make_unique(self.obs.index)

    def var_names_make_unique(self):
        self.var.index = self._make_unique(self.var.index)

    def raw_to(self):
        self.raw = Raw(self)

    # --- copies and views -------------------------------------------------

    def copy(self) -> "AnnData":
        out = AnnData(
            X=None if self._X is None else self._X.copy(),
            obs=self.obs.copy(), var=self.var.copy(),
            obsm={k: _copy.deepcopy(v) for k, v in self.obsm.items()},
            varm={k: _copy.deepcopy(v) for k, v in self.varm.items()},
            obsp={k: _copy.deepcopy(v) for k, v in self.obsp.items()},
            varp={k: _copy.deepcopy(v) for k, v in self.varp.items()},
            layers={k: _copy.deepcopy(v) for k, v in self.layers.items()},
            uns=_copy.deepcopy(self.uns), shape=self.shape)
        out.raw = self.raw
        return out

    def __deepcopy__(self, memo):
        out = self.copy()
        memo[id(self)] = out
        return out

    def __getstate__(self):
        return {"X": self._X, "obs": self.obs, "var": self.var,
                "obsm": dict(self.obsm), "varm": dict(self.varm),
                "obsp": dict(self.obsp), "varp": dict(self.varp),
                "layers": dict(self.layers), "uns": self.uns, "raw": self.raw}

    def __setstate__(self, state):
        self.__init__(X=state["X"], obs=state["obs"], var=state["var"],
                      obsm=state["obsm"], varm=state["varm"], obsp=state["obsp"],
                      varp=state["varp"], layers=state["layers"], uns=state["uns"],
                      raw=state["raw"])

    def _norm_idx(self, idx, axis: int) -> np.ndarray:
        n = self.shape[axis]
        if isinstance(idx, slice):
            return np.arange(n)[idx]
        idx = np.asarray(idx)
        if idx.dtype == bool:
            return np.nonzero(idx)[0]
        if idx.dtype.kind in "iu":
            return idx
        if idx.size == 0:
            return np.zeros(0, dtype=np.int64)
        # name-based indexing
        return index_positions(self.obs_names if axis == 0 else self.var_names, idx)

    def __getitem__(self, key) -> "AnnData":
        if not isinstance(key, tuple):
            key = (key, slice(None))
        oi = self._norm_idx(key[0], 0)
        vi = self._norm_idx(key[1], 1)
        X = None
        if self._X is not None:
            X = self._X[oi][:, vi]
        out = AnnData(
            X=X, obs=self.obs.take(oi), var=self.var.take(vi),
            obsm={k: _take_rows(v, oi) for k, v in self.obsm.items()},
            varm={k: _take_rows(v, vi) for k, v in self.varm.items()},
            obsp={k: v[oi][:, oi] for k, v in self.obsp.items()},
            varp={k: v[vi][:, vi] for k, v in self.varp.items()},
            layers={k: v[oi][:, vi] if v.shape == self.shape else _take_rows(v, oi)
                    for k, v in self.layers.items()},
            uns=_copy.deepcopy(self.uns),
            shape=(len(oi), len(vi)))
        out.raw = self.raw
        return out

    def _inplace_subset_obs(self, index):
        """Subset cells in place; ``index`` is a mask, int index, or name list."""
        sub = self[index]
        self._X = sub.X
        self.obs = sub.obs
        for attr in ("obsm", "obsp", "layers"):
            getattr(self, attr).clear()
            getattr(self, attr).update(getattr(sub, attr))

    def _inplace_subset_var(self, index):
        """Subset genes in place; ``index`` is a mask, int index, or name list."""
        sub = self[:, index]
        self._X = sub.X
        self.var = sub.var
        for attr in ("varm", "varp", "layers"):
            getattr(self, attr).clear()
            getattr(self, attr).update(getattr(sub, attr))

    def __repr__(self):
        lines = [f"AnnData object with n_obs x n_vars = {self.n_obs} x {self.n_vars}"]
        for attr in ("obs", "var"):
            cols = list(getattr(self, attr).columns)
            if cols:
                lines.append(f"    {attr}: {cols}")
        for attr in ("obsm", "varm", "obsp", "varp", "layers", "uns"):
            keys = list(getattr(self, attr))
            if keys:
                lines.append(f"    {attr}: {keys}")
        return "\n".join(lines)

    def write_h5ad(self, path):
        from dance_tpu_torch.data.io import write_h5ad
        write_h5ad(self, path)

    # transposition used by some transforms
    @property
    def T(self) -> "AnnData":
        X = None if self._X is None else (self._X.T.tocsr() if sp.issparse(self._X)
                                          else self._X.T.copy())
        return AnnData(X=X, obs=self.var.copy(), var=self.obs.copy(),
                       obsm=dict(self.varm), varm=dict(self.obsm),
                       uns=_copy.deepcopy(self.uns), shape=(self.n_vars, self.n_obs))


def concat(adatas, axis: int = 0, join: str = "inner", label=None, keys=None) -> AnnData:
    """Concatenate AnnData objects along obs (axis=0), inner-joining variables."""
    if axis != 0:
        raise NotImplementedError("Only obs-axis concatenation is supported")
    var_names = adatas[0].var_names
    for a in adatas[1:]:
        if join == "inner":
            var_names = index_intersection(var_names, a.var_names)
        else:
            var_names = index_union(var_names, a.var_names)
    parts, obs_parts = [], []
    for i, a in enumerate(adatas):
        sub = a[:, var_names] if not index_equal(a.var_names, var_names) else a
        parts.append(sub.X)
        obs = sub.obs.copy()
        if label is not None:
            obs[label] = keys[i] if keys is not None else str(i)
        obs_parts.append(obs)
    if any(sp.issparse(p) for p in parts):
        X = sp.vstack([sp.csr_matrix(p) for p in parts]).tocsr()
    else:
        X = np.concatenate([np.asarray(p) for p in parts], axis=0)
    names = np.concatenate([o.index for o in obs_parts])
    columns = []
    for o in obs_parts:
        columns += [c for c in o.columns if c not in columns]
    obs = Frame(index=[f"{n}-{i}" for i, n in enumerate(names)])
    for c in columns:  # pandas' concat: a column some parts lack is NaN there
        vals = [o[c] if c in o else np.full(len(o), np.nan) for o in obs_parts]
        obs[c] = np.concatenate(vals)
    var = adatas[0].var.loc(var_names) if not adatas[0].var.empty else Frame(index=var_names)
    return AnnData(X=X, obs=obs, var=var)


class MuData:
    """Multimodal container: named modalities sharing the obs axis."""

    def __init__(self, mod: Dict[str, AnnData], *, obs=None, uns: Optional[dict] = None,
                 obsm=None):
        self.mod: Dict[str, AnnData] = dict(mod)
        n_obs = max((m.n_obs for m in self.mod.values()), default=0)
        self.obs = _as_frame(obs, n_obs) if obs is not None else self._joint_obs()
        self.uns: Dict[str, Any] = dict(uns or {})
        self.obsm = dict(obsm or {})
        self.var = Frame(index=[n for m in self.mod.values() for n in m.var_names])
        self.varm: Dict[str, Any] = {}
        self.obsp: Dict[str, Any] = {}
        self.varp: Dict[str, Any] = {}
        self.layers: Dict[str, Any] = {}

    def _joint_obs(self) -> Frame:
        return outer_join(m.obs.add_prefix(f"{name}:") for name, m in self.mod.items())

    @property
    def X(self):
        return None

    @property
    def shape(self):
        return (len(self.obs), sum(m.n_vars for m in self.mod.values()))

    @property
    def n_obs(self) -> int:
        return self.shape[0]

    @property
    def obs_names(self) -> np.ndarray:
        return self.obs.index

    def _obs_rows(self, oi) -> np.ndarray:
        return np.asarray(self.mod[next(iter(self.mod))]._norm_idx(oi, 0))

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.mod[key]
        if not isinstance(key, tuple):
            key = (key, slice(None))
        oi, vi = key
        if not (isinstance(vi, slice) and vi == slice(None)):
            # global-var-axis slicing: route each selected column to its modality
            nv = [m.n_vars for m in self.mod.values()]
            total = sum(nv)
            if isinstance(vi, slice):
                gidx = np.arange(total)[vi]
            else:
                arr = np.asarray(vi)
                if arr.dtype == bool:
                    if len(arr) != total:
                        raise IndexError(f"boolean var mask length {len(arr)} != {total}")
                    gidx = np.flatnonzero(arr)
                elif arr.dtype.kind in "iu":
                    gidx = arr
                else:  # names over the concatenated global var index
                    gidx = index_positions(self.var.index, arr, missing_ok=True)
                    if (gidx < 0).any():
                        missing = np.asarray(arr)[gidx < 0][:5]
                        raise KeyError(f"var names not found: {list(missing)}")
            offsets = np.cumsum([0] + nv)
            mods = {}
            for (k, m), lo, hi in zip(self.mod.items(), offsets[:-1], offsets[1:]):
                local = gidx[(gidx >= lo) & (gidx < hi)] - lo
                mods[k] = m[oi, local]
            return MuData(mods, obs=self.obs.take(self._obs_rows(oi)),
                          uns=_copy.deepcopy(self.uns),
                          obsm={k: v[oi] for k, v in self.obsm.items()})
        return MuData({k: m[oi] for k, m in self.mod.items()},
                      obs=self.obs.take(self._obs_rows(oi)),
                      uns=_copy.deepcopy(self.uns),
                      obsm={k: v[oi] for k, v in self.obsm.items()})

    def copy(self) -> "MuData":
        return MuData({k: m.copy() for k, m in self.mod.items()}, obs=self.obs.copy(),
                      uns=_copy.deepcopy(self.uns),
                      obsm={k: _copy.deepcopy(v) for k, v in self.obsm.items()})

    def update(self):
        if len(self.obs):
            joint = self._joint_obs()
            joint.index = self.obs.index
            self.obs = joint

    def __repr__(self):
        mods = ", ".join(f"{k}: {m.n_obs}x{m.n_vars}" for k, m in self.mod.items())
        return f"MuData object with n_obs = {self.n_obs}; mod: {{{mods}}}"


__all__ = ["AlignedMapping", "AnnData", "Frame", "MuData", "Raw", "as_index", "concat",
           "index_intersection", "index_positions", "index_union", "outer_join"]
