"""The split-aware, channel-configured wrapper over AnnData/MuData
(counterpart: dance_tpu/data/base.py, ``BaseData`` :32, ``Data`` :357).

As in JAX: the integer split-index dict with train/val/test sizes, index
ranges or one full split; the channel config kept in
``.uns["dance_config"]``, with ``set_config``'s ``overwrite`` refusal
(:170-193); :meth:`BaseData.get_feature` over ``X``, ``raw_X`` and every
channel type, sliced by split (:202-270); ``get_x``/``get_y``/``get_data``
and the split getters through ``Data._get`` (:360), list-valued channels
included; ``append``, ``pop`` and ``filter_cells``.

Where this differs from the JAX package:

- ``return_type="torch"`` returns a tensor on ``device`` (default
  ``"auto"``, the CUDA card; it raises without one, and the CPU is used only
  when named): the counterpart of JAX's ``"jax"``, which lands on the
  accelerator. ``"jax"`` raises. ``get_split_mask`` takes the same
  ``device``.
- ``append(label_batch=True)`` writes ``obs["batch"]`` as integers; JAX
  writes a pandas categorical of the same integers.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import scipy.sparse as sp

from dance_tpu_torch.data.container import AnnData, MuData, concat
from dance_tpu_torch.settings import logger
from dance_tpu_torch.utils import resolve_device


def _no_jax(return_type):
    if return_type == "jax":
        raise ValueError("return_type='jax' is the JAX package's; the port returns "
                         "return_type='torch' tensors on the card")


class BaseData:

    _FEATURE_CONFIGS: List[str] = ["feature_mod", "feature_channel", "feature_channel_type"]
    _LABEL_CONFIGS: List[str] = ["label_mod", "label_channel", "label_channel_type"]
    _DATA_CHANNELS: List[str] = ["obs", "var", "obsm", "varm", "obsp", "varp", "layers", "uns"]

    def __init__(self, data: Union[AnnData, MuData], train_size: Optional[Union[int, str]] = None,
                 val_size: int = 0, test_size: int = -1,
                 split_index_range_dict: Optional[Dict[str, Tuple[int, int]]] = None,
                 full_split_name: Optional[str] = None):
        if not isinstance(data, (AnnData, MuData)):
            raise TypeError(f"Unknown data type {type(data)}, must be AnnData or MuData")
        self._data = data
        self._split_idx_dict: Dict[str, Sequence[int]] = {}
        self._setup_splits(train_size, val_size, test_size, split_index_range_dict,
                           full_split_name)
        if "dance_config" not in self._data.uns:
            self._data.uns["dance_config"] = {}

    # Mirror the container's channels so ``data.obsm`` etc. work directly.
    def __getattr__(self, name):
        if name in ("X", "mod", "raw") or name in BaseData._DATA_CHANNELS:
            return getattr(self._data, name)
        raise AttributeError(name)

    def __repr__(self):
        return f"{self.__class__.__name__} object that wraps (.data):\n{self._data}"

    # --- splits -----------------------------------------------------------

    def _setup_splits(self, train_size, val_size, test_size, split_index_range_dict,
                      full_split_name):
        if split_index_range_dict is not None and full_split_name is not None:
            raise ValueError("Specify only one of split_index_range_dict / full_split_name")
        if split_index_range_dict is not None:
            for name, (start, end) in split_index_range_dict.items():
                self._split_idx_dict[name] = list(range(start, end))
            return
        if full_split_name is not None:
            self._split_idx_dict[full_split_name] = list(range(self.shape[0]))
            return
        if train_size is None:
            return
        if isinstance(train_size, str) and train_size.lower() == "all":
            train_size, val_size, test_size = -1, 0, 0
        if any(not isinstance(i, (int, np.integer)) for i in (train_size, val_size, test_size)):
            raise TypeError("Split sizes must be int")
        n = self.shape[0]
        sizes = np.array([train_size, val_size, test_size], dtype=int)
        if (sizes == -1).sum() > 1:
            raise ValueError("At most one split size may be -1")
        if (sizes == -1).any():
            sizes[sizes == -1] = n - sizes[sizes != -1].sum()
        if sizes.sum() > n or (sizes < 0).any():
            raise ValueError(f"Split sizes {sizes.tolist()} invalid for {n} cells")
        offset = 0
        for name, size in zip(("train", "val", "test"), sizes.tolist()):
            if size > 0:
                self._split_idx_dict[name] = list(range(offset, offset + size))
            offset += size

    def set_split_idx(self, split_name: str, split_idx: Sequence[int]):
        self._split_idx_dict[split_name] = list(map(int, split_idx))

    def get_split_idx(self, split_name: Optional[str], error_on_miss: bool = False):
        if split_name is None:
            return list(range(self.shape[0]))
        if split_name in self._split_idx_dict:
            return self._split_idx_dict[split_name]
        if error_on_miss:
            raise KeyError(f"Unknown split {split_name!r}; set it via set_split_idx first. "
                           f"Available: {sorted(self._split_idx_dict)}")
        return None

    def get_split_mask(self, split_name: str, return_type: str = "numpy", device="auto"):
        _no_jax(return_type)
        if return_type not in ("numpy", "torch"):
            raise ValueError(f"Unsupported return_type {return_type!r}")
        dev = resolve_device(device) if return_type == "torch" else None
        idx = self.get_split_idx(split_name, error_on_miss=True)
        mask = np.zeros(self.shape[0], dtype=bool)
        mask[idx] = True
        if return_type == "numpy":
            return mask
        import torch
        return torch.from_numpy(mask).to(dev)

    def get_split_data(self, split_name: str):
        return self.data[self.get_split_idx(split_name, error_on_miss=True)]

    @property
    def splits(self) -> Dict[str, Sequence[int]]:
        return self._split_idx_dict

    @property
    def train_idx(self):
        return self.get_split_idx("train", error_on_miss=False)

    @property
    def val_idx(self):
        return self.get_split_idx("val", error_on_miss=False)

    @property
    def test_idx(self):
        return self.get_split_idx("test", error_on_miss=False)

    # --- basic properties -------------------------------------------------

    @property
    def data(self):
        return self._data

    @property
    def shape(self) -> Tuple[int, int]:
        return self._data.shape

    @property
    def num_cells(self) -> int:
        return self.shape[0]

    @property
    def num_features(self) -> int:
        return self.shape[1]

    @property
    def cells(self) -> List[str]:
        return list(self._data.obs.index)

    def copy(self):
        return deepcopy(self)

    # --- config -----------------------------------------------------------

    @property
    def config(self) -> Dict[str, Any]:
        return self._data.uns["dance_config"]

    def set_config(self, *, overwrite: bool = False, **kwargs):
        self.set_config_from_dict(kwargs, overwrite=overwrite)

    def set_config_from_dict(self, config_dict: Dict[str, Any], *, overwrite: bool = False):
        all_configs = set(self._FEATURE_CONFIGS + self._LABEL_CONFIGS)
        if unknown := set(config_dict) - all_configs:
            raise KeyError(f"Unknown config option(s): {unknown}, available: {all_configs}")

        # feature/label triplets must agree in type and length
        for group in (self._FEATURE_CONFIGS, self._LABEL_CONFIGS):
            vals = [v for k, v in config_dict.items() if k in group and v is not None]
            types = {type(v) for v in vals}
            if len(types) > 1:
                raise TypeError(f"Inconsistent config types: {types}")
            if types == {list} and len({len(v) for v in vals}) > 1:
                raise ValueError(f"Inconsistent config lengths in {vals}")

        for key, val in config_dict.items():
            if key not in self.config:
                self.config[key] = val
                logger.info("Setting config %r to %r", key, val)
            elif (old := self.config[key]) != val:
                if overwrite:
                    self.config[key] = val
                    logger.warning("Overwriting config %r to %r (was %r)", key, val, old)
                else:
                    raise KeyError(f"Config {key!r} set to {old!r}, refusing to change to "
                                   f"{val!r} without overwrite=True")

    # --- feature access ---------------------------------------------------

    @staticmethod
    def _get_feature(in_data, channel, channel_type, mod):
        if mod is None:
            data = in_data
        elif not isinstance(in_data, MuData):
            raise AttributeError("`mod` option requires multimodality data")
        elif mod not in in_data.mod:
            raise KeyError(f"Unknown modality {mod!r}, options: {sorted(in_data.mod)}")
        else:
            data = in_data.mod[mod]

        if channel_type == "X":
            return data.X
        if channel_type == "raw_X":
            return data.raw.X
        channel_type = channel_type or "obsm"
        if channel_type not in BaseData._DATA_CHANNELS:
            raise ValueError(f"Unknown channel type {channel_type!r}, "
                             f"options: {BaseData._DATA_CHANNELS}")
        if channel is None:
            return data.X
        return getattr(data, channel_type)[channel]

    def get_feature(self, *, split_name: Optional[str] = None, return_type: str = "numpy",
                    channel: Optional[str] = None, channel_type: Optional[str] = "obsm",
                    mod: Optional[str] = None, device="auto"):
        """The ``channel`` of ``channel_type`` (of modality ``mod``), the rows
        of ``split_name`` where the channel is per cell. ``return_type``:
        ``"default"`` as stored, ``"numpy"`` dense, ``"sparse"`` CSR,
        ``"torch"`` a tensor on ``device`` (the card unless the CPU is
        named)."""
        _no_jax(return_type)
        dev = resolve_device(device) if return_type == "torch" else None
        feature = self._get_feature(self.data, channel, channel_type, mod)
        channel_type = channel_type or "obsm"

        if return_type == "default":
            if split_name is not None:
                raise ValueError("split_name unsupported with return_type='default'")
            return feature

        if return_type == "sparse":
            # an obs/var column is a pandas Series in JAX, which it refuses here
            if isinstance(feature, np.ndarray) and channel_type not in ("obs", "var"):
                feature = sp.csr_matrix(feature)
            elif not sp.issparse(feature):
                raise ValueError(f"Feature is not sparse, got {type(feature)}")
        elif sp.issparse(feature):
            feature = feature.toarray()
        elif hasattr(feature, "to_numpy"):
            feature = feature.to_numpy()

        if split_name is not None:
            if channel_type in ("X", "raw_X", "obs", "obsm", "obsp", "layers"):
                idx = [i for i in self.get_split_idx(split_name, error_on_miss=True)
                       if i < feature.shape[0]]
                feature = feature[idx][:, idx] if channel_type == "obsp" else feature[idx]
            else:
                logger.warning("Split indexing for %r not implemented; returning full",
                               channel_type)

        if return_type == "torch" and np.asarray(feature).dtype.kind in "OUS":
            raise TypeError(
                f"Channel {channel!r} holds non-numeric data "
                f"(dtype={np.asarray(feature).dtype}); encode labels numerically "
                f"(e.g. one-hot obsm) before requesting return_type={return_type!r}")
        if return_type == "torch":
            import torch
            return torch.from_numpy(np.ascontiguousarray(feature)).to(dev)
        if return_type in ("numpy", "sparse"):
            return feature
        raise ValueError(f"Unknown return_type {return_type!r}")

    # --- append / pop / filter -------------------------------------------

    def append(self, data: "BaseData", *, mode: Optional[str] = "merge",
               rename_dict: Optional[Dict[str, str]] = None,
               new_split_name: Optional[str] = None, label_batch: bool = False,
               join: str = "inner", **concat_kwargs):
        """Concatenate ``data``'s cells after these (counterpart: base.py:273).
        ``mode``: ``"merge"`` splits of the same name, ``"rename"`` the
        appended splits by ``rename_dict``, put all appended cells in
        ``"new_split"``, or (None) keep only these splits."""
        offset = self.shape[0]
        new_splits = {k: sorted(np.asarray(v) + offset)
                      for k, v in data._split_idx_dict.items()}

        if mode == "merge":
            for name, idxs in self._split_idx_dict.items():
                new_splits[name] = list(idxs) + list(new_splits.get(name, []))
            merged = new_splits
        elif mode == "rename":
            if rename_dict is None:
                raise ValueError("Mode 'rename' requires rename_dict")
            if common := set(self._split_idx_dict) & set(rename_dict.values()):
                raise ValueError(f"rename_dict targets collide with existing splits: {common}")
            if missed := [k for k in data._split_idx_dict if k not in rename_dict]:
                raise KeyError(f"Missing rename mapping for: {missed}")
            merged = {rename_dict[k]: v for k, v in new_splits.items()}
            merged.update(self._split_idx_dict)
        elif mode == "new_split":
            if not isinstance(new_split_name, str):
                raise ValueError("Mode 'new_split' requires a string new_split_name")
            if new_split_name in self._split_idx_dict:
                raise ValueError(f"Split {new_split_name!r} already in use")
            merged = {new_split_name: list(range(offset, offset + data.shape[0]))}
            merged.update(self._split_idx_dict)
        elif mode is None:
            merged = self._split_idx_dict
        else:
            raise ValueError(f"Unknown mode {mode!r}")

        new_uns = dict(data.data.uns)
        new_uns.update(dict(self.data.uns))

        batch = None
        if label_batch:
            old = (self.data.obs["batch"].tolist() if "batch" in self.data.obs.columns
                   else [0] * self.shape[0])
            batch = list(map(int, old + [max(old) + 1] * data.shape[0]))

        self._data = concat((self.data, data.data), join=join, **concat_kwargs)
        self._data.uns.update(new_uns)
        self._split_idx_dict = merged
        if batch is not None:
            self._data.obs["batch"] = np.asarray(batch)
        return self

    def pop(self, *, split_name: str):
        """Remove the cells of a split from the data (and drop the split)."""
        pop_idx = set(self.get_split_idx(split_name, error_on_miss=True))
        keep = np.array([i for i in range(self.shape[0]) if i not in pop_idx], dtype=np.int64)
        self._subset_cells(keep)
        self._split_idx_dict.pop(split_name, None)
        return self

    def _subset_cells(self, keep_idx: np.ndarray):
        """Subset to ``keep_idx`` cells and re-index all splits accordingly."""
        keep_idx = np.asarray(keep_idx, dtype=np.int64)
        remap = -np.ones(self.shape[0], dtype=int)
        remap[keep_idx] = np.arange(len(keep_idx))
        self._data = self.data[keep_idx]
        new_splits = {}
        for name, idxs in self._split_idx_dict.items():
            mapped = remap[np.asarray(idxs, dtype=int)]
            new_splits[name] = sorted(int(i) for i in mapped[mapped >= 0])
        self._split_idx_dict = new_splits

    def filter_cells(self, mask: np.ndarray):
        """Keep cells where ``mask`` is True, re-indexing splits
        (counterpart: base.py:344)."""
        mask = np.asarray(mask, dtype=bool)
        if mask.shape[0] != self.shape[0]:
            raise ValueError(f"Mask length {mask.shape[0]} != num cells {self.shape[0]}")
        self._subset_cells(np.nonzero(mask)[0])
        return self

    # the reference's name for the same operation
    filter_by_mask = filter_cells


class Data(BaseData):
    """Concrete data object driving ``get_x/get_y`` from the channel config."""

    def _get(self, kind: str, split_name: Optional[str], return_type: str, **kwargs):
        mods = self.config.get(f"{kind}_mod")
        channels = self.config.get(f"{kind}_channel")
        ctypes = self.config.get(f"{kind}_channel_type")
        if not isinstance(channels, list):
            mods, channels, ctypes = [mods], [channels], [ctypes]
        elif not isinstance(ctypes, list):
            ctypes = [ctypes] * len(channels)
        if mods is None or not isinstance(mods, list):
            mods = [mods] * len(channels)
        # channel_type=None resolves to "obsm" (or X when channel is also None)
        out = [self.get_feature(split_name=split_name, return_type=return_type, channel=c,
                                channel_type=ct, mod=m, **kwargs)
               for m, c, ct in zip(mods, channels, ctypes)]
        return out[0] if len(out) == 1 else out

    def get_x(self, split_name: Optional[str] = None, return_type: str = "numpy", **kw):
        return self._get("feature", split_name, return_type, **kw)

    def get_y(self, split_name: Optional[str] = None, return_type: str = "numpy", **kw):
        return self._get("label", split_name, return_type, **kw)

    def get_data(self, split_name: Optional[str] = None, return_type: str = "numpy", **kw):
        return self.get_x(split_name, return_type, **kw), self.get_y(split_name, return_type, **kw)

    def get_train_data(self, return_type: str = "numpy", **kw):
        return self.get_data("train", return_type, **kw)

    def get_val_data(self, return_type: str = "numpy", **kw):
        return self.get_data("val", return_type, **kw)

    def get_test_data(self, return_type: str = "numpy", **kw):
        return self.get_data("test", return_type, **kw)

    @property
    def x(self):
        return self.get_x()

    @property
    def y(self):
        return self.get_y()


__all__ = ["BaseData", "Data"]
