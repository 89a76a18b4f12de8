"""Dataset base: the local raw files and the processed-data pickle cache
(counterpart: dance_tpu/datasets/base.py).

The cache is keyed as JAX keys it, by ``md5(dataset.hexdigest() +
transform.hexdigest())`` (base.py:85-94), so the same dataset and
``Compose`` give the same key in both packages. The port keeps its own
directory, ``<root>/cache_torch/``: a pickle written by the JAX package
holds its classes, and loading it would import that package.

Where this differs from the JAX package: the port does not download.
``download`` raises ``FileNotFoundError`` naming the file to pre-stage, and
``download_all`` ``NotImplementedError``.
"""

import os
import os.path as osp
import pathlib
import pickle
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Tuple, Union

from dance_tpu_torch.settings import logger
from dance_tpu_torch.transforms.base import BaseTransform
from dance_tpu_torch.utils import hexdigest
from dance_tpu_torch.utils.wrappers import TimeIt

CACHE_DIR = "cache_torch"


class BaseDataset(ABC):
    """A dataset under ``root``: its raw files, their ``Data`` and the cache
    of the processed ``Data`` (counterpart: base.py:21)."""

    _DISPLAY_ATTRS: Tuple[str, ...] = ()

    def __init__(self, root: str, full_download: bool = False):
        self.root = pathlib.Path(root).resolve()
        self.full_download = full_download

    def hexdigest(self) -> str:
        """MD5 over the string-valued attributes, in the order they were set
        (the cache identity, as in JAX)."""
        parts = {i: j for i, j in self.__dict__.items() if isinstance(j, str)}
        return hexdigest(str(parts))

    def __repr__(self):
        attrs = ", ".join(f"{i}={getattr(self, i)!r}" for i in self._DISPLAY_ATTRS)
        return f"{self.__class__.__name__}({attrs})"

    def download_all(self):
        raise NotImplementedError("The port does not download; pre-stage the files")

    def is_complete_all(self) -> bool:
        raise NotImplementedError

    @abstractmethod
    def download(self):
        ...

    @abstractmethod
    def is_complete(self) -> bool:
        ...

    @abstractmethod
    def _load_raw_data(self) -> Any:
        ...

    @abstractmethod
    def _raw_to_dance(self, raw_data: Any, /):
        ...

    def load_raw_data(self) -> Any:
        self._maybe_download()
        return self._load_raw_data()

    @TimeIt("load and process data")
    def load_data(self, transform: Optional[BaseTransform] = None, cache: bool = False,
                  redo_cache: bool = False):
        """The dataset's ``Data``, processed by ``transform``. With ``cache``,
        a processed ``Data`` is read from the cache when there (unless
        ``redo_cache``) and written there when made."""
        cache_load = self._maybe_load_cache(transform, cache, redo_cache)
        if not isinstance(cache_load, str):
            return cache_load

        data = self._raw_to_dance(self.load_raw_data())
        logger.info("Raw data loaded:\n%r", data)
        if transform is not None:
            if not isinstance(transform, BaseTransform):
                raise TypeError(
                    f"transform must inherit BaseTransform, got {type(transform)}. "
                    "Wrap plain AnnData functions with AnnDataTransform.")
            transform(data)
        if cache:
            with open(cache_load, "wb") as f:
                pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)
            logger.info("Saved processed data to cache: %s", cache_load)
        return data

    def cache_path(self, transform: Optional[BaseTransform] = None) -> str:
        """``<root>/cache_torch/<md5(dataset digest + transform digest)>.pkl``."""
        transform_hash = "" if transform is None else transform.hexdigest()
        return osp.join(self.root, CACHE_DIR,
                        f"{hexdigest(self.hexdigest() + transform_hash)}.pkl")

    def _maybe_load_cache(self, transform, cache, redo_cache):
        path = self.cache_path(transform)
        os.makedirs(osp.dirname(path), exist_ok=True)
        if cache and not redo_cache and osp.isfile(path):
            logger.info("Loading cached data at %s", path)
            with open(path, "rb") as f:
                return pickle.load(f)
        return path

    def _maybe_download(self):
        if self.full_download and not self.is_complete_all():
            self.download_all()
        elif not self.is_complete():
            self.download()

    @classmethod
    def get_available_data(cls) -> List[Union[str, Dict[str, str]]]:
        if hasattr(cls, "AVAILABLE_DATA"):
            return cls.AVAILABLE_DATA
        raise NotImplementedError(f"{cls.__name__} does not specify AVAILABLE_DATA")


__all__ = ["BaseDataset", "CACHE_DIR"]
