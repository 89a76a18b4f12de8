"""The transform contract (counterpart: dance_tpu/transforms/base.py).

Every preprocessing step on the container is a named callable over a
``Data`` object with an ``out`` channel, a child logger and an md5 hex
digest of its repr, which keys a preprocessed-data cache. The digest of a
port transform equals its JAX counterpart's where both print the same
attributes (``_DISPLAY_ATTRS``).
"""

import hashlib
import warnings
from abc import ABC, abstractmethod
from typing import Optional, Tuple

from dance_tpu_torch.settings import logger


class BaseTransform(ABC):

    _DISPLAY_ATTRS: Tuple[str, ...] = ()

    def __init__(self, out: Optional[str] = None, log_level: str = "WARNING"):
        self.out = out or self.name
        self.logger = logger.getChild(self.name)
        self.logger.setLevel(log_level)
        self.log_level = log_level

    @property
    def name(self) -> str:
        return self.__class__.__name__

    def hexdigest(self) -> str:
        return hashlib.md5(repr(self).encode()).hexdigest()

    def __repr__(self) -> str:
        attrs = ", ".join(f"{i}={getattr(self, i)!r}" for i in self._DISPLAY_ATTRS)
        return f"{self.name}({attrs})"

    @abstractmethod
    def __call__(self, data):
        raise NotImplementedError


class AnnDataAdaptor:
    """Apply a transform directly to an AnnData, through a ``Data`` made for
    the call (counterpart: base.py:42)."""

    def __init__(self, transform, **data_init_kwargs):
        warnings.warn("AnnDataAdaptor is a compatibility patch; use Data objects directly.",
                      UserWarning, stacklevel=2)
        self.transform = transform
        self.data_init_kwargs = data_init_kwargs

    def __call__(self, adata):
        from dance_tpu_torch.data import Data
        data = Data(adata, **self.data_init_kwargs)
        self.transform(data)
        return data.data


__all__ = ["AnnDataAdaptor", "BaseTransform"]
