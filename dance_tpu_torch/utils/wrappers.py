"""Function and class wrappers (counterpart: dance_tpu/utils/wrappers.py):
``TimeIt``, ``as_1d_array``, ``CastOutputType`` and
``add_mod_and_transform``. ``as_numpy`` is in :mod:`dance_tpu_torch.utils`.
"""

import functools
import time

import numpy as np

from dance_tpu_torch.settings import logger


def as_1d_array(func):
    """Decorator flattening the output into a 1-d numpy array."""

    @functools.wraps(func)
    def wrapped(*args, **kwargs):
        return np.asarray(func(*args, **kwargs)).ravel()

    return wrapped


def add_mod_and_transform(cls):
    """Class decorator giving a container transform a ``mod`` option: with
    ``mod`` set, the transform runs on that modality of a ``MuData`` as a
    ``Data`` of its own, and the result is written back (counterpart:
    wrappers.py:84). The tuning configs of the joint-embedding and BABEL
    models set it on their normalize step."""
    orig_init = cls.__init__
    orig_call = cls.__call__

    @functools.wraps(orig_init)
    def __init__(self, *args, mod=None, **kwargs):
        self.mod = mod
        orig_init(self, *args, **kwargs)

    @functools.wraps(orig_call)
    def __call__(self, data, *args, **kwargs):
        from dance_tpu_torch.data.base import BaseData

        if self.mod is None or not isinstance(data, BaseData):
            return orig_call(self, data, *args, **kwargs)
        from dance_tpu_torch.data import Data

        sub = Data(data.data.mod[self.mod])
        out = orig_call(self, sub, *args, **kwargs)
        data.data.mod[self.mod] = sub.data
        return data if out is not None else None

    cls.__init__ = __init__
    cls.__call__ = __call__
    return cls


class CastOutputType:
    """Decorator casting the function output with ``target_type``."""

    def __init__(self, target_type):
        self.target_type = target_type

    def __call__(self, func):
        @functools.wraps(func)
        def wrapped(*args, **kwargs):
            return self.target_type(func(*args, **kwargs))

        return wrapped


class TimeIt:
    """Decorator logging the wall-clock time of the call."""

    def __init__(self, name: str = None):
        self.name = name

    def __call__(self, func):
        name = self.name or func.__name__

        @functools.wraps(func)
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = func(*args, **kwargs)
            logger.info("Took %.2f seconds to %s", time.perf_counter() - t0, name)
            return out

        return wrapped


__all__ = ["CastOutputType", "TimeIt", "add_mod_and_transform", "as_1d_array"]
