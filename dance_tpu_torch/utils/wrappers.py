"""Function and class wrappers (counterpart: dance_tpu/utils/wrappers.py):
``TimeIt``, ``as_1d_array`` and ``CastOutputType``. ``as_numpy`` is in
:mod:`dance_tpu_torch.utils`. JAX's ``add_mod_and_transform`` (a ``mod``
option that runs a transform on one modality of a MuData) has no port yet:
no ported pipeline sets ``mod``.
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


__all__ = ["CastOutputType", "TimeIt", "as_1d_array"]
