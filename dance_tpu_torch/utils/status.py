"""Lifecycle decorators (counterpart: dance_tpu/utils/status.py)."""

import functools
import warnings


def deprecated(func=None, *, msg: str = ""):
    if func is None:
        return lambda f: deprecated(f, msg=msg)

    @functools.wraps(func)
    def wrapped(*args, **kwargs):
        warnings.warn(f"{func.__name__} is deprecated. {msg}".strip(),
                      DeprecationWarning, stacklevel=2)
        return func(*args, **kwargs)

    return wrapped


def experimental(func=None, *, msg: str = ""):
    if func is None:
        return lambda f: experimental(f, msg=msg)

    @functools.wraps(func)
    def wrapped(*args, **kwargs):
        warnings.warn(f"{func.__name__} is experimental and may change. {msg}".strip(),
                      UserWarning, stacklevel=2)
        return func(*args, **kwargs)

    return wrapped


__all__ = ["deprecated", "experimental"]
