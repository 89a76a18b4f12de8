"""The port's exceptions (counterpart: dance_tpu/exceptions.py)."""


class DevError(Exception):
    """Internal invariant violation: a fault of the framework, not of its user."""


__all__ = ["DevError"]
