"""Config object: a nested, attribute-accessible mapping with JSON IO
(counterpart: dance_tpu/config.py).

``Config`` with ``to_dict``, ``to_json``, ``dump_json``, ``from_file`` for
``.json``, ``merge`` and ``copy``, as in JAX. PyYAML is not on the machine
with the card: ``to_yaml``, ``dump_yaml`` and ``from_file`` of a ``.yml``
or ``.yaml`` file raise ``NotImplementedError`` naming it (ROADMAP Queue 3).
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Any, Dict, Optional


def _check_exist(path, exist_handle: str):
    if os.path.exists(path):
        msg = f"File exists: {path}"
        if exist_handle == "error":
            raise FileExistsError(msg)
        if exist_handle == "warn":
            warnings.warn(msg, UserWarning, stacklevel=3)


def _no_yaml(what: str):
    raise NotImplementedError(f"{what} needs PyYAML, which the port does not use (the card's "
                              f"machine has no yaml); use JSON")


class Config(dict):
    """Nested config with attribute access, deep-copy semantics, and file IO."""

    def __init__(self, data: Optional[Dict[str, Any]] = None, **kwargs):
        super().__init__()
        data = dict(data or {})
        data.update(kwargs)
        for key, val in data.items():
            self[key] = val

    def __setitem__(self, key, val):
        if isinstance(val, dict) and not isinstance(val, Config):
            val = Config(val)
        elif isinstance(val, (list, tuple)):
            val = [Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v
                   for v in val]
        super().__setitem__(key, val)

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key, val):
        self[key] = val

    def __delattr__(self, key):
        del self[key]

    # --- conversions -----------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        def conv(v):
            if isinstance(v, Config):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, list):
                return [conv(x) for x in v]
            return v

        return conv(self)

    def to_yaml(self) -> str:
        _no_yaml("Config.to_yaml")

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    def copy(self) -> "Config":
        return Config(self.to_dict())

    # --- file IO ---------------------------------------------------------

    def dump_json(self, path, exist_handle: str = "warn"):
        _check_exist(path, exist_handle)
        with open(path, "w") as f:
            f.write(self.to_json())

    def dump_yaml(self, path, exist_handle: str = "warn"):
        _no_yaml("Config.dump_yaml")

    @classmethod
    def from_file(cls, path) -> "Config":
        path = str(path)
        if path.endswith((".yml", ".yaml")):
            _no_yaml(f"Config.from_file({path!r})")
        if not path.endswith(".json"):
            raise ValueError(f"Unknown config file type: {path}")
        with open(path) as f:
            data = json.load(f)
        return cls(data or {})

    # --- merge -----------------------------------------------------------

    def merge(self, other: Dict[str, Any]) -> "Config":
        """Recursively merge ``other`` into a copy of self (other wins)."""
        out = self.copy()
        for key, val in other.items():
            if key in out and isinstance(out[key], Config) and isinstance(val, dict):
                out[key] = out[key].merge(val)
            else:
                out[key] = val
        return out


def default_parser_processor(fn=None):
    """Decorator-compatible passthrough, kept for the API."""
    return fn


__all__ = ["Config", "default_parser_processor"]
