"""Hierarchical dot-key registry for pipeline search (counterpart:
dance_tpu/registry.py).

``DotDict`` compositional get/set, ``Registry.children`` enumeration, the
``register(*scope)`` decorator and ``resolve_from_registry`` with the
``_registry_`` prefix, as in JAX. The port keeps its own :data:`REGISTRY`:
a process that imports both packages (the parity tests) holds two
registries, so a port class never collides with its JAX counterpart under
the same key. Keys keep JAX's scope paths (``preprocessor.feature.cell.
WeightedFeaturePCA``), so a pipeline config resolves in either package.
"""

from functools import partial
from typing import Any, Dict, Iterator, Optional, Tuple

from dance_tpu_torch.settings import logger

REGISTRY_PREFIX = "_registry_"


def _split(key: str) -> Tuple[str, ...]:
    """Dotted key -> path segments; the empty key addresses the root."""
    return tuple(key.split(".")) if key else ()


class DotDict(dict):
    """Dict with dot-compositional key access: ``d.get("a.b") == d["a"]["b"]``.

    Attribute access mirrors item access (``d.a.b``), and nested plain dicts
    are promoted to DotDicts on construction so every interior node supports
    the same protocol.
    """

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        super().__init__()
        for key, val in (data or {}).items():
            if "." in key:
                raise ValueError(f"DotDict keys may not contain '.': {key!r}")
            self[key] = DotDict(val) if hasattr(val, "keys") else val

    def __getattr__(self, name: str):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any):
        self[name] = value

    def __delattr__(self, name: str):
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None

    def _descend(self, path: Tuple[str, ...]):
        """Follow ``path`` from self; raises LookupError at the first miss."""
        node = self
        for segment in path:
            if not isinstance(node, dict) or segment not in node:
                raise LookupError(segment)
            node = node[segment]
        return node

    def get(self, key: str, default: Any = None, missed_ok: bool = True,
            create_on_miss: bool = False):
        """Fetch by dotted key; ``""`` addresses the root.

        ``missed_ok`` returns ``default`` on a miss instead of raising;
        ``create_on_miss`` (requires ``missed_ok``) materializes and returns
        an empty subtree at the queried path.
        """
        if create_on_miss and not missed_ok:
            raise ValueError("create_on_miss requires missed_ok")
        try:
            return self._descend(_split(key))
        except LookupError as miss:
            if create_on_miss:
                node = DotDict()
                self.set(key, node)
                return node
            if missed_ok:
                return default
            raise KeyError(f"Failed to resolve key {key!r}") from miss

    def set(self, key: str, val: Any, exist_ok: bool = True):
        """Write by dotted key, materializing interior nodes as needed."""
        if not exist_ok and self.get(key) is not None:
            raise KeyError(f"Key exists: {key}")
        *interior, leaf = _split(key)
        node = self
        for depth, segment in enumerate(interior):
            nxt = node.setdefault(segment, DotDict())
            if not isinstance(nxt, DotDict):
                raise KeyError(f"Level {depth} ({segment!r}) is a leaf node: {nxt}")
            node = nxt
        node[leaf] = val


class Registry(DotDict):

    def is_leaf_node(self, key: str) -> bool:
        return not isinstance(self.get(key), DotDict)

    def children(self, key: str = "", leaf_node: bool = True, non_leaf_node: bool = True,
                 return_val: bool = False) -> Iterator[Any]:
        """Depth-first iteration over descendant keys (dotted, from root).

        Implemented with an explicit stack; yields pre-order, so a scope name
        appears before its members when ``non_leaf_node`` is on.
        """
        if not leaf_node and not non_leaf_node:
            raise ValueError("At least one of leaf_node / non_leaf_node must be True")
        root = self.get(key, missed_ok=False)
        if not isinstance(root, DotDict):
            raise KeyError(f"{key} is a leaf node; children requires a non-leaf node")
        stack = [(key, name, root[name]) for name in reversed(list(root))]
        while stack:
            prefix, name, node = stack.pop()
            full = f"{prefix}.{name}" if prefix else name
            if isinstance(node, DotDict):
                if non_leaf_node:
                    yield (full, node) if return_val else full
                stack.extend((full, child, node[child])
                             for child in reversed(list(node)))
            elif leaf_node:
                yield (full, node) if return_val else full


REGISTRY = Registry()


def resolve_from_registry(name: str, scope: str, registry: Registry = None):
    """Look up ``<scope>.<name>``; scope may carry the ``_registry_`` prefix."""
    registry = REGISTRY if registry is None else registry
    scope = scope.replace(REGISTRY_PREFIX, "", 1).lstrip(".")
    key = ".".join(filter(None, (scope, name)))
    logger.debug("Resolving from registry: %s", key)
    return registry.get(key, missed_ok=False)


def register(*scope: Tuple[str], name: Optional[str] = None, overwrite: bool = False,
             _registry: Registry = REGISTRY):
    """Decorator registering an object under ``<scope...>.<name or obj.__name__>``."""

    def deco(obj):
        obj_name = name if name is not None else obj.__name__
        key = ".".join((*scope, obj_name))
        try:
            _registry.set(key, obj, exist_ok=overwrite)
        except KeyError as e:
            existing = _registry.get(key)
            if existing != obj:
                raise KeyError(f"{obj_name!r} already registered under {scope}: "
                               f"{existing} != {obj}") from e
        return obj

    return deco


register_dataset = partial(register, "dataset")
register_preprocessor = partial(register, "preprocessor")
register_genestats_func = partial(register, "function", "genestats")
register_metric_func = partial(register, "function", "metric")

REGISTERED_DATASETS = REGISTRY.get("dataset", create_on_miss=True)
REGISTERED_PREPROCESSORS = REGISTRY.get("preprocessor", create_on_miss=True)
REGISTERED_GENESTATS_FUNCS = REGISTRY.get("function.genestats", create_on_miss=True)
REGISTERED_METRIC_FUNCS = REGISTRY.get("function.metric", create_on_miss=True)

__all__ = [
    "DotDict", "REGISTRY", "REGISTRY_PREFIX", "Registry", "register", "register_dataset",
    "register_genestats_func", "register_metric_func", "register_preprocessor",
    "resolve_from_registry",
]
