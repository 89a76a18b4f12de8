"""The DANCE 2.0 preprocessing search without pandas, PyYAML or wandb
(counterpart: dance_tpu/pipeline.py).

``Action`` (:57), ``Pipeline`` (:151), ``PipelinePlaner`` (:244) with the
tune modes ``pipeline``, ``params`` and ``pipeline_params``, ``include``/
``exclude``/``skippable`` candidates, ``default_params`` and
``params_to_tune``; ``SweepRunner`` (:566) with grid, random and
log-uniform sampling from ``random.Random(seed)`` (the trial order is
JAX's), ``run`` (:647), ``run_vmapped`` (:662) on
:func:`~dance_tpu_torch.parallel.trials.vmapped_trials` and ``best``; the
step-3 protocol ``get_step3_yaml`` (:776) and ``run_step3`` (:855), and the
subset ablations (:882-937). Every target resolves in the port's own
registry under JAX's key.

Where this differs from the JAX package:

- Configs are dicts or ``.json`` files; a ``.yml``/``.yaml`` path raises
  ``NotImplementedError`` naming PyYAML (:mod:`dance_tpu_torch.config`).
  ``get_step3_yaml`` and ``generate_subsets`` keep JAX's names and write
  JSON files (``<rank>_params_tuning_config.json``, ``subset_<i>.json``)
  with the content JAX writes as YAML; ``run_step3`` reads them back.
- The summary CSV is written and read with the ``csv`` module: JAX's
  columns (the union of the records' keys in order of first appearance)
  and row order, an empty cell where JAX writes NaN. A loaded cell is an
  int, a float, a bool or a string as it parses, ``None`` when empty.
  ``summary()`` returns a :class:`~dance_tpu_torch.data.Frame`.
- A resumed sweep skips the recorded configs by their parsed values
  (``1000 == 1000.0``, ``None`` matches an empty cell). JAX compares
  ``str(value)``, and pandas reads a column of ``[1000, None]`` back as
  ``1000.0, nan``: its resumed grid over ``target_sum: [1000, 10000,
  null]`` runs every finished trial again.
- ``best`` passes over records whose metric is missing or empty (JAX's
  loaded NaN).
- The wandb entry points (``wandb_sweep``, ``wandb_sweep_agent``,
  ``save_summary_data`` without a runner, ``get_additional_sweep``) raise
  ``NotImplementedError`` naming wandb.
"""

import csv
import importlib
import inspect
import itertools
import math
import os
import random as _random
import time
from copy import deepcopy
from pprint import pformat
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from dance_tpu_torch.config import Config
from dance_tpu_torch.data.container import Frame
from dance_tpu_torch.exceptions import DevError
from dance_tpu_torch.registry import REGISTRY, REGISTRY_PREFIX, Registry, resolve_from_registry
from dance_tpu_torch.settings import logger


def _no_wandb(what: str):
    raise NotImplementedError(f"{what} needs wandb, which the port does not use; run the "
                              f"local sweep (PipelinePlaner.sweep_agent)")


def _qualify_scope(scope: Optional[str], full_type: Optional[str]) -> str:
    """The lookup scope of an action (counterpart: pipeline.py:34): a bare
    ``_registry_`` scope, or none, is the registry under the action's full
    dotted type; any other value is taken as it is."""
    if scope is None or scope == REGISTRY_PREFIX:
        return ".".join(filter(None, (REGISTRY_PREFIX, full_type)))
    return scope


def _lookup_callable(target: str, scope: str, type_: Optional[str], registry: Registry):
    """``target`` in the registry (a ``_registry_`` scope) or as a module
    attribute (counterpart: pipeline.py:46). A module of the JAX package is
    refused: the port does not import it."""
    if scope.startswith(REGISTRY_PREFIX):
        if scope == REGISTRY_PREFIX and type_ is not None:
            scope = f"{scope}.{type_}"
        return resolve_from_registry(target, scope, registry=registry)
    if scope == "dance_tpu" or scope.startswith("dance_tpu."):
        raise KeyError(f"scope {scope!r} names the JAX package, which the port does not "
                       f"import; use the registry")
    return getattr(importlib.import_module(scope), target)


class Action:
    """One pipeline step: a typed, named reference to a registered callable
    (counterpart: pipeline.py:57). The config keys are ``type``, ``desc``,
    ``target``, ``scope`` and ``params``; the target ``_skip_`` skips it."""

    TYPE_KEY = "type"
    DESC_KEY = "desc"
    TARGET_KEY = "target"
    SCOPE_KEY = "scope"
    PARAMS_KEY = "params"
    SKIP_FLAG = "_skip_"

    def __init__(self, *, type_: Optional[str] = None, desc: Optional[str] = None,
                 target: Optional[str] = None, scope: Optional[str] = None,
                 params: Optional[Dict[str, Any]] = None,
                 _parent_type: Optional[str] = None, _registry: Registry = None):
        object.__setattr__(self, "_spec", {
            self.TYPE_KEY: type_,
            self.DESC_KEY: desc,
            self.TARGET_KEY: target,
            self.PARAMS_KEY: dict(params or {}),
        })
        self._parent_type = _parent_type
        self._registry = REGISTRY if _registry is None else _registry
        self.scope = scope

    type = property(lambda self: self._spec[self.TYPE_KEY])
    desc = property(lambda self: self._spec[self.DESC_KEY])
    target = property(lambda self: self._spec[self.TARGET_KEY])
    params = property(lambda self: self._spec[self.PARAMS_KEY])

    @property
    def parent_type(self):
        return self._parent_type

    @property
    def full_type(self):
        parts = [p for p in (self.parent_type, self.type) if p]
        return ".".join(parts) if parts else None

    @property
    def scope(self) -> str:
        return self._spec[self.SCOPE_KEY]

    @scope.setter
    def scope(self, val: Optional[str]):
        self._spec[self.SCOPE_KEY] = _qualify_scope(val, self.full_type)

    @property
    def skip(self) -> bool:
        return self.target == self.SKIP_FLAG

    @property
    def functional(self) -> Callable:
        cls = _lookup_callable(self.target, self.scope, self.type, self._registry)
        return cls(**self.params)

    def __call__(self, *args, **kwargs):
        return self.functional(*args, **kwargs)

    def __repr__(self):
        return f"{self.__class__.__name__}({self.target or ''})"

    def copy(self):
        return deepcopy(self)

    @classmethod
    def from_config(cls, cfg, **kwargs):
        fields = {key: cfg.get(getattr(cls, f"{key.upper()}_KEY"))
                  for key in ("desc", "target", "scope", "params")}
        return cls(type_=cfg.get(cls.TYPE_KEY), **fields, **kwargs)

    def to_config(self) -> Config:
        payload = dict(self._spec)
        payload[self.PARAMS_KEY] = dict(payload[self.PARAMS_KEY])
        return Config(payload)

    def to_dict(self):
        return self.to_config().to_dict()

    def to_yaml(self):
        return self.to_config().to_yaml()

    def dump_json(self, path, exist_handle="warn"):
        self.to_config().dump_json(path, exist_handle)

    def dump_yaml(self, path, exist_handle="warn"):
        self.to_config().dump_yaml(path, exist_handle)


class Pipeline(Action):
    """Ordered steps parsed from a nested config (counterpart:
    pipeline.py:151): a step with a ``pipeline`` key is a nested Pipeline,
    any other an Action. Skipped steps are left out of iteration and
    execution but kept in indexing."""

    PIPELINE_KEY = "pipeline"

    @staticmethod
    def _parse_steps(step_cfgs, parent_type, registry) -> List[Action]:
        steps = []
        for step_cfg in step_cfgs:
            is_nested = Pipeline.PIPELINE_KEY in step_cfg
            if is_nested and Action.PARAMS_KEY in step_cfg:
                raise KeyError(f"Cannot specify both {Action.PARAMS_KEY!r} and "
                               f"{Pipeline.PIPELINE_KEY!r} at the same time")
            step_cls = Pipeline if is_nested else Action
            steps.append(step_cls.from_config(step_cfg, _parent_type=parent_type,
                                              _registry=registry))
        return steps

    def __init__(self, cfg, *, _parent_type: Optional[str] = None, _registry: Registry = None):
        super().__init__(type_=cfg.get(self.TYPE_KEY), desc=cfg.get(self.DESC_KEY),
                         _parent_type=_parent_type, _registry=_registry)
        step_cfgs = cfg.get(self.PIPELINE_KEY)
        if step_cfgs is None:
            raise ValueError(f"Missing pipeline config; specify {self.PIPELINE_KEY!r}")
        self._pipeline = self._parse_steps(step_cfgs, self.full_type, self._registry)
        self.config = cfg

    @property
    def config(self) -> Config:
        return self._config

    @config.setter
    def config(self, cfg):
        self._config = Config(cfg)

    @property
    def config_dict(self):
        return self.config.to_dict()

    @property
    def config_yaml(self):
        return self.config.to_yaml()

    def __iter__(self):
        return iter([step for step in self._pipeline if not step.skip])

    def __getitem__(self, idx: int) -> Action:
        return self._pipeline[idx]

    def __len__(self):
        return len(self._pipeline)

    def __repr__(self):
        lines = [f"    {repr(step)}".replace("\n", "\n    ") for step in self]
        return "{}(\n{}\n)".format(self.__class__.__name__, "\n".join(lines))

    @property
    def functional(self) -> Callable:
        # every active step resolves here, so a misconfiguration fails before a run
        for step in self:
            try:
                step.functional
            except KeyError as e:
                raise KeyError(f"Failed to resolve for {step}:\n   scope={step.scope}"
                               f"\n   type={step.type}\n   full_type={step.full_type}") from e

        def run_all(*args, **kwargs):
            for step in self:
                step(*args, **kwargs)

        return run_all

    @classmethod
    def from_config(cls, cfg, **kwargs):
        return cls(cfg, **kwargs)

    @classmethod
    def from_config_file(cls, path, **kwargs):
        return cls.from_config(Config.from_file(path), **kwargs)

    def to_config(self) -> Config:
        return Config({self.TYPE_KEY: self.type, self.DESC_KEY: self.desc,
                       self.PIPELINE_KEY: [step.to_config() for step in self]})


class PipelinePlaner(Pipeline):
    """The search over pipelines or their parameters (counterpart:
    pipeline.py:244)."""

    TUNE_MODE_KEY = "tune_mode"
    TUNING_PARAMS_KEY = "params_to_tune"
    DEFAULT_PARAMS_KEY = "default_params"
    PELEM_INCLUDE_KEY = "include"
    PELEM_EXCLUDE_KEY = "exclude"
    PELEM_SKIP_KEY = "skippable"
    WANDB_KEY = "wandb"
    VALID_TUNE_MODES = ("pipeline", "params")

    def __init__(self, cfg, **kwargs):
        if self.TUNE_MODE_KEY not in cfg:
            raise ValueError(f"PipelinePlaner config must contain {self.TUNE_MODE_KEY!r}")
        # how many step-2 winners advance to params tuning, and step 3's trial budget
        self.pipeline_tuning_top_k = cfg.get("pipeline_tuning_top_k", 3)
        self.parameter_tuning_freq_n = cfg.get("parameter_tuning_freq_n", 20)
        super().__init__(cfg, **kwargs)

    @property
    def tune_mode(self) -> str:
        return self._tune_mode

    @property
    def base_config(self) -> Config:
        return self._base_config

    @property
    def default_params(self):
        return self._default_params

    @property
    def candidate_pipelines(self):
        return getattr(self, "_candidate_pipelines", None)

    @property
    def candidate_names(self):
        return getattr(self, "_candidate_names", None)

    @property
    def candidate_params(self):
        return getattr(self, "_candidate_params", None)

    @property
    def wandb_config(self):
        return self._wandb_config

    def _resolve_pelem_plan(self, idx: int):
        pelem_config = self.config[self.PIPELINE_KEY][idx]
        if pelem_config.get(self.TARGET_KEY) is not None:
            return None, None
        if all(pelem_config.get(k) is not None
               for k in (self.PELEM_INCLUDE_KEY, self.PELEM_EXCLUDE_KEY)):
            raise ValueError(f"Cannot set {self.PELEM_INCLUDE_KEY!r} and "
                             f"{self.PELEM_EXCLUDE_KEY!r} at the same time:\n{pelem_config}")
        scope = self[idx].full_type
        try:
            candidates = {i.replace(f"{scope}.", "", 1)
                          for i in self._registry.children(scope, non_leaf_node=False)}
        except KeyError as e:
            raise KeyError(f"Failed to resolve candidate scope {scope!r}") from e
        includes = set(pelem_config.get(self.PELEM_INCLUDE_KEY) or candidates)
        if unknown := includes - candidates:
            logger.warning("%d inclusions not found under scope %r: %s", len(unknown), scope,
                           sorted(unknown))
        excludes = set(pelem_config.get(self.PELEM_EXCLUDE_KEY) or [])
        filtered = candidates & includes - excludes
        if not filtered:
            raise ValueError(f"No valid candidates for pipeline element {idx} under scope "
                             f"{scope!r}; available: {sorted(candidates)}")
        if pelem_config.get(self.PELEM_SKIP_KEY, False):
            filtered.add(self.SKIP_FLAG)
        return sorted(filtered), self[idx].type

    @Pipeline.config.setter
    def config(self, cfg):
        self._config = Config(cfg)
        self._tune_mode = self.config.get(self.TUNE_MODE_KEY)
        if self.tune_mode == "pipeline_params":
            self._tune_mode = "pipeline"
            logger.info("tune_mode pipeline_params runs the pipeline stage first")

        pipeline_config = self.config[self.PIPELINE_KEY]
        n = len(pipeline_config)
        if n < 1:
            raise ValueError("Empty pipeline.")

        base_keys = pelem_keys = (self.TYPE_KEY, self.DESC_KEY, self.TARGET_KEY)
        if self.tune_mode == "pipeline":
            pelem_keys = pelem_keys + (self.PARAMS_KEY,)
        base_config = {k: v for k in base_keys if (v := self.config.get(k)) is not None}
        base_config[self.PIPELINE_KEY] = [
            {k: v for k in pelem_keys if (v := sub.get(k)) is not None}
            for sub in pipeline_config]
        self._base_config = Config(base_config)

        self._default_params = [None] * n
        self._candidate_names = [None] * n
        if self.tune_mode == "pipeline":
            self._candidate_pipelines = [None] * n
            for i in range(n):
                self._default_params[i] = pipeline_config[i].get(self.DEFAULT_PARAMS_KEY)
                (self._candidate_pipelines[i],
                 self._candidate_names[i]) = self._resolve_pelem_plan(i)
        elif self.tune_mode == "params":
            self._candidate_params = [None] * n
            for i in range(n):
                if self.DEFAULT_PARAMS_KEY in pipeline_config[i]:
                    logger.warning("params tuning mode ignores %r on element %d",
                                   self.DEFAULT_PARAMS_KEY, i)
                if val := pipeline_config[i].get(self.PARAMS_KEY):
                    self._default_params[i] = {self[i].target: val}
                if val := pipeline_config[i].get(self.TUNING_PARAMS_KEY):
                    self._candidate_params[i] = (val.to_dict() if isinstance(val, Config)
                                                 else dict(val))
                    self._candidate_names[i] = self[i].target
            missing = [i for i, j in enumerate(pipeline_config)
                       if j.get(self.TARGET_KEY) is None]
            if missing:
                raise ValueError("Targets required for all elements in params mode; "
                                 f"missing for {missing}")
        else:
            raise ValueError(f"Unknown tune mode {self.tune_mode!r}, "
                             f"options: {self.VALID_TUNE_MODES}")

        self._wandb_config = self.config.get(self.WANDB_KEY)
        if isinstance(self._wandb_config, Config):
            self._wandb_config = self._wandb_config.to_dict()

    # --- plan sanitation: a positional list, or wandb's flat dotted keys
    # ("pipeline.3.<type>": target / "params.2.<name>.<key>": value)

    @staticmethod
    def _positional_plan(mapping: dict, section: str, n: int):
        plan: List[Any] = [None] * n
        for key, val in mapping.items():
            _, _, tail = key.partition(f"{section}.")
            idx_str, _, leaf = tail.partition(".")
            idx = int(idx_str)
            if section == Pipeline.PIPELINE_KEY:
                plan[idx] = val
            else:
                _, _, param_key = leaf.partition(".")
                entry = plan[idx] if isinstance(plan[idx], dict) else {}
                entry[param_key] = val
                plan[idx] = entry
        return plan

    @classmethod
    def _normalize_plan(cls, plan, section: str, n: int, label: str):
        if isinstance(plan, dict):
            plan = cls._positional_plan(plan, section, n)
        if plan is None:
            return None
        if len(plan) != n:
            raise ValueError(f"Expecting {n} {label} specs, got {len(plan)}: {plan}")
        logger.info("%s plan:\n%s", label.capitalize(), pformat(plan))
        return plan

    @classmethod
    def _sanitize_pipeline(cls, pipeline, n: int):
        return cls._normalize_plan(pipeline, cls.PIPELINE_KEY, n, "pipeline")

    @classmethod
    def _sanitize_params(cls, params, n: int):
        return cls._normalize_plan(params, cls.PARAMS_KEY, n, "params")

    def _validate_pipeline(self, validate, pipeline, i):
        if not validate or self.candidate_pipelines[i] is None:
            return
        if pipeline[i] not in self.candidate_pipelines[i]:
            raise ValueError(f"Specified target {pipeline[i]} (i={i}) not supported; "
                             f"options: {self.candidate_pipelines[i]}")

    def _validate_params(self, validate, strict, ith_target, ith_params, i):
        if not validate:
            return
        full_scope = f"{self[i].full_type}.{ith_target}"
        try:
            obj = self._registry.get(full_scope, missed_ok=False)
        except KeyError as e:
            raise DevError(f"Failed to obtain {full_scope} from registry") from e
        known = set(inspect.signature(obj).parameters)
        if (unknown := set(ith_params) - known) and strict:
            raise ValueError(f"{len(unknown)} unknown params for {full_scope!r}: {unknown}")

    # --- generation -------------------------------------------------------

    def generate_config(self, *, pipeline=None, pipeline_params=None, params=None,
                        validate: bool = True, strict_params_check: bool = False) -> Config:
        if pipeline is None and params is None and pipeline_params is None:
            raise ValueError("At least one of pipeline/params/pipeline_params required")
        if self.tune_mode == "pipeline":
            if pipeline is None and pipeline_params is None:
                raise ValueError("pipeline (or pipeline_params) required in pipeline tune mode")
            if pipeline is not None and pipeline_params is not None:
                raise ValueError("Only one of pipeline/pipeline_params may be given")
            if pipeline is None:
                pipeline = pipeline_params
        elif params is None and self.tune_mode == "params":
            raise ValueError("params required in params tune mode")

        config = self.base_config.copy()
        n = len(config[self.PIPELINE_KEY])
        pipeline = self._sanitize_pipeline(pipeline, n)
        params = self._sanitize_params(params, n)

        for i in range(n):
            pelem = config[self.PIPELINE_KEY][i]
            if pipeline is not None and pipeline[i] is not None:
                self._validate_pipeline(validate, pipeline, i)
                pelem[self.TARGET_KEY] = pipeline[i]
            ith_target = pelem.get(self.TARGET_KEY)
            ith_params = Config(pelem.get(self.PARAMS_KEY) or {})
            if self.default_params[i] is not None and ith_target in self.default_params[i]:
                ith_params = ith_params.merge(dict(self.default_params[i][ith_target]))
            if params is not None and params[i] is not None:
                ith_params = ith_params.merge(params[i])
            if ith_params:
                self._validate_params(validate, strict_params_check, ith_target, ith_params, i)
                pelem[self.PARAMS_KEY] = ith_params
        return config

    def generate(self, *, pipeline=None, params=None, pipeline_params=None,
                 **kwargs) -> Pipeline:
        config = self.generate_config(pipeline=pipeline, params=params,
                                      pipeline_params=pipeline_params)
        return Pipeline(config, _registry=self._registry, **kwargs)

    # --- search space -----------------------------------------------------

    def search_space(self) -> Dict[str, Any]:
        if self.tune_mode == "pipeline":
            return {f"{self.PIPELINE_KEY}.{i}.{n}": {"values": j}
                    for i, (j, n) in enumerate(zip(self.candidate_pipelines,
                                                   self.candidate_names))
                    if j is not None}
        if self.tune_mode == "params":
            out = {}
            for i, (param_dict, n) in enumerate(zip(self.candidate_params,
                                                    self.candidate_names)):
                if param_dict is not None:
                    for key, val in param_dict.items():
                        out[f"{self.PARAMS_KEY}.{i}.{n}.{key}"] = val
            return out
        raise DevError(f"Unknown tune mode {self.tune_mode}")

    # --- sweeps -------------------------------------------------------------

    def sweep_agent(self, function: Callable, *, count: Optional[int] = None,
                    method: str = "random", seed: int = 0,
                    summary_file_path: Optional[str] = None,
                    resume: bool = False) -> "SweepRunner":
        """Run a local sweep (counterpart: pipeline.py:512).
        ``function(config_dict)`` receives a flat trial config (wandb's key
        format) and returns a dict of metrics. With ``resume`` and an
        existing ``summary_file_path``, the recorded trials are loaded and
        their configs skipped; the summary CSV is written at the end."""
        runner = SweepRunner(self.search_space(), method=method, seed=seed)
        if resume and summary_file_path and os.path.isfile(summary_file_path):
            runner.load_records(summary_file_path)
        runner.run(function, count=count)
        if summary_file_path:
            runner.write_summary(summary_file_path)
        return runner

    def wandb_sweep_config(self) -> Dict[str, Any]:
        if self.wandb_config is None:
            raise ValueError("wandb config not specified in the raw config")
        return {**self.wandb_config, "parameters": self.search_space()}

    def wandb_sweep(self) -> Tuple[str, str, str]:
        _no_wandb("PipelinePlaner.wandb_sweep")

    def wandb_sweep_agent(self, function: Callable, *, sweep_id=None, entity=None, project=None,
                          count=None) -> Tuple[str, str, str]:
        _no_wandb("PipelinePlaner.wandb_sweep_agent")


# --------------------------------------------------------------------------
# Summary CSV: written and read with the csv module
# --------------------------------------------------------------------------

def _record_columns(records: List[Dict[str, Any]]) -> List[str]:
    """The union of the records' keys in order of first appearance (the
    columns of ``pd.DataFrame(records)``)."""
    cols: Dict[str, None] = {}
    for rec in records:
        cols.update(dict.fromkeys(rec))
    return list(cols)


def _is_missing(val) -> bool:
    return val is None or (isinstance(val, float) and math.isnan(val))


def _cell(val) -> str:
    if isinstance(val, np.generic):
        val = val.item()
    if _is_missing(val):
        return ""
    if isinstance(val, float):
        return repr(val)
    return str(val)


def _parse_cell(text: str):
    """A written cell back as the value it was: int, float, bool, string,
    or None when empty."""
    if text == "":
        return None
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    if text in ("True", "False"):
        return text == "True"
    return text


def _column(values: list) -> np.ndarray:
    """A summary column in pandas' dtype: int64 for ints, bool for bools,
    float64 (NaN for a gap) for numbers with a float or a gap, else object."""
    present = [v for v in values if not _is_missing(v)]
    if present and all(isinstance(v, (bool, np.bool_)) for v in present):
        if len(present) == len(values):
            return np.asarray(values, dtype=bool)
    elif present and all(isinstance(v, (int, float, np.integer, np.floating)) for v in present):
        if len(present) == len(values) and all(isinstance(v, (int, np.integer))
                                               for v in present):
            return np.asarray(values, dtype=np.int64)
        return np.asarray([np.nan if _is_missing(v) else v for v in values], dtype=np.float64)
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def write_records_csv(records: List[Dict[str, Any]], path: str):
    """``pd.DataFrame(records).to_csv(path, index=False)`` with the csv
    module: an empty cell where a record lacks a column or holds None/NaN."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    cols = _record_columns(records)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(cols)
        for rec in records:
            writer.writerow([_cell(rec.get(c)) for c in cols])


def read_records_csv(path: str) -> List[Dict[str, Any]]:
    """The rows of a summary CSV as dicts of parsed cells (empty: None)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        return []
    header = rows[0]
    return [{c: _parse_cell(v) for c, v in zip(header, row)} for row in rows[1:]]


def _signature_value(val):
    """A trial value as resume compares it: numbers by value (``1000 ==
    1000.0``), None and NaN alike, anything unhashable by its repr."""
    if isinstance(val, np.generic):
        val = val.item()
    if _is_missing(val):
        return None
    if isinstance(val, (int, float)) and not isinstance(val, bool):
        return float(val)
    try:
        hash(val)
    except TypeError:
        return repr(val)
    return val


class SweepRunner:
    """Local trial scheduler over a wandb-style search space (counterpart:
    pipeline.py:566): ``{"values": [...]}`` and ``{"min": a, "max": b}``
    (uniform, integer, or ``distribution: log_uniform_values``) specs. Every
    trial's config and metrics are recorded; :meth:`write_summary` writes
    them as the summary CSV."""

    def __init__(self, search_space: Dict[str, Any], *, method: str = "random", seed: int = 0):
        self.search_space = search_space
        self.method = method
        self.rng = _random.Random(seed)
        self.records: List[Dict[str, Any]] = []
        self._resumed = False

    def load_records(self, summary_file_path: str):
        """Load a prior run's summary CSV; :meth:`run` skips its configs."""
        rows = read_records_csv(summary_file_path)
        self.records.extend(rows)
        self._resumed = True
        logger.info("Resumed sweep with %d prior trials from %s", len(rows), summary_file_path)

    def _grid_iter(self):
        keys, options = [], []
        for key, spec in self.search_space.items():
            if "values" not in spec:
                raise ValueError(f"Grid search requires 'values' for {key!r}")
            keys.append(key)
            options.append(spec["values"])
        for combo in itertools.product(*options):
            yield dict(zip(keys, combo))

    def _sample(self) -> Dict[str, Any]:
        out = {}
        for key, spec in self.search_space.items():
            if "values" in spec:
                out[key] = self.rng.choice(spec["values"])
            elif "min" in spec and "max" in spec:
                lo, hi = spec["min"], spec["max"]
                if spec.get("distribution", "").startswith("log"):
                    out[key] = float(np.exp(self.rng.uniform(np.log(lo), np.log(hi))))
                elif isinstance(lo, int) and isinstance(hi, int):
                    out[key] = self.rng.randint(lo, hi)
                else:
                    out[key] = self.rng.uniform(lo, hi)
            else:
                raise ValueError(f"Unsupported search spec for {key!r}: {spec}")
        return out

    def _signature(self, cfg: Dict[str, Any]) -> tuple:
        return tuple(_signature_value(cfg.get(k)) for k in self.search_space)

    def _trial_configs(self, count: Optional[int] = None):
        """This run's trial configs, grid or random; a resumed runner skips
        the recorded configs by value (counterpart: pipeline.py:618)."""
        if self.method == "grid":
            trials = itertools.islice(self._grid_iter(), count)
        else:
            n_random = count if count is not None else 10
            trials = (self._sample() for _ in range(n_random))
        if self._resumed:
            seen = {self._signature(r) for r in self.records}
            n_new = count if count is not None else 10

            def _fresh(gen, limit):
                produced = 0
                for cfg in gen:
                    sig = self._signature(cfg)
                    if sig in seen:
                        continue
                    seen.add(sig)
                    yield cfg
                    produced += 1
                    if limit is not None and produced >= limit:
                        return

            src = (self._grid_iter() if self.method == "grid"
                   else (self._sample() for _ in range(max(n_new, 1) * 50)))
            trials = _fresh(src, count)
        return trials

    def run(self, function: Callable, count: Optional[int] = None):
        """Run ``function(config)`` for each trial; a trial that raises is
        recorded as ``{"error": message}`` and the sweep goes on, as JAX's
        (pipeline.py:652-656)."""
        for i, trial_config in enumerate(self._trial_configs(count)):
            logger.info("Trial %d: %s", i, trial_config)
            t0 = time.perf_counter()
            try:
                metrics = function(dict(trial_config)) or {}
            except Exception as e:  # noqa: BLE001 -- keep sweeping past bad trials
                logger.error("Trial %d failed: %s", i, e)
                metrics = {"error": str(e)}
            runtime = time.perf_counter() - t0
            self.records.append({**trial_config, **metrics, "_runtime": runtime,
                                 "_trial": len(self.records)})
        return self

    def run_vmapped(self, make_trial: Callable, count: Optional[int] = None, *,
                    num_steps: int = 100, metric: str = "score", maximize: bool = True,
                    mesh=None, seed_base: int = 0, device=None):
        """Run an all-numeric sweep as one vmapped training (counterpart:
        pipeline.py:662): the trials' parameters are stacked on a batch
        axis and every step advances all of them
        (:func:`~dance_tpu_torch.parallel.trials.vmapped_trials`; under
        ``mesh`` the trial axis splits over its ``dp`` ranks).

        ``make_trial(configs)`` returns ``(init_fn, loss_fn, data,
        score_fn)``: ``init_fn(seed)`` one trial's parameters as a dict of
        tensors, ``loss_fn(params, data, hyper)`` a scalar (``hyper`` maps
        each search key but ``lr`` to the trial's value), ``data`` shared by
        every trial, ``score_fn(params, data)`` a scalar score, run through
        ``torch.func.vmap`` over the stacked parameters (None: the negated
        final loss). ``lr``, when searched, is each trial's Adam rate.
        ``device`` defaults to the mesh's, else to the card: the CPU only
        when named."""
        import torch

        from dance_tpu_torch.parallel.trials import vmapped_trials

        configs = list(self._trial_configs(count))
        if not configs:
            return self
        for cfg in configs:
            for key, val in cfg.items():
                if not isinstance(val, (int, float)) or isinstance(val, bool):
                    raise ValueError(f"run_vmapped needs numeric candidates; {key!r}={val!r}."
                                     " Use run() for categorical/pipeline sweeps.")
        n = len(configs)
        lr = [float(cfg.get("lr", 1e-3)) for cfg in configs]
        hyper = {key: np.asarray([cfg[key] for cfg in configs], np.float32)
                 for key in self.search_space if key != "lr"}
        init_fn, loss_fn, data, score_fn = make_trial(configs)

        t0 = time.perf_counter()
        stacked, losses = vmapped_trials(init_fn, loss_fn, data,
                                         seeds=[seed_base + i for i in range(n)],
                                         hyperparams=hyper, lr=lr, num_steps=num_steps,
                                         mesh=mesh, device=device)
        if score_fn is None:
            scores = -losses[-1]
        else:
            with torch.no_grad():
                scores = torch.func.vmap(score_fn, in_dims=(0, None))(stacked, data)
            scores = scores.detach().cpu().numpy()
        runtime = time.perf_counter() - t0
        for i, cfg in enumerate(configs):
            self.records.append({**cfg, metric: float(scores[i]), "_runtime": runtime / n,
                                 "_trial": len(self.records), "_vmapped": True})
        self._last_stacked_params = stacked
        self._last_scores = scores
        self._last_losses = losses
        return self

    def summary(self) -> Frame:
        """The records as a table: JAX's ``pd.DataFrame(records)``."""
        cols = _record_columns(self.records)
        return Frame({c: _column([r.get(c) for r in self.records]) for c in cols},
                     index=range(len(self.records)))

    def write_summary(self, path: str):
        """The summary CSV: ``summary().to_csv(path, index=False)``."""
        write_records_csv(self.records, path)

    def best(self, metric: str, maximize: bool = True) -> Dict[str, Any]:
        rows = [r for r in self.records if not _is_missing(r.get(metric))]
        if not rows:
            raise ValueError(f"No trials recorded metric {metric!r}")
        return (max if maximize else min)(rows, key=lambda r: r[metric])


def save_summary_data(entity=None, project=None, sweep_id=None, summary_file_path=None,
                      root_path=None, additional_sweep_ids=None, save: bool = True,
                      runner: Optional[SweepRunner] = None) -> Frame:
    """A sweep's summary table, written to ``summary_file_path`` (counterpart:
    pipeline.py:746). Only a local ``runner``: the wandb API is not used."""
    if runner is None:
        _no_wandb("save_summary_data without a runner")
    if save and summary_file_path:
        if root_path is not None and not os.path.isabs(summary_file_path):
            summary_file_path = os.path.join(root_path, summary_file_path)
        runner.write_summary(summary_file_path)
    return runner.summary()


# --------------------------------------------------------------------------
# The step-3 protocol (counterpart: pipeline.py:776-875)
# --------------------------------------------------------------------------

def _plain(val):
    return val.to_dict() if isinstance(val, Config) else dict(val)


def get_step3_yaml(result_load_path: str, step2_pipeline_planer: PipelinePlaner,
                   conf_save_path: str = "config_yamls/params/",
                   conf_load_path: Optional[str] = None, metric: str = "test_acc",
                   ascending: bool = False, top_k: Optional[int] = None,
                   required_funs: Optional[List[str]] = None,
                   required_indexes: Optional[List[int]] = None,
                   required_params: Optional[List[Dict[str, Any]]] = None) -> List[str]:
    """The top-k step-2 pipelines as params-tuning configs (counterpart:
    pipeline.py:776), each written as JSON to
    ``<conf_save_path>/<rank>_params_tuning_config.json`` with the content
    JAX writes as YAML: the winning targets frozen, ``tune_mode: params``,
    the required steps inserted at their indexes, and each target's
    ``params_to_tune`` from the step-2 config. ``conf_load_path`` (JSON) is
    the base the generated fields overlay. The rows are sorted by
    ``metric`` stably, a missing metric last."""
    if top_k is None:
        top_k = getattr(step2_pipeline_planer, "pipeline_tuning_top_k", 3)
    rows = read_records_csv(result_load_path)
    present = [r for r in rows if not _is_missing(r.get(metric))]
    present.sort(key=lambda r: r[metric], reverse=not ascending)
    rows = (present + [r for r in rows if _is_missing(r.get(metric))])[:top_k]
    planer_cfg = step2_pipeline_planer.config
    pipe_cols = sorted((c for c in _record_columns(rows) if c.startswith("pipeline.")),
                       key=lambda c: int(c.split(".")[1]))
    target_param_specs: Dict[str, Dict] = {}
    for sub in planer_cfg[Pipeline.PIPELINE_KEY]:
        specs = sub.get("params_to_tune")
        if specs:
            target_param_specs.update(_plain(specs))

    os.makedirs(conf_save_path, exist_ok=True)
    paths = []
    for rank, row in enumerate(rows):
        targets = [row.get(c) for c in pipe_cols]
        pipeline_elems = []
        for i, sub in enumerate(planer_cfg[Pipeline.PIPELINE_KEY]):
            tgt = targets[i] if i < len(targets) else sub.get("target")
            if tgt == Action.SKIP_FLAG or _is_missing(tgt):
                continue
            elem = {"type": sub.get("type"), "target": tgt}
            sub_params = sub.get(Action.PARAMS_KEY)
            if sub_params:
                elem[Action.PARAMS_KEY] = _plain(sub_params)
            defaults = sub.get(PipelinePlaner.DEFAULT_PARAMS_KEY)
            if defaults:
                defaults = _plain(defaults)
                if tgt in defaults:
                    elem.setdefault(Action.PARAMS_KEY, {}).update(defaults[tgt])
            if tgt in target_param_specs:
                elem["params_to_tune"] = target_param_specs[tgt]
            pipeline_elems.append(elem)
        for i_req, (fun, idx) in enumerate(zip(required_funs or [], required_indexes or [])):
            elem = {"type": "misc", "target": fun}
            if required_params and i_req < len(required_params):
                elem["params"] = required_params[i_req]
            pipeline_elems.insert(min(idx, len(pipeline_elems)), elem)
        base = Config.from_file(conf_load_path).to_dict() if conf_load_path else {}
        base.update({"type": planer_cfg.get("type", "preprocessor"),
                     "tune_mode": "params",
                     "parameter_tuning_freq_n":
                         getattr(step2_pipeline_planer, "parameter_tuning_freq_n", 20),
                     "pipeline": pipeline_elems})
        cfg = Config(base)
        if step2_pipeline_planer.wandb_config:
            cfg["wandb"] = step2_pipeline_planer.wandb_config
        path = os.path.join(conf_save_path, f"{rank}_params_tuning_config.json")
        cfg.dump_json(path, exist_handle="none")
        paths.append(path)
    return paths


def run_step3(conf_dir: str, evaluate_fn: Callable, *, count: Optional[int] = None,
              method: str = "random", seed: int = 0,
              result_dir: str = "results/params/") -> List[SweepRunner]:
    """A params-mode sweep for every step-3 config in ``conf_dir``
    (counterpart: pipeline.py:855), its summary in ``<result_dir>/<name>.csv``.
    A config that fails is logged and passed over, as in JAX; a YAML file
    there fails (PyYAML)."""
    os.makedirs(result_dir, exist_ok=True)
    runners = []
    for name in sorted(os.listdir(conf_dir)):
        if not name.endswith((".json", ".yml", ".yaml")):
            continue
        try:
            planer = PipelinePlaner.from_config_file(os.path.join(conf_dir, name))
            n = count if count is not None else getattr(planer, "parameter_tuning_freq_n", 20)
            runner = planer.sweep_agent(
                lambda cfg, p=planer: evaluate_fn(p, cfg), count=n, method=method, seed=seed,
                summary_file_path=os.path.join(result_dir, f"{name}.csv"))
            runners.append(runner)
        except Exception as e:  # noqa: BLE001 -- continue past failing configs
            logger.error("Step-3 config %s failed: %s", name, e)
    return runners


# --------------------------------------------------------------------------
# Subset ablations (counterpart: pipeline.py:882-932)
# --------------------------------------------------------------------------

def flatten_dict(d, *, parent_key: str = "", sep: str = "_") -> dict:
    """A nested dict flattened, parent keys joined by ``sep``:
    ``{"a": {"x": 1}} -> {"a_x": 1}``."""
    items = []
    for k, v in d.items():
        new_key = parent_key + sep + k if parent_key else k
        if isinstance(v, dict):
            items.extend(flatten_dict(v, parent_key=new_key, sep=sep).items())
        else:
            items.append((new_key, v))
    return dict(items)


def generate_combinations_with_required_elements(elements: List[Any],
                                                 required: Optional[List[Any]] = None
                                                 ) -> List[List[Any]]:
    """All subsets of ``elements`` that hold every required element."""
    required = required or []
    optional = [e for e in elements if e not in required]
    out = []
    for r in range(len(optional) + 1):
        for combo in itertools.combinations(optional, r):
            out.append([e for e in elements if e in required or e in combo])
    return out


def generate_subsets(config_path: str, save_dir: str, *,
                     required_indexes: Optional[List[int]] = None,
                     launch_script_path: Optional[str] = None,
                     main_cmd: str = "python main.py --config_dir={}") -> List[str]:
    """A config for each subset of the pipeline's steps that keeps the
    required ones, written as JSON to ``<save_dir>/subset_<i>.json`` with
    the content JAX writes as YAML, and a launch script (counterpart:
    pipeline.py:909). ``config_path`` is a JSON config."""
    cfg = Config.from_file(config_path)
    steps = list(cfg[Pipeline.PIPELINE_KEY])
    required = [steps[i] for i in (required_indexes or [])]
    subsets = generate_combinations_with_required_elements(steps, required)
    os.makedirs(save_dir, exist_ok=True)
    paths = []
    for i, subset in enumerate(subsets):
        sub_cfg = cfg.copy()
        sub_cfg[Pipeline.PIPELINE_KEY] = subset
        path = os.path.join(save_dir, f"subset_{i}.json")
        sub_cfg.dump_json(path, exist_handle="none")
        paths.append(path)
    if launch_script_path:
        with open(launch_script_path, "w") as f:
            f.write("#!/bin/bash\n")
            for path in paths:
                f.write(main_cmd.format(path) + " &\n")
            f.write("wait\n")
    return paths


def get_additional_sweep(entity: str, project: str, sweep_id: str) -> List[str]:
    """Counterpart: pipeline.py:940, which follows a resumed sweep's lineage
    through the wandb API."""
    _no_wandb("get_additional_sweep")


__all__ = ["Action", "Pipeline", "PipelinePlaner", "SweepRunner", "flatten_dict",
           "generate_combinations_with_required_elements", "generate_subsets",
           "get_additional_sweep", "get_step3_yaml", "read_records_csv", "run_step3",
           "save_summary_data", "write_records_csv"]
