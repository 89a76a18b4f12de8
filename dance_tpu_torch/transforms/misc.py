"""Structural transforms on the container (counterpart:
dance_tpu/transforms/misc.py): ``Compose``, ``SetConfig``, ``SaveRaw``,
``UpdateRaw``, ``RemoveSplit`` and ``AlignMod``, each registered under JAX's
key in the port's own registry."""

import copy
from pprint import pformat
from typing import Any, Dict, Tuple

from dance_tpu_torch.data.container import index_equal, index_intersection
from dance_tpu_torch.registry import register_preprocessor
from dance_tpu_torch.transforms.base import BaseTransform
from dance_tpu_torch.utils import hexdigest


@register_preprocessor("misc")
class Compose(BaseTransform):
    """Sequential composition of transforms; the combined hex digest keys
    the cache. A call records each transform's wall-clock seconds in
    ``timings``."""

    def __init__(self, *transforms: Tuple[BaseTransform, ...],
                 use_master_log_level: bool = True, **kwargs):
        super().__init__(**kwargs)
        bad = [t for t in transforms if not isinstance(t, BaseTransform)]
        if bad:
            bad_str = "\n".join(f"\t{t!r}: {type(t)!r}" for t in bad)
            raise TypeError(f"All transforms must inherit BaseTransform; offending "
                            f"(n={len(bad)}):\n{bad_str}")
        self.transforms = transforms
        if use_master_log_level:
            for t in transforms:
                t.log_level = self.log_level
                t.logger.setLevel(self.log_level)

    def __repr__(self):
        inner = ",\n  ".join(map(repr, self.transforms))
        return f"Compose(\n  {inner},\n)"

    def __getitem__(self, idx: int, /):
        return self.transforms[idx]

    def hexdigest(self) -> str:
        return hexdigest("".join(t.hexdigest() for t in self.transforms))

    def __call__(self, data):
        from dance_tpu_torch.utils.profile import StageTimer
        self.logger.info("Applying composed transformations:\n%r", self)
        timer = StageTimer()
        for t in self.transforms:
            with timer.stage(t.name):
                t(data)
        self.timings = timer.summary()
        self.logger.info("Per-transform timings:\n%s", timer.report())

    def transform_with_history(self, data) -> Dict[str, Any]:
        history = {"original": copy.deepcopy(data)}
        for t in self.transforms:
            t(data)
            history[t.name] = copy.deepcopy(data)
        return history


@register_preprocessor("misc")
class SetConfig(BaseTransform):
    """Declare which channels become x and y (counterpart: misc.py:58)."""

    _DISPLAY_ATTRS = ("config_dict",)

    def __init__(self, config_dict: Dict[str, Any], dummy_params=10, **kwargs):
        super().__init__(**kwargs)
        self.config_dict = config_dict

    def __call__(self, data):
        self.logger.info("Updating data config:\n%s", pformat(self.config_dict))
        data.set_config_from_dict(self.config_dict)


@register_preprocessor("misc")
class SaveRaw(BaseTransform):
    """Snapshot the current (X, var) into ``.raw`` (counterpart: misc.py:73)."""

    def __init__(self, exist_ok: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.exist_ok = exist_ok

    def __call__(self, data):
        if data.data.raw is not None and not self.exist_ok:
            raise AttributeError("Raw data already exists (pass exist_ok=True to overwrite)")
        data.data.raw_to()
        return data


@register_preprocessor("misc")
class UpdateRaw(BaseTransform):
    """Replace X with the saved raw snapshot, its genes cut to the current
    ones (counterpart: misc.py:88)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

    def __call__(self, data):
        raw = data.data.raw
        if raw is None:
            raise AttributeError("No raw data to restore")
        adata = data.data
        if raw.n_vars != adata.n_vars:
            adata._X = raw.to_adata()[:, adata.var_names].X
        else:
            adata._X = raw.X.copy()
        return data


@register_preprocessor("misc")
class RemoveSplit(BaseTransform):
    """Drop a split and its cells from the data (counterpart: misc.py:110)."""

    _DISPLAY_ATTRS = ("split_name",)

    def __init__(self, split_name: str, **kwargs):
        super().__init__(**kwargs)
        self.split_name = split_name

    def __call__(self, data):
        data.pop(split_name=self.split_name)
        return data


@register_preprocessor("misc")
class AlignMod(BaseTransform):
    """Cut a MuData's modalities and joint ``obs`` to the cells they share,
    in the first modality's order (counterpart: misc.py:125)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

    def __call__(self, data):
        md = data.data
        if not hasattr(md, "mod"):
            return data
        common = None
        for m in md.mod.values():
            names = m.obs_names
            common = names if common is None else index_intersection(common, names)
        for k, m in md.mod.items():
            if not index_equal(m.obs_names, common):
                md.mod[k] = m[common]
        md.obs = md.obs.loc(index_intersection(md.obs.index, common))
        return data


__all__ = ["AlignMod", "Compose", "RemoveSplit", "SaveRaw", "SetConfig", "UpdateRaw"]
