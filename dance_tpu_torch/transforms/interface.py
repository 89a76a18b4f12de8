"""Function-wrapping transform (counterpart: dance_tpu/transforms/interface.py).

``AnnDataTransform`` applies an in-place function to the wrapped AnnData.
JAX resolves ``"sc.pp.<name>"`` (also ``scanpy.`` and ``dance_tpu.sc.``) to
its in-place ``dance_tpu.sc.pp`` functions. The port's ``sc.pp`` works on
arrays (:mod:`dance_tpu_torch.sc.pp`), so the names resolve to the in-place
adaptors below, each of which runs the array function on ``adata.X`` and
writes back what JAX's in-place function writes (``dance_tpu/sc/pp.py:33-
394``): ``X``, the ``obs``/``var`` columns, ``uns["log1p"]`` and the
subsets of every aligned channel. A name outside the adaptor table raises
``KeyError`` listing it. JAX's own names for its in-place functions
(``dance_tpu.sc.pp.<name>``, the form a JAX pipeline config records for a
callable step) resolve to the same adaptors; any other name under
``dance_tpu.`` raises ``KeyError``, so that the port never imports the JAX
package. Any other dotted name is imported, as in JAX.
"""

import importlib
from typing import Callable, Optional, Union

import numpy as np

from dance_tpu_torch.registry import register_preprocessor
from dance_tpu_torch.sc import pp
from dance_tpu_torch.transforms.base import BaseTransform

_SCANPY_ALIASES = ("scanpy.", "sc.", "dance_tpu_torch.sc.", "dance_tpu.sc.")


def _subset(adata, obs=None, var=None):
    """Keep the cells ``obs`` or the genes ``var`` (a mask) in place, in
    every channel (JAX's ``_copy_into``, pp.py:105)."""
    sub = adata[np.asarray(obs, dtype=bool)] if obs is not None \
        else adata[:, np.asarray(var, dtype=bool)]
    adata._X = sub.X
    adata.obs = sub.obs
    adata.var = sub.var
    for attr in ("obsm", "varm", "obsp", "varp", "layers"):
        getattr(adata, attr).clear()
        getattr(adata, attr).update(getattr(sub, attr))


def filter_cells(adata, *, min_counts: Optional[int] = None, min_genes: Optional[int] = None,
                 max_counts: Optional[int] = None, max_genes: Optional[int] = None):
    """Counterpart: pp.py:33; ``obs["n_counts"]`` or ``obs["n_genes"]``."""
    mask, metric = pp.filter_cells(adata.X, min_counts=min_counts, min_genes=min_genes,
                                   max_counts=max_counts, max_genes=max_genes)
    _subset(adata, obs=mask)
    counts = min_counts is not None or max_counts is not None
    adata.obs["n_counts" if counts else "n_genes"] = metric[mask]


def filter_genes(adata, *, min_counts: Optional[int] = None, min_cells: Optional[int] = None,
                 max_counts: Optional[int] = None, max_cells: Optional[int] = None):
    """Counterpart: pp.py:65; ``var["n_counts"]`` or ``var["n_cells"]``."""
    mask, metric = pp.filter_genes(adata.X, min_counts=min_counts, min_cells=min_cells,
                                   max_counts=max_counts, max_cells=max_cells)
    _subset(adata, var=mask)
    counts = min_counts is not None or max_counts is not None
    adata.var["n_counts" if counts else "n_cells"] = metric[mask]


def normalize_total(adata, *, target_sum: Optional[float] = None,
                    exclude_highly_expressed: bool = False, max_fraction: float = 0.05,
                    key_added: Optional[str] = None):
    """Counterpart: pp.py:118; ``obs[key_added]`` holds the size factors."""
    opts = dict(target_sum=target_sum, exclude_highly_expressed=exclude_highly_expressed,
                max_fraction=max_fraction)
    if key_added is not None:
        counts, tsum = pp.size_factors(adata.X, **opts)
        adata.obs[key_added] = counts / tsum
    adata._X = pp.normalize_total(adata.X, **opts)


def normalize_per_cell(adata, *, counts_per_cell_after: Optional[float] = None,
                       min_counts: Optional[int] = 1):
    """Counterpart: pp.py:152; drops the cells under ``min_counts``, writes
    ``obs["n_counts"]``."""
    x, kept, counts = pp.normalize_per_cell(adata.X, counts_per_cell_after=counts_per_cell_after,
                                            min_counts=min_counts)
    if not kept.all():
        _subset(adata, obs=kept)
    adata.obs["n_counts"] = counts
    adata._X = x


def log1p(adata, *, base: Optional[float] = None):
    """Counterpart: pp.py:171; ``uns["log1p"]``."""
    adata._X = pp.log1p(adata.X, base=base)
    adata.uns["log1p"] = {"base": base}


def scale(adata, *, zero_center: bool = True, max_value: Optional[float] = None):
    """Counterpart: pp.py:188; ``var["mean"]`` and ``var["std"]``."""
    adata._X, mean, std = pp.scale(adata.X, zero_center=zero_center, max_value=max_value)
    adata.var["mean"] = mean
    adata.var["std"] = std


def highly_variable_genes(adata, *, flavor: str = "seurat", n_top_genes: Optional[int] = None,
                          min_mean: float = 0.0125, max_mean: float = 3.0,
                          min_disp: float = 0.5, max_disp: float = np.inf, n_bins: int = 20,
                          span: float = 0.3, subset: bool = False,
                          batch_key: Optional[str] = None, check_values: bool = True,
                          inplace: bool = True):
    """Counterpart: pp.py:252; every result as a ``var`` column, then the
    genes kept with ``subset``. ``batch_key`` names an ``obs`` column. JAX's
    ``inplace=False`` (the results returned, the AnnData untouched) has no
    port: no ported pipeline sets it."""
    if not inplace:
        raise ValueError("highly_variable_genes: the container adaptor works in place only")
    res = pp.highly_variable_genes(
        adata.X, flavor=flavor, n_top_genes=n_top_genes, min_mean=min_mean, max_mean=max_mean,
        min_disp=min_disp, max_disp=max_disp, n_bins=n_bins, span=span,
        batch_key=None if batch_key is None else adata.obs[batch_key],
        check_values=check_values)
    for key, val in res.items():
        adata.var[key] = val
    if subset:
        _subset(adata, var=res["highly_variable"])


_ADAPTORS = {f"pp.{f.__name__}": f for f in (filter_cells, filter_genes, normalize_total,
                                             normalize_per_cell, log1p, scale,
                                             highly_variable_genes)}


def _resolve_func(name: str) -> Callable:
    if name.startswith(_SCANPY_ALIASES):
        key = ".".join(name.split(".")[-2:])
        if key not in _ADAPTORS:
            raise KeyError(f"{name!r} has no in-place container adaptor in the port; the table: "
                           f"{sorted('sc.' + k for k in _ADAPTORS)}")
        return _ADAPTORS[key]
    if name.startswith("dance_tpu."):
        raise KeyError(f"{name!r} names the JAX package, which the port does not import; the "
                       f"adaptor table: {sorted('sc.' + k for k in _ADAPTORS)}")
    parts = name.split(".")
    return getattr(importlib.import_module(".".join(parts[:-1])), parts[-1])


@register_preprocessor("interface")
class AnnDataTransform(BaseTransform):
    """Apply ``func(adata, **kwargs)`` in place on the wrapped AnnData
    (counterpart: interface.py:28)."""

    _DISPLAY_ATTRS = ("func_name",)

    def __init__(self, func: Union[Callable, str], **kwargs):
        base_kwargs = {k: kwargs.pop(k) for k in ("out", "log_level") if k in kwargs}
        super().__init__(**base_kwargs)
        if isinstance(func, str):
            self.func_name = func
            func = _resolve_func(func)
        else:
            self.func_name = f"{func.__module__}.{func.__qualname__}"
        self.func = func
        self.func_kwargs = {k: v for k, v in kwargs.items() if v is not None}

    def __repr__(self):
        kwargs_str = ", ".join(f"{k}={v!r}" for k, v in self.func_kwargs.items())
        return f"{self.name}({self.func_name}, {kwargs_str})"

    def __call__(self, data):
        self.logger.info("Applying %s with %s", self.func_name, self.func_kwargs)
        self.func(data.data, **self.func_kwargs)
        return data


__all__ = ["AnnDataTransform"]
