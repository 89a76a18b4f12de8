"""Gene summary statistics on arrays (counterpart:
dance_tpu/transforms/stats.py).

The ``genestats_*`` functions are the JAX package's numpy functions,
flattened to 1-d. ``GeneStats`` is a function here: it returns the chosen
statistics as a dict of per-gene arrays, where the JAX transform writes a
DataFrame into a ``Data`` container's ``varm``; the port keeps its own
table of the statistics and registers nothing.
"""

from typing import Dict, List, Optional, Union

import numpy as np


def genestats_mu(exp, threshold: float = 0, **kwargs) -> np.ndarray:
    """Mean expression over the expressing cells only (counterpart: stats.py:58)."""
    exp = np.asarray(exp)
    mask = (exp > threshold).astype(float)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.asarray((exp * mask).sum(0) / mask.sum(0)).ravel()


def genestats_alpha(exp, threshold: float = 0, pseudo: bool = False, **kwargs) -> np.ndarray:
    """The share of cells expressing the gene above ``threshold``, with one
    pseudo-cell added when ``pseudo`` (counterpart: stats.py:68)."""
    exp = np.asarray(exp)
    count = (exp > threshold).sum(0).astype(float)
    total = exp.shape[0]
    if pseudo:
        count, total = count + 1, total + 1
    return np.asarray(count / total).ravel()


def genestats_mean_all(exp, **kwargs) -> np.ndarray:
    return np.asarray(np.asarray(exp).mean(0)).ravel()


def genestats_cov_all(exp, **kwargs) -> np.ndarray:
    exp = np.asarray(exp)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.asarray(exp.std(0) / exp.mean(0)).ravel()


def genestats_fano_all(exp, **kwargs) -> np.ndarray:
    exp = np.asarray(exp)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.asarray(exp.var(0) / exp.mean(0)).ravel()


def genestats_max_all(exp, **kwargs) -> np.ndarray:
    return np.asarray(np.asarray(exp).max(0)).ravel()


def genestats_std_all(exp, **kwargs) -> np.ndarray:
    return np.asarray(np.asarray(exp).std(0)).ravel()


GENESTATS_FUNCS = {"mu": genestats_mu, "alpha": genestats_alpha, "mean_all": genestats_mean_all,
                   "cov_all": genestats_cov_all, "fano_all": genestats_fano_all,
                   "max_all": genestats_max_all, "std_all": genestats_std_all}


def GeneStats(exp, genestats_select: Union[str, List[str]] = "all", *,
              fill_na: Optional[float] = None, threshold: float = 0,
              pseudo: bool = False) -> Dict[str, np.ndarray]:
    """The chosen statistics (``"all"``: every one, in the JAX registry's
    order) of the (cells x genes) ``exp``, NaN read as ``fill_na`` when
    given (counterpart: ``GeneStats``, stats.py:11)."""
    if isinstance(genestats_select, str) and genestats_select == "all":
        genestats_select = list(GENESTATS_FUNCS)
    invalid = [i for i in genestats_select if i not in GENESTATS_FUNCS]
    if invalid:
        raise ValueError(f"Unknown genestats selections: {invalid}; available: "
                         f"{list(GENESTATS_FUNCS)}")
    stats = {name: GENESTATS_FUNCS[name](exp, threshold=threshold, pseudo=pseudo)
             for name in genestats_select}
    if fill_na is not None:
        stats = {k: np.where(np.isnan(v), fill_na, v) for k, v in stats.items()}
    return stats


__all__ = ["GENESTATS_FUNCS", "GeneStats", "genestats_alpha", "genestats_cov_all",
           "genestats_fano_all", "genestats_max_all", "genestats_mean_all", "genestats_mu",
           "genestats_std_all"]
