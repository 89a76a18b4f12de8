"""Pseudo-spots and cell-type profiles on arrays, the host front of the
deconvolution methods (counterpart: dance_tpu/transforms/pseudobulk.py:15-164).

``get_cell_types``, ``get_agg_func`` and ``get_ct_profile`` are the JAX
functions in numpy. :class:`PseudoMixture` and :class:`CellTopicProfile`
keep the JAX names and take arrays and return arrays: the mixtures and their
cell-type portions, and the (genes x types) profile. Handed a port ``Data``
instead, they act on it as JAX's do (a new split of mixtures, the profile
into ``varm``), and they are registered under JAX's keys in the port's own
registry. The mixtures are drawn from ``np.random.default_rng(random_state)``
in the JAX order, so they are the JAX package's bit for bit. Giotto's detection profile
(``get_giotto_dt``, :167), :class:`CellGiottoTopicProfile` (:180) and
:class:`CellTypeNums` (:216) return arrays where the JAX transforms write
``varm`` and ``uns``.
"""

from functools import partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from dance_tpu_torch.data import AnnData, Data, Frame
from dance_tpu_torch.data.base import BaseData
from dance_tpu_torch.registry import register_preprocessor
from dance_tpu_torch.transforms.base import BaseTransform


def get_cell_types(ct_select: Union[str, Sequence[str]], annot) -> List[str]:
    """The sorted cell types of ``annot`` for ``"auto"``, else ``ct_select``,
    which must all occur in ``annot`` (counterpart: pseudobulk.py:15)."""
    all_cts = sorted(map(str, np.unique(annot)))
    if isinstance(ct_select, str) and ct_select == "auto":
        return all_cts
    if missed := sorted(set(ct_select) - set(all_cts)):
        raise ValueError(f"Unknown cell types selected: {missed}; available: {all_cts}")
    return list(ct_select)


def get_agg_func(name: str, *, default: Optional[str] = None) -> Callable:
    """The row aggregation ``"median"`` or ``"mean"`` (``"default"`` is
    ``default``) over axis 0 (counterpart: pseudobulk.py:24)."""
    if name == "default":
        if default is None:
            raise ValueError("Aggregation 'default' requested but no default provided")
        name = default
    if name == "median":
        return partial(np.median, axis=0)
    if name == "mean":
        return partial(np.mean, axis=0)
    raise ValueError(f"Unknown aggregation {name!r}; options: median, mean")


def get_ct_profile(x, annot, *, batch_index=None, ct_select="auto",
                   method: str = "mean") -> np.ndarray:
    """Per-cell-type expression profile, (genes x types) float32 (counterpart:
    pseudobulk.py:37): within each batch, the aggregate of the type's cells
    over its library size; across batches, that profile's aggregate times the
    libraries' aggregate."""
    ct_select = get_cell_types(ct_select, annot)
    agg = get_agg_func(method, default="mean")
    if batch_index is None:
        batch_index = np.zeros(x.shape[0], dtype=int)
    batch_index = np.asarray(batch_index)
    profile = np.zeros((x.shape[1], len(ct_select)), dtype=np.float32)
    annot = np.asarray(annot).astype(str)
    for i, ct in enumerate(ct_select):
        ct_idx = np.nonzero(annot == ct)[0]
        sub_batches = np.unique(batch_index[ct_idx])
        per_batch = np.zeros((len(sub_batches), x.shape[1]), dtype=np.float32)
        lib_sizes = np.zeros(len(sub_batches), dtype=np.float32)
        for j, b in enumerate(sub_batches):
            idx = ct_idx[batch_index[ct_idx] == b]
            per_batch[j] = agg(x[idx])
            lib_sizes[j] = per_batch[j].sum()
            per_batch[j] /= max(lib_sizes[j], 1e-12)
        profile[:, i] = agg(per_batch) * agg(lib_sizes)
    return profile


@register_preprocessor("pseudobulk")
class PseudoMixture(BaseTransform):
    """Pseudo-spots for deconvolution (counterpart: pseudobulk.py:62-128):
    ``n_pseudo`` sums of ``nc_min`` .. ``nc_max`` reference cells drawn
    without replacement, with each mixture's cell-type portions.

    ``__call__(x, annot)`` takes the reference cells (cells x genes) and
    their labels and returns ``(mix_x, portions, cell_types)``: float32
    (n_pseudo x genes) counts, float64 (n_pseudo x types) portions in the
    order of ``cell_types``. ``info`` keeps each mixture's cell count and
    total count (the JAX split's ``obs``).

    ``__call__(data)`` mixes the cells of split ``"ref"`` (their ``X``,
    labels in ``obs["cellType"]``) and appends the mixtures, named
    ``ps_mix_<i>``, as split ``"pseudo"``, as JAX's does with the arguments
    every pipeline gives it (the port keeps them as class constants: no
    pipeline sets another). Where it differs: JAX's ``Data.append`` drops every
    ``obsm`` entry, the portions of the mixtures among them; the port keeps
    the container's ``obsm`` arrays (zeros on the mixtures' rows) and writes
    ``obsm["cell_type_portion"]``, the mixtures' portions over zeros for
    every other cell, which the deconvolution models train on."""

    _DISPLAY_ATTRS = ("n_pseudo", "nc_min", "nc_max", "ct_select")
    ct_key, prefix, in_split_name, out_split_name = "cellType", "ps_mix_", "ref", "pseudo"

    def __init__(self, *, n_pseudo: int = 1000, nc_min: int = 2, nc_max: int = 10,
                 ct_select: Union[str, List[str]] = "auto", random_state: Optional[int] = 0,
                 **kwargs):
        super().__init__(**kwargs)
        self.n_pseudo = n_pseudo
        self.nc_min = nc_min
        self.nc_max = nc_max
        self.ct_select = ct_select
        self.random_state = random_state
        self.info: Dict[str, np.ndarray] = {}

    @staticmethod
    def gen_mix(x, annot, nc_min: int = 2, nc_max: int = 10,
                rng: Optional[np.random.Generator] = None
                ) -> Tuple[np.ndarray, Dict[str, int], Dict[str, float]]:
        """One mixture: ``(counts, {type: cells}, {"cell_count", "total_umi_count"})``
        (counterpart: pseudobulk.py:92)."""
        rng = rng or np.random.default_rng()
        n_mix = int(rng.integers(nc_min, nc_max + 1))
        sample = rng.choice(x.shape[0], size=n_mix, replace=False)
        mix_counts = x[sample].sum(0)
        ct_counts = dict(zip(*np.unique(annot[sample], return_counts=True)))
        info = {"cell_count": n_mix, "total_umi_count": float(mix_counts.sum())}
        return mix_counts, ct_counts, info

    def __call__(self, x, annot=None):
        if isinstance(x, BaseData):
            return self._append_mixtures(x)
        return self._mix(x, annot)

    def _append_mixtures(self, data):
        """Counterpart: pseudobulk.py:103-128."""
        x = data.get_feature(split_name=self.in_split_name, channel_type="X",
                             return_type="numpy")
        annot = data.get_feature(split_name=self.in_split_name, channel=self.ct_key,
                                 channel_type="obs", return_type="numpy")
        mix_x, portions, ct_select = self._mix(x, annot)
        index = [f"{self.prefix}{i}" for i in range(self.n_pseudo)]
        obs = Frame({"cell_count": self.info["cell_count"],
                     "total_umi_count": self.info["total_umi_count"]}, index=index)
        kept = {k: v for k, v in data.data.obsm.items() if isinstance(v, np.ndarray)}
        data.append(Data(AnnData(mix_x, obs=obs, var=data.data.var.copy())), join="outer",
                    mode="new_split", new_split_name=self.out_split_name)
        obsm = data.data.obsm
        for key, val in kept.items():
            obsm[key] = np.concatenate([val, np.zeros((self.n_pseudo,) + val.shape[1:],
                                                      val.dtype)])
        full = np.zeros((data.shape[0], len(ct_select)))
        full[data.get_split_idx(self.out_split_name)] = portions
        obsm["cell_type_portion"] = Frame(full, index=data.data.obs_names, columns=ct_select)
        return data

    def _mix(self, x, annot) -> Tuple[np.ndarray, np.ndarray, List[str]]:
        x = np.asarray(x)
        annot = np.asarray(annot).astype(str)
        rng = np.random.default_rng(self.random_state)
        ct_select = get_cell_types(self.ct_select, annot)
        col = {ct: j for j, ct in enumerate(ct_select)}
        mix_x = np.zeros((self.n_pseudo, x.shape[1]), dtype=np.float32)
        counts = np.zeros((self.n_pseudo, len(ct_select)), dtype=np.float64)
        info = np.zeros((self.n_pseudo, 2))
        for i in range(self.n_pseudo):
            mix_x[i], ct_counts, mix_info = self.gen_mix(x, annot, self.nc_min, self.nc_max,
                                                         rng)
            for ct, c in ct_counts.items():
                if ct in col:  # JAX's DataFrame drops columns it was not given
                    counts[i, col[ct]] = c
            info[i] = mix_info["cell_count"], mix_info["total_umi_count"]
        self.info = {"cell_count": info[:, 0].astype(int), "total_umi_count": info[:, 1]}
        # the JAX DataFrame division: a mixture of none of the selected types is NaN
        with np.errstate(invalid="ignore", divide="ignore"):
            portions = counts / counts.sum(1, keepdims=True)
        return mix_x, portions, ct_select


@register_preprocessor("pseudobulk")
class CellTopicProfile(BaseTransform):
    """Per-cell-type profile of labelled cells (counterpart: pseudobulk.py:131):
    ``__call__(x, annot, batch=None)`` returns ``(profile, cell_types)``, the
    (genes x types) float32 :func:`get_ct_profile` and its column names (the
    JAX transform's ``varm`` DataFrame). ``__call__(data)`` profiles the
    cells of split ``split_name`` (every cell when None; their ``X``, labels
    in ``obs["cellType"]``, batches in ``obs[batch_key]`` when it is set)
    into ``varm[out]``, a ``Frame`` over the genes with a column per type.
    The label key is a class constant, printed in the digest as JAX prints
    it: no pipeline sets another."""

    _DISPLAY_ATTRS = ("ct_select", "ct_key", "split_name", "method")
    ct_key = "cellType"

    def __init__(self, *, ct_select: Union[str, List[str]] = "auto",
                 batch_key: Optional[str] = None, split_name: Optional[str] = None,
                 method: str = "median", **kwargs):
        super().__init__(**kwargs)
        self.ct_select = ct_select
        self.batch_key = batch_key
        self.split_name = split_name
        self.method = method

    def __call__(self, x, annot=None, batch=None):
        if isinstance(x, BaseData):
            data = x

            def get(channel, channel_type):
                return data.get_feature(split_name=self.split_name, channel=channel,
                                        channel_type=channel_type, return_type="numpy")

            x, annot = get(None, "X"), get(self.ct_key, "obs")
            batch = None if self.batch_key is None else get(self.batch_key, "obs")
            profile, ct_select = self._profile(x, annot, batch)
            data.data.varm[self.out] = Frame(profile, index=data.data.var_names,
                                             columns=ct_select)
            return data
        return self._profile(x, annot, batch)

    def _profile(self, x, annot, batch) -> Tuple[np.ndarray, List[str]]:
        ct_select = get_cell_types(self.ct_select, annot)
        return get_ct_profile(np.asarray(x), annot, batch_index=batch, ct_select=ct_select,
                              method=self.method), ct_select


def get_giotto_dt(x, annot, detection_threshold: float = -1, *,
                  ct_select="auto") -> np.ndarray:
    """Each type's share of cells above ``detection_threshold`` per gene,
    (genes x types) float32 (counterpart: pseudobulk.py:167)."""
    ct_select = get_cell_types(ct_select, annot)
    annot = np.asarray(annot).astype(str)
    profile = np.zeros((x.shape[1], len(ct_select)), dtype=np.float32)
    for i, ct in enumerate(ct_select):
        idx = np.nonzero(annot == ct)[0]
        profile[:, i] = (x[idx] > detection_threshold).mean(0)
    return profile


class CellGiottoTopicProfile:
    """Giotto's mean and detection profiles per type (counterpart:
    pseudobulk.py:180): ``__call__(x, annot)`` returns ``(mean_profile,
    detection_profile, cell_types)``, both (genes x types) float32."""

    def __init__(self, *, ct_select: Union[str, List[str]] = "auto",
                 detection_threshold: float = -1):
        self.ct_select = ct_select
        self.detection_threshold = detection_threshold

    def __call__(self, x, annot) -> Tuple[np.ndarray, np.ndarray, List[str]]:
        x = np.asarray(x)
        ct_select = get_cell_types(self.ct_select, annot)
        mean_profile = get_ct_profile(x, annot, ct_select=ct_select, method="mean")
        det_profile = get_giotto_dt(x, annot, self.detection_threshold, ct_select=ct_select)
        return mean_profile, det_profile, ct_select


class CellTypeNums:
    """The cell count of each type (counterpart: pseudobulk.py:216):
    ``__call__(annot)`` returns ``(counts, cell_types)``."""

    def __init__(self, *, ct_select: Union[str, List[str]] = "auto"):
        self.ct_select = ct_select

    def __call__(self, annot) -> Tuple[np.ndarray, List[str]]:
        ct_select = get_cell_types(self.ct_select, annot)
        annot = np.asarray(annot).astype(str)
        return np.asarray([int((annot == ct).sum()) for ct in ct_select]), ct_select


__all__ = ["CellGiottoTopicProfile", "CellTopicProfile", "CellTypeNums", "PseudoMixture",
           "get_agg_func", "get_cell_types", "get_ct_profile", "get_giotto_dt"]
