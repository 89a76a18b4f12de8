"""Normalisation on arrays: ScTransform's regularised negative-binomial
residuals and their analytic form, axis-wise scaling, TF-IDF, and the
scanpy fronts (counterparts: dance_tpu/transforms/normalize.py,
``ColumnSumNormalize`` :22-57, ``tfidfTransform`` :62-80, ``ScTransform``
:85-239 with ``gmean`` :242, ``_bw_silverman`` :254, ``robust_scale_binned``
:263, ``is_outlier`` :277, ``theta_ml`` :293, ``_kernel_reg_ll`` :302,
``_theta_ml_vec`` :320 and ``_poisson_glm_theta`` :349, ``ScTransformR``
:384, ``Log1P``, ``NormalizeTotal``, ``NormalizePlaceHolder``,
``UpdateSizeFactors`` and ``NormalizeTotalLog1P`` :462-531).

The JAX transforms read and write a ``Data`` container. Here each takes the
cells x genes matrix and returns what JAX writes: :class:`ScTransform`
returns a dict with the residual matrix under ``"X"`` and dicts of the
``var`` and ``obs`` columns under their JAX names. :class:`Log1P`,
:class:`NormalizeTotal`, :class:`UpdateSizeFactors`,
:class:`ColumnSumNormalize`, :class:`NormalizePlaceHolder` and
:class:`NormalizeTotalLog1P`, which the container pipelines and the tuning
configs name, also take a port ``Data`` and then act on it as JAX's do;
they are registered under JAX's keys in the port's own registry. All but
``UpdateSizeFactors`` and ``ColumnSumNormalize`` take JAX's ``mod``, which
the tuning configs set (:func:`~dance_tpu_torch.utils.wrappers.
add_mod_and_transform`).

ScTransform's ``"glm"`` flavour in stages, each on ``device`` (the CUDA card
unless the CPU is named):

- the cell attributes and the log geometric means of the genes (float64);
- the step-1 genes, a density-balanced draw of ``n_genes`` of them
  (:func:`step1_genes`, host numpy: the KDE and the draw);
- the Poisson GLM of each step-1 gene on ``[1, log10 umi]``, 25 IRLS steps
  for all genes at once, and the Newton steps for θ with the reference's
  loop semantics, in float32 as JAX runs them (:func:`poisson_glm_theta`);
- the binned robust outlier flags (host numpy: bins and medians);
- the local-linear kernel regression of the parameters over the log
  geometric mean, with Silverman's bandwidth, and the clipped Pearson
  residuals, in float64 as JAX's host numpy computes them
  (:func:`sct_regularize`, :func:`sct_residuals`).

Where this differs from the JAX package:

- JAX draws the step-1 genes from numpy's global generator (normalize.py:169).
  The port takes ``random_state`` and makes the same call on
  ``np.random.RandomState(random_state)``: after ``np.random.seed(s)`` the
  JAX transform draws the genes that ``random_state=s`` draws here.
- ``ScTransformR`` drives R through rpy2, which the card's machine lacks: it
  raises ``NotImplementedError``.
- ``NormalizeTotal``'s ``key_added`` is not taken: the port returns the
  matrix, or normalises a ``Data`` in place. ScTransform's ``n_cells``,
  ``bin_size`` and ``processes_num``, which JAX stores and never reads, are
  not taken.
"""

import time
from typing import Dict, Optional

import numpy as np
import scipy.sparse as sp
import torch

from dance_tpu_torch.data.base import BaseData
from dance_tpu_torch.registry import register_preprocessor
from dance_tpu_torch.sc import pp
from dance_tpu_torch.transforms.base import BaseTransform
from dance_tpu_torch.transforms.interface import AnnDataTransform
from dance_tpu_torch.utils import resolve_device
from dance_tpu_torch.utils.matrix import normalize as matrix_normalize
from dance_tpu_torch.utils.wrappers import add_mod_and_transform


def _dense64(x) -> np.ndarray:
    return np.asarray(x.toarray() if sp.issparse(x) else x, np.float64)


@register_preprocessor("normalize")
class ColumnSumNormalize(BaseTransform):
    """Axis-wise scaling of each group of cells on its own (counterpart:
    normalize.py:22), :func:`~dance_tpu_torch.utils.matrix.normalize` in
    float32 on ``device``. ``__call__(x, groups=None)`` takes the groups as
    index arrays (JAX's splits) or as one label per cell (JAX's
    ``batch_key``); without them the matrix is one group. On a port
    ``Data``, ``X`` is scaled as one group, as JAX's default does; JAX's
    ``split_names`` and ``batch_key`` stay None (class constants printed in
    the digest): no caller sets them."""

    _DISPLAY_ATTRS = ("axis", "mode", "eps", "split_names", "batch_key")
    split_names = None
    batch_key = None

    def __init__(self, *, axis: int = 0, mode: str = "normalize", eps: float = -1.0,
                 device="auto", **kwargs):
        super().__init__(**kwargs)
        self.axis = axis
        self.mode = mode
        self.eps = eps
        self.device = device

    def __call__(self, x, groups=None):
        if isinstance(x, BaseData):
            x.data.X = self(x.data.X)
            return x
        device = resolve_device(self.device)
        xt = torch.from_numpy(np.asarray(x.toarray() if sp.issparse(x) else x,
                                         np.float32)).to(device)
        if groups is None:
            groups = [np.arange(xt.shape[0])]
        elif len(groups) == xt.shape[0] and np.ndim(groups[0]) == 0:
            labels = np.asarray(groups)
            groups = [np.nonzero(labels == b)[0] for b in np.unique(labels)]
        for idx in groups:
            idx = torch.as_tensor(np.asarray(idx), device=device)
            xt[idx] = matrix_normalize(xt[idx], mode=self.mode, axis=self.axis, eps=self.eps)
        return xt.cpu().numpy()


def tfidf(x: torch.Tensor) -> torch.Tensor:
    """Term frequency over the cell's total times the inverse document
    frequency ``n / column sum``, divisors at least 1e-12 (counterpart:
    ``_tfidf_jit``, normalize.py:77)."""
    tf = x / x.sum(1, keepdim=True).clamp(min=1e-12)
    return tf * (x.shape[0] / x.sum(0, keepdim=True).clamp(min=1e-12))


class tfidfTransform:
    """TF-IDF of a cells x peaks matrix in float32 on ``device``
    (counterpart: normalize.py:62)."""

    def __init__(self, device="auto"):
        self.device = device

    def __call__(self, x) -> np.ndarray:
        xt = torch.from_numpy(np.asarray(x.toarray() if sp.issparse(x) else x, np.float32))
        return tfidf(xt.to(resolve_device(self.device))).cpu().numpy()


def gmean(x, axis: int = 0, eps: float = 1) -> np.ndarray:
    """Geometric mean with zeros contributing 0 to the log sum, host numpy
    float64 (counterpart: normalize.py:242)."""
    if sp.issparse(x):
        x = x.copy()
        x.data = np.log(x.data + eps)
        return np.exp(np.asarray(x.mean(axis)).ravel()) - eps
    x = np.asarray(x, np.float64)
    logs = np.where(x != 0, np.log(x + eps), 0.0)
    return np.exp(logs.mean(axis)) - eps


def _bw_silverman(x) -> float:
    """Silverman's rule-of-thumb bandwidth (counterpart: normalize.py:254)."""
    x = np.asarray(x, np.float64)
    iqr = np.subtract(*np.percentile(x, [75, 25]))
    sigma = min(x.std(), iqr / 1.34) or x.std() or 1.0
    return float(0.9 * sigma * len(x) ** (-0.2))


def robust_scale_binned(y, x, breaks) -> np.ndarray:
    """Median/MAD z-scores within the bins of ``x`` (counterpart:
    normalize.py:263)."""
    y, x = np.asarray(y, np.float64), np.asarray(x, np.float64)
    bins = np.digitize(x, breaks)
    res = np.zeros(bins.size)
    for b in np.unique(bins):
        m = bins == b
        yb = y[m]
        med = np.median(yb)
        res[m] = (yb - med) / (1.4826 * np.median(np.abs(yb - med)) + np.finfo(float).eps)
    return res


def is_outlier(y, x, th: float = 10) -> np.ndarray:
    """Robust z-scores over two binnings shifted by half a bin; a gene is an
    outlier when the smaller of its two |scores| passes ``th`` (counterpart:
    normalize.py:277)."""
    x = np.asarray(x, np.float64)
    bin_width = (x.max() - x.min()) * _bw_silverman(x) / 2
    if bin_width <= 0:
        return np.zeros(len(x), bool)
    eps = np.finfo(float).eps * 10
    breaks1 = np.arange(x.min(), x.max() + bin_width, bin_width)
    breaks2 = np.arange(x.min() - eps - bin_width / 2, x.max() + bin_width, bin_width)
    score1 = robust_scale_binned(y, x, breaks1)
    score2 = robust_scale_binned(y, x, breaks2)
    return np.abs(np.vstack([score1, score2])).min(0) > th


def theta_ml_vec(y: torch.Tensor, mu: torch.Tensor, limit: int = 10) -> torch.Tensor:
    """ML inverse dispersion of each column, Newton steps from the method
    of moments (counterpart: ``_theta_ml_vec``, normalize.py:320): at most
    ``limit - 1`` steps, a column stopping once its step is at most
    ``eps^¼`` (float64 eps), the step taken from ``|θ|``; θ at least 0."""
    n = y.shape[0]
    t = n / (((y / mu.clamp(min=1e-12) - 1) ** 2).sum(0)).clamp(min=1e-12)

    def score(th):
        return (torch.digamma(th + y) - torch.digamma(th) + torch.log(th) + 1
                - torch.log(th + mu) - (y + th) / (mu + th)).sum(0)

    def info(th):
        return (-torch.polygamma(1, th + y) + torch.polygamma(1, th) - 1 / th
                + 2 / (mu + th) - (y + th) / (mu + th) ** 2).sum(0)

    eps = np.finfo(np.float64).eps ** 0.25
    de = torch.ones_like(t)
    for _ in range(limit - 1):
        active = de.abs() > eps
        t_abs = t.abs()
        step = score(t_abs[None, :]) / info(t_abs[None, :])
        de = torch.where(active, step, 0.0)
        t = torch.where(active, t_abs + step, t)
    return t.clamp(min=0.0)


def theta_ml(y, mu, limit: int = 10) -> float:
    """θ of one gene, float32 on the CPU (counterpart: normalize.py:293)."""
    y = torch.as_tensor(np.asarray(y, np.float32))[:, None]
    mu = torch.as_tensor(np.asarray(mu, np.float32))[:, None]
    return float(theta_ml_vec(y, mu, limit=limit)[0])


def poisson_glm_theta(y: torch.Tensor, u: torch.Tensor, n_irls: int = 25):
    """The Poisson GLM of each column of ``y`` (cells x genes) on ``[1, u]``
    by ``n_irls`` IRLS steps, all columns at once, then θ by
    :func:`theta_ml_vec` at the fitted means (counterpart:
    ``_poisson_glm_theta``, normalize.py:349). Computes in ``y``'s dtype
    where it lies (JAX: float32). Returns ``(beta (genes, 2), theta)``."""
    eps = 1e-8
    b0 = torch.log(y.mean(0).clamp(min=eps))
    b1 = torch.zeros_like(b0)
    uc = u[:, None]
    for _ in range(n_irls):
        eta = b0[None, :] + uc * b1[None, :]
        mu = torch.exp(eta.clamp(-30, 30))
        z = eta + (y - mu) / mu.clamp(min=eps)
        w = mu
        s0, s1, s2 = w.sum(0), (w * uc).sum(0), (w * uc ** 2).sum(0)
        r0, r1 = (w * z).sum(0), (w * z * uc).sum(0)
        det = (s0 * s2 - s1 ** 2).clamp(min=eps)  # >= 0 by Cauchy-Schwarz
        b0, b1 = (s2 * r0 - s1 * r1) / det, (s0 * r1 - s1 * r0) / det
    mu = torch.exp((b0[None, :] + uc * b1[None, :]).clamp(-30, 30))
    return torch.stack([b0, b1], dim=1), theta_ml_vec(y, mu)


def kernel_reg_ll(y: torch.Tensor, xs: torch.Tensor, x_points: torch.Tensor,
                  bw: float) -> torch.Tensor:
    """Local-linear Gaussian kernel regression of ``y`` on ``xs`` evaluated
    at ``x_points`` (counterpart: ``_kernel_reg_ll``, normalize.py:302)."""
    d = (x_points[:, None] - xs[None, :]) / bw
    w = torch.exp(-0.5 * d ** 2)
    dx = xs[None, :] - x_points[:, None]
    s0, s1, s2 = w.sum(1), (w * dx).sum(1), (w * dx ** 2).sum(1)
    t0, t1 = (w * y[None, :]).sum(1), (w * dx * y[None, :]).sum(1)
    denom = s0 * s2 - s1 ** 2
    return torch.where(denom.abs() > 1e-12, (s2 * t0 - s1 * t1) / denom,
                       t0 / s0.clamp(min=1e-12))


def step1_genes(log_gmean: np.ndarray, n_genes: Optional[int],
                random_state: Optional[int] = 0) -> np.ndarray:
    """The step-1 genes: all of them, or ``n_genes`` drawn without
    replacement with probability inverse to the Gaussian KDE (Scott's rule)
    of the log geometric means, sorted (counterpart: normalize.py:160-172;
    its ``np.random.choice`` made on ``np.random.RandomState(random_state)``).
    """
    genes = np.arange(len(log_gmean))
    if n_genes is None or n_genes >= genes.size:
        return genes
    from scipy import stats

    dens = stats.gaussian_kde(log_gmean, bw_method="scott")
    xlo = np.linspace(log_gmean.min(), log_gmean.max(), 512)
    prob = 1.0 / (np.interp(log_gmean, xlo, dens.evaluate(xlo)) + np.finfo(float).eps)
    rng = np.random.RandomState(random_state)
    return np.sort(rng.choice(genes, size=n_genes, p=prob / prob.sum(), replace=False))


def sct_regularize(pars: torch.Tensor, log_gmean_step1: np.ndarray,
                   genes_log_gmean: np.ndarray, bw_adjust: float):
    """Each step-1 parameter column (intercept, log-umi slope, dispersion)
    regressed over the log geometric mean and evaluated at every gene's
    (clipped to the step-1 range), then θ from the regularised dispersion
    (counterpart: normalize.py:191-199). ``pars`` is a float64 tensor on the
    device; returns ``(full (genes, 3), theta_full)`` there."""
    bw = _bw_silverman(log_gmean_step1) * bw_adjust
    dev = pars.device
    xs = torch.from_numpy(np.asarray(log_gmean_step1, np.float64)).to(dev)
    gm = torch.from_numpy(np.asarray(genes_log_gmean, np.float64)).to(dev)
    x_points = gm.clamp(float(log_gmean_step1.min()), float(log_gmean_step1.max()))
    full = torch.stack([kernel_reg_ll(pars[:, j], xs, x_points, bw)
                        for j in range(pars.shape[1])], dim=1)
    theta_full = (10 ** gm / (10 ** full[:, 2] - 1)).clamp(min=1e-7)
    return full, theta_full


def sct_residuals(x: torch.Tensor, full: torch.Tensor, theta_full: torch.Tensor,
                  log_umi: torch.Tensor) -> torch.Tensor:
    """Pearson residuals of the counts under the regularised model at the
    nonzero entries, negatives zeroed, clipped at ``sqrt(n / 30)``
    (counterpart: normalize.py:201-207), in ``x``'s dtype where it lies."""
    mu = torch.exp(full[:, 0][None, :] + full[:, 1][None, :] * log_umi[:, None])
    resid = (x - mu) / torch.sqrt(mu + mu ** 2 / theta_full[None, :])
    resid = torch.where((x == 0) | (resid < 0), 0.0, resid)
    return resid.clamp(max=float(np.sqrt(x.shape[0] / 30)))


def pearson_residuals(x: torch.Tensor, theta: float, clip: float) -> torch.Tensor:
    """Analytic Pearson residuals with a shared θ, clipped to ±``clip``
    (counterpart: ``_pearson_residuals``, normalize.py:234)."""
    cell_counts = x.sum(1, keepdim=True)
    gene_frac = x.sum(0, keepdim=True) / x.sum().clamp(min=1e-12)
    mu = cell_counts * gene_frac
    resid = (x - mu) / torch.sqrt(mu + mu ** 2 / theta + 1e-12)
    return resid.clamp(-clip, clip)


class ScTransform:
    """ScTransform's variance stabilisation of a cells x genes count matrix
    (counterpart: normalize.py:85). ``__call__(x)`` returns a dict:

    - ``flavor="glm"``: ``"X"``, the (cells, genes) float32 residuals (0 for
      genes under ``min_cells`` counts); ``"var"``, a dict of the per-gene
      columns ``Intercept_sct``, ``log_umi_sct``, ``Intercept_step1_sct``,
      ``log_umi_step1_sct``, ``theta_sct``, ``dispersion_step1_sct``,
      ``genes_step1_sct`` and ``log10_gmean_sct`` (NaN where JAX leaves
      them so); ``"obs"``, a dict of the per-cell columns ``umi_sct``,
      ``log_umi_sct``, ``gene_sct``, ``log_gene_sct``, ``umi_per_gene_sct``
      and ``log_umi_per_gene_sct``.
    - ``flavor="analytic"``: ``"X"``, the clipped analytic residuals of the
      genes expressed in at least ``min_cells`` cells, and ``"genes_kept"``,
      their mask (JAX subsets ``var`` by it).

    ``random_state`` seeds the step-1 draw (module docstring). After a
    ``"glm"`` call, ``seconds`` holds each stage's wall time (the device
    synchronised at each stage's end): ``"attributes"``, ``"glm_theta"``,
    ``"outliers"``, ``"regularize"`` and ``"residuals"``."""

    def __init__(self, min_cells: int = 5, gmean_eps: float = 1.0,
                 n_genes: Optional[int] = 2000, bw_adjust: float = 3.0, *, flavor: str = "glm",
                 theta: float = 100.0, clip: Optional[float] = None,
                 random_state: Optional[int] = 0, device="auto"):
        if flavor not in ("glm", "analytic"):
            raise ValueError(f"Unknown flavor {flavor!r}, options: glm, analytic")
        self.min_cells = min_cells
        self.gmean_eps = gmean_eps
        self.n_genes = n_genes
        self.bw_adjust = bw_adjust
        self.flavor = flavor
        self.theta = theta
        self.clip = clip
        self.random_state = random_state
        self.device = device
        self.seconds: Dict[str, float] = {}

    def __call__(self, x) -> Dict[str, np.ndarray]:
        device = resolve_device(self.device)
        dense = _dense64(x)
        if self.flavor == "analytic":
            keep = (dense > 0).sum(axis=0) >= self.min_cells
            dense = dense[:, keep]
            clip = self.clip if self.clip is not None else float(np.sqrt(dense.shape[0]))
            xt = torch.from_numpy(dense.astype(np.float32)).to(device)
            return {"X": pearson_residuals(xt, self.theta, clip).cpu().numpy(),
                    "genes_kept": keep}
        return self._glm(dense, device)

    def _lap(self, name: str, device, t0: float) -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        self.seconds[name] = t - t0
        return t

    def _glm(self, dense: np.ndarray, device) -> Dict[str, np.ndarray]:
        n, g_all = dense.shape
        self.seconds = {}
        t = time.perf_counter()
        genes_ix = np.where(dense.sum(0) >= self.min_cells)[0]
        x = torch.from_numpy(dense[:, genes_ix]).to(device)
        logs = torch.where(x != 0, torch.log(x + self.gmean_eps), 0.0)
        genes_log_gmean = torch.log10(torch.exp(logs.mean(0)) - self.gmean_eps).cpu().numpy()
        del logs
        umi = x.sum(1)
        log_umi = torch.log10(umi.clamp(min=1.0))
        gene_cnt = (x > 0).sum(1).to(torch.float64)
        umi_per_gene = umi / gene_cnt.clamp(min=1)
        cell_attrs = {"umi": umi, "log_umi": log_umi, "gene": gene_cnt,
                      "log_gene": torch.log10(gene_cnt.clamp(min=1)),
                      "umi_per_gene": umi_per_gene,
                      "log_umi_per_gene": torch.log10(umi_per_gene.clamp(min=1e-12))}

        t = self._lap("attributes", device, t)
        genes_step1 = step1_genes(genes_log_gmean, self.n_genes, self.random_state)
        log_gmean_step1 = genes_log_gmean[genes_step1]
        step1 = torch.as_tensor(genes_step1, device=device)
        beta, theta = poisson_glm_theta(x[:, step1].to(torch.float32),
                                        log_umi.to(torch.float32))
        beta, theta = beta.to(torch.float64), theta.to(torch.float64).clamp(min=1e-7)
        gm1 = torch.from_numpy(log_gmean_step1).to(device)
        dispersion = torch.log10(1 + 10 ** gm1 / theta)
        pars = torch.cat([beta, dispersion[:, None]], dim=1)  # Intercept, log_umi, disp

        t = self._lap("glm_theta", device, t)
        pars_h = pars.cpu().numpy()
        outliers = np.zeros(len(genes_step1), bool)
        for j in range(pars_h.shape[1]):
            outliers |= is_outlier(pars_h[:, j], log_gmean_step1)
        keep1 = ~outliers
        pars = pars[torch.as_tensor(keep1, device=device)]
        genes_step1, log_gmean_step1 = genes_step1[keep1], log_gmean_step1[keep1]

        t = self._lap("outliers", device, t)
        full, theta_full = sct_regularize(pars, log_gmean_step1, genes_log_gmean,
                                          self.bw_adjust)
        t = self._lap("regularize", device, t)
        resid = sct_residuals(x, full, theta_full, log_umi)
        out = torch.zeros((n, g_all), dtype=torch.float32, device=device)
        out[:, torch.as_tensor(genes_ix, device=device)] = resid.to(torch.float32)
        self._lap("residuals", device, t)

        full, theta_full, pars = (t.cpu().numpy() for t in (full, theta_full, pars))

        def full_len(vals, idx):
            a = np.full(g_all, np.nan)
            a[genes_ix[idx]] = vals
            return a

        all_idx = np.arange(len(genes_ix))
        var = {}
        for j, name in enumerate(("Intercept", "log_umi")):
            var[name + "_sct"] = full_len(full[:, j], all_idx)
            var[name + "_step1_sct"] = full_len(pars[:, j], genes_step1)
        var["theta_sct"] = full_len(theta_full, all_idx)
        var["dispersion_step1_sct"] = full_len(pars[:, 2], genes_step1)
        var["genes_step1_sct"] = full_len(np.ones(len(genes_step1)), genes_step1)
        var["log10_gmean_sct"] = full_len(genes_log_gmean, all_idx)
        obs = {name + "_sct": vals.cpu().numpy() for name, vals in cell_attrs.items()}
        return {"X": out.cpu().numpy(), "var": var, "obs": obs}


class ScTransformR:
    """Seurat's ``SCTransform(vst.flavor="v2")`` in an embedded R session
    (counterpart: normalize.py:384). The card's machine has neither R nor
    rpy2, so the port raises; :class:`ScTransform` needs neither."""

    def __init__(self, min_cells: int = 5, mirror_index: int = -1):
        self.min_cells = min_cells
        self.mirror_index = mirror_index

    def __call__(self, x):
        raise NotImplementedError("ScTransformR drives R through rpy2, which the port does not "
                                  "depend on; use ScTransform")


@register_preprocessor("normalize")
@add_mod_and_transform
class Log1P(AnnDataTransform):
    """``log(1 + x)`` (counterpart: normalize.py:462, ``sc.pp.log1p``): of an
    array, returned; of a port ``Data``, in place, as JAX's
    ``AnnDataTransform``."""

    def __init__(self, base: Optional[float] = None, **kwargs):
        super().__init__("sc.pp.log1p", base=base, **kwargs)
        self.base = base

    def __call__(self, x):
        if isinstance(x, BaseData):
            return super().__call__(x)
        return pp.log1p(x, base=self.base)


@register_preprocessor("normalize")
@add_mod_and_transform
class NormalizeTotal(AnnDataTransform):
    """Each cell scaled to ``target_sum`` counts; ``max_fraction < 1``
    leaves the genes above that share of a cell out of the size factors
    (counterpart: normalize.py:471, ``sc.pp.normalize_total``): of an
    array, returned; of a port ``Data``, in place, as JAX's
    ``AnnDataTransform``."""

    def __init__(self, target_sum: Optional[float] = None, max_fraction: float = 0.05,
                 **kwargs):
        super().__init__("sc.pp.normalize_total", target_sum=target_sum,
                         exclude_highly_expressed=max_fraction < 1.0,
                         max_fraction=max_fraction, **kwargs)
        self.target_sum = target_sum
        self.max_fraction = max_fraction

    def __call__(self, x):
        if isinstance(x, BaseData):
            return super().__call__(x)
        return pp.normalize_total(x, target_sum=self.target_sum,
                                  exclude_highly_expressed=self.max_fraction < 1.0,
                                  max_fraction=self.max_fraction)


@register_preprocessor("normalize")
@add_mod_and_transform
class NormalizePlaceHolder(BaseTransform):
    """The identity (counterpart: normalize.py:486), of an array or a port
    ``Data``."""

    def __call__(self, x):
        return x


@register_preprocessor("normalize")
class UpdateSizeFactors(BaseTransform):
    """``(n_counts, size_factors)``: each cell's total and that over the
    median total (counterpart: normalize.py:498); on a port ``Data``, both
    written to ``obs`` as JAX's."""

    def __call__(self, x):
        if isinstance(x, BaseData):
            obs = x.data.obs
            obs["n_counts"], obs["size_factors"] = self(x.data.X)
            return x
        counts = np.asarray(x.sum(axis=1)).ravel()
        return counts, counts / np.median(counts)


@register_preprocessor("normalize")
@add_mod_and_transform
class NormalizeTotalLog1P(BaseTransform):
    """:class:`NormalizeTotal` then :class:`Log1P` (counterpart:
    normalize.py:514), of an array or, in place, of a port ``Data``."""

    _DISPLAY_ATTRS = ("base", "target_sum", "max_fraction")

    def __init__(self, base: Optional[float] = None, target_sum: Optional[float] = None,
                 max_fraction: float = 0.05, **kwargs):
        super().__init__(**kwargs)
        self.base = base
        self.target_sum = target_sum
        self.max_fraction = max_fraction
        self._normalize = NormalizeTotal(target_sum=target_sum, max_fraction=max_fraction)
        self._log1p = Log1P(base=base)

    def __call__(self, x):
        return self._log1p(self._normalize(x))


__all__ = ["ColumnSumNormalize", "Log1P", "NormalizePlaceHolder", "NormalizeTotal",
           "NormalizeTotalLog1P", "ScTransform", "ScTransformR", "UpdateSizeFactors",
           "gmean", "is_outlier", "kernel_reg_ll", "pearson_residuals", "poisson_glm_theta",
           "robust_scale_binned", "sct_regularize", "sct_residuals", "step1_genes",
           "tfidf", "tfidfTransform", "theta_ml", "theta_ml_vec"]
