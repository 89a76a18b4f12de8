"""Dataset-to-dataset similarity (counterpart:
dance_tpu/atlas/sc_similarity/anndata_similarity.py): the cosine, Pearson,
Jaccard and Jensen-Shannon similarities of sampled cells' mean profiles
(host numpy float64, as in JAX), the pairwise metrics (MMD with an RBF
kernel, the entropic Wasserstein cost of a 100-step Sinkhorn loop,
Hausdorff, Chamfer and energy distances) on ``device`` in float32, the
Bures and spectral distances on ``device`` in float64, and the similarity
of the ``obs`` metadata.

The squared distances (:func:`pdist2`) are full float32 products whatever
the caller's TF32 flags: Hausdorff and energy take square roots of small
entries, where TF32's rounding would show. ``device`` is the CUDA card
unless the CPU is named.

Where this differs from the JAX package: ``get_anndata`` (it loads atlas
datasets by catalog id), ``extract_type_target_params`` and
``fix_yaml_string`` (PyYAML) are not ported.
"""

from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np
import scipy.sparse as sp
import torch

from dance_tpu_torch.transforms import interface
from dance_tpu_torch.utils import resolve_device


@contextmanager
def full_fp32():
    """float32 products in full float32 (no TF32) inside the block; the
    caller's setting is restored after. It sets cuBLAS's own flag
    (``torch.backends.cuda.matmul.allow_tf32``): reading the global matmul
    precision raises in torch 2.11 once a caller has set that flag."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = prev


def pdist2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances, clamped at 0 (counterpart: ``_pdist2``
    :47, at ``Precision.HIGHEST``)."""
    with full_fp32():
        cross = x @ y.T
    return torch.clamp((x ** 2).sum(1)[:, None] + (y ** 2).sum(1)[None, :] - 2 * cross, min=0.0)


def mmd_rbf(x: torch.Tensor, y: torch.Tensor, gamma: float = 1.0) -> torch.Tensor:
    """Counterpart: ``_mmd_rbf`` :53."""
    def k(a, b):
        return torch.exp(-gamma * pdist2(a, b)).mean()

    return k(x, x) + k(y, y) - 2 * k(x, y)


def sinkhorn(x: torch.Tensor, y: torch.Tensor, reg: float = 0.1,
             n_iter: int = 100) -> torch.Tensor:
    """The entropic optimal-transport cost between uniform point clouds,
    ``n_iter`` Sinkhorn steps with JAX's 1e-30 floors (counterpart:
    ``_sinkhorn`` :61)."""
    c = torch.sqrt(pdist2(x, y))
    c = c / torch.clamp(c.max(), min=1e-12)
    n, m = c.shape
    k = torch.exp(-c / reg)
    u = torch.full((n,), 1.0 / n, dtype=c.dtype, device=c.device)
    v = torch.full((m,), 1.0 / m, dtype=c.dtype, device=c.device)
    with full_fp32():
        for _ in range(n_iter):
            u = (1.0 / n) / torch.clamp(k @ v, min=1e-30)
            v = (1.0 / m) / torch.clamp(k.T @ u, min=1e-30)
    p = u[:, None] * k * v[None, :]
    return (p * c).sum()


def hausdorff(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Counterpart: ``_hausdorff`` :82."""
    d = torch.sqrt(pdist2(x, y))
    return torch.maximum(d.min(1).values.max(), d.min(0).values.max())


def chamfer(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Counterpart: ``_chamfer`` :88."""
    d = pdist2(x, y)
    return d.min(1).values.mean() + d.min(0).values.mean()


def energy(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Counterpart: ``_energy`` :94."""
    dxy = torch.sqrt(pdist2(x, y)).mean()
    dxx = torch.sqrt(pdist2(x, x)).mean()
    dyy = torch.sqrt(pdist2(y, y)).mean()
    return 2 * dxy - dxx - dyy


def sqrtm_psd(a: torch.Tensor) -> torch.Tensor:
    """The square root of a symmetric positive semi-definite matrix by its
    eigendecomposition (counterpart: ``_sqrtm_psd`` :298)."""
    w, v = torch.linalg.eigh(a)
    return (v * torch.sqrt(torch.clamp(w, min=0))) @ v.T


def _cov(x: torch.Tensor) -> torch.Tensor:
    """``np.cov(x, rowvar=False)``."""
    xc = x - x.mean(0)
    return xc.T @ xc / (x.shape[0] - 1)


class AnnDataSimilarity:
    """The similarity suite between two datasets (counterpart:
    anndata_similarity.py:101). ``adata1``/``adata2`` are port AnnDatas of
    counts; both keep the intersection of their seurat_v3 highly variable
    genes (:meth:`filter_gene`). ``compute_similarity`` averages each
    metric over ``n_runs`` draws of ``sample_size`` cells from each."""

    CONTINUOUS_METRICS = ["wasserstein", "hausdorff", "chamfer", "energy", "sinkhorn2",
                          "bures", "spectral", "mmd"]
    SAMPLED_METRICS = ["cosine", "pearson", "jaccard", "js_distance"]

    def __init__(self, adata1, adata2, sample_size: Optional[int] = None,
                 init_random_state: Optional[int] = None, n_runs: int = 10,
                 ground_truth_conf_path: Optional[str] = None,
                 adata1_name: Optional[str] = None, adata2_name: Optional[str] = None,
                 methods: Optional[List[str]] = None, tissue: str = "blood", device="auto"):
        self.origin_adata1 = adata1.copy()
        self.origin_adata2 = adata2.copy()
        self.sample_size = sample_size
        self.init_random_state = init_random_state
        self.n_runs = n_runs
        self.adata1_name = adata1_name
        self.adata2_name = adata2_name
        self.tissue = tissue
        self.device = resolve_device(device)
        self.results: Dict[str, float] = {}
        self.preprocess()

    # --- preparation ------------------------------------------------------

    def filter_gene(self, n_top_genes: int = 3000):
        """Both datasets restricted to the intersection of their
        ``n_top_genes`` seurat_v3 HVGs, after dropping the genes of fewer
        than 3 counts; datasets with fewer genes keep the plain intersection
        (counterpart: anndata_similarity.py:118)."""
        a1, a2 = self.origin_adata1, self.origin_adata2
        if min(a1.n_vars, a2.n_vars) > n_top_genes:
            hvgs = []
            for a in (a1, a2):
                interface.filter_genes(a, min_counts=3)
                interface.highly_variable_genes(a, n_top_genes=n_top_genes, flavor="seurat_v3",
                                                check_values=False)
                hvgs.append(set(np.asarray(a.var_names)[np.asarray(a.var["highly_variable"],
                                                                   bool)]))
            common = sorted(hvgs[0] & hvgs[1])
        else:
            common = sorted(set(a1.var_names) & set(a2.var_names))
        if not common:  # degenerate inputs: keep the plain intersection
            common = sorted(set(a1.var_names) & set(a2.var_names))
        self.adata1 = a1[:, np.asarray(common)]
        self.adata2 = a2[:, np.asarray(common)]
        self.common_genes = common

    def preprocess(self):
        self.filter_gene()

    @staticmethod
    def normalize_data(x) -> np.ndarray:
        """Counts to 1e4 a cell, then log1p, in float64."""
        if sp.issparse(x):
            x = np.asarray(x.todense())
        x = np.asarray(x, dtype=np.float64)
        x = x / np.maximum(x.sum(1, keepdims=True), 1e-12) * 1e4
        return np.log1p(x)

    def sample_cells(self, random_state: Optional[int] = None):
        """``size`` cells of each dataset drawn with numpy's
        ``default_rng(random_state).choice``, as JAX draws them, normalised."""
        rng = np.random.default_rng(random_state)
        size = self.sample_size or min(self.adata1.n_obs, self.adata2.n_obs)
        size = min(size, self.adata1.n_obs, self.adata2.n_obs)
        i1 = rng.choice(self.adata1.n_obs, size, replace=False)
        i2 = rng.choice(self.adata2.n_obs, size, replace=False)
        x1 = self.normalize_data(self.adata1.X)[i1]
        x2 = self.normalize_data(self.adata2.X)[i2]
        return x1, x2

    # --- metrics ----------------------------------------------------------

    def cosine_sim_sampled(self, x1, x2) -> float:
        a = x1.mean(0)
        b = x2.mean(0)
        return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-12))

    def pearson_corr_sampled(self, x1, x2) -> float:
        return float(np.corrcoef(x1.mean(0), x2.mean(0))[0, 1])

    def jaccard_sim_sampled(self, x1, x2, threshold: float = 0.5) -> float:
        a = (x1 > threshold).any(0)
        b = (x2 > threshold).any(0)
        union = np.logical_or(a, b).sum()
        return float(np.logical_and(a, b).sum() / max(union, 1))

    def js_divergence_sampled(self, x1, x2) -> float:
        p = x1.mean(0) + 1e-12
        q = x2.mean(0) + 1e-12
        p, q = p / p.sum(), q / q.sum()
        m = (p + q) / 2

        def kl(a, b):
            return float((a * np.log(a / b)).sum())

        return 1.0 - 0.5 * (kl(p, m) + kl(q, m))  # the similarity form

    def _f32(self, x) -> torch.Tensor:
        return torch.from_numpy(np.asarray(x, np.float32)).to(self.device)

    def _f64(self, x) -> torch.Tensor:
        return torch.from_numpy(np.asarray(x, np.float64)).to(self.device)

    def compute_mmd(self, x1, x2) -> float:
        return float(mmd_rbf(self._f32(x1), self._f32(x2), 1.0 / max(x1.shape[1], 1)))

    def wasserstein_dist(self, x1, x2) -> float:
        return float(sinkhorn(self._f32(x1), self._f32(x2), reg=0.05))

    def get_Hausdorff(self, x1, x2) -> float:
        return float(hausdorff(self._f32(x1), self._f32(x2)))

    def chamfer_distance(self, x1, x2) -> float:
        return float(chamfer(self._f32(x1), self._f32(x2)))

    def energy_distance_metric(self, x1, x2) -> float:
        return float(energy(self._f32(x1), self._f32(x2)))

    def get_sinkhorn2(self, x1, x2) -> float:
        return float(sinkhorn(self._f32(x1), self._f32(x2), reg=0.1))

    def bures_distance(self, x1, x2) -> float:
        a, b = self._f64(x1), self._f64(x2)
        eye = torch.eye(a.shape[1], dtype=torch.float64, device=self.device)
        c1 = _cov(a) + 1e-6 * eye
        c2 = _cov(b) + 1e-6 * eye
        s1 = sqrtm_psd(c1)
        cross = sqrtm_psd(s1 @ c2 @ s1)
        return float(torch.trace(c1) + torch.trace(c2) - 2 * torch.trace(cross))

    def spectral_distance(self, x1, x2, k: int = 10) -> float:
        a, b = self._f64(x1), self._f64(x2)
        s1 = torch.linalg.svdvals(a - a.mean(0))[:k]
        s2 = torch.linalg.svdvals(b - b.mean(0))[:k]
        n = min(len(s1), len(s2))
        return float(torch.linalg.norm(s1[:n] - s2[:n]))

    def common_genes_num(self) -> int:
        return len(self.common_genes)

    def get_dataset_meta_sim(self) -> float:
        """The similarity of the ``obs`` columns the two share: one minus
        the relative gap of the means of a numeric column, the Jaccard
        index of the values of any other (counterpart: :216)."""
        obs1, obs2 = self.origin_adata1.obs, self.origin_adata2.obs
        common_cols = [c for c in obs1.columns if c in obs2.columns]
        if not common_cols:
            return 0.0
        sims = []
        for c in common_cols:
            v1, v2 = np.asarray(obs1[c]), np.asarray(obs2[c])
            if v1.dtype.kind in "biufc":
                m1, m2 = float(v1.mean()), float(v2.mean())
                denom = max(abs(m1), abs(m2), 1e-12)
                sims.append(1.0 - abs(m1 - m2) / denom)
            else:
                s1, s2 = set(v1.astype(str)), set(v2.astype(str))
                sims.append(len(s1 & s2) / max(len(s1 | s2), 1))
        return float(np.mean(sims))

    # --- the suite --------------------------------------------------------

    def compute_similarity(self, methods: Optional[List[str]] = None) -> Dict[str, float]:
        methods = methods or (self.SAMPLED_METRICS + ["mmd", "wasserstein", "hausdorff",
                                                      "chamfer", "energy", "sinkhorn2",
                                                      "spectral", "metadata_sim"])
        dispatch = {
            "cosine": self.cosine_sim_sampled,
            "pearson": self.pearson_corr_sampled,
            "jaccard": self.jaccard_sim_sampled,
            "js_distance": self.js_divergence_sampled,
            "mmd": self.compute_mmd,
            "wasserstein": self.wasserstein_dist,
            "hausdorff": self.get_Hausdorff,
            "chamfer": self.chamfer_distance,
            "energy": self.energy_distance_metric,
            "sinkhorn2": self.get_sinkhorn2,
            "bures": self.bures_distance,
            "spectral": self.spectral_distance,
        }
        out: Dict[str, List[float]] = {m: [] for m in methods}
        base = self.init_random_state if self.init_random_state is not None else 0
        for run in range(self.n_runs):
            x1, x2 = self.sample_cells(base + run)
            for m in methods:
                if m == "metadata_sim":
                    out[m].append(self.get_dataset_meta_sim())
                elif m == "common_genes_num":
                    out[m].append(self.common_genes_num())
                else:
                    out[m].append(dispatch[m](x1, x2))
        self.results = {m: float(np.mean(v)) for m, v in out.items()}
        return self.results

    def get_similarity_matrix_A2B(self, methods: Optional[List[str]] = None):
        return self.compute_similarity(methods)


__all__ = ["AnnDataSimilarity", "chamfer", "energy", "full_fp32", "hausdorff", "mmd_rbf",
           "pdist2", "sinkhorn", "sqrtm_psd"]
