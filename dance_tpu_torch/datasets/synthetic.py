"""Synthetic single-cell data generators for tests and the card's smoke run
(counterpart: dance_tpu/datasets/synthetic.py).

Negative-binomial-like expression with planted cell-type structure (marker
genes per type), wrapped in the port's containers. Each generator draws
from numpy's ``default_rng`` in JAX's order, so its arrays equal JAX's bit
for bit; the frames are the port's :class:`~dance_tpu_torch.data.Frame`\\ s
where JAX's are pandas DataFrames.
"""

from types import SimpleNamespace

import numpy as np

from dance_tpu_torch.data import AnnData, Data, Frame, MuData
from dance_tpu_torch.datasets.singlemodality import cell_label_to_df


def synthetic_expression(n_cells: int = 500, n_genes: int = 200, n_types: int = 4,
                         marker_frac: float = 0.1, effect: float = 4.0, seed: int = 0,
                         library_scale: float = 1.0):
    """Poisson counts with per-type marker gene upregulation. Returns (X, labels)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_types, n_cells)
    base_rate = rng.gamma(2.0, 0.5, n_genes)
    n_markers = max(int(n_genes * marker_frac), 1)
    marker_sets = [rng.choice(n_genes, n_markers, replace=False) for _ in range(n_types)]
    rates = np.tile(base_rate, (n_cells, 1))
    for t in range(n_types):
        rows = np.nonzero(labels == t)[0]
        rates[np.ix_(rows, marker_sets[t])] *= effect
    lib = rng.lognormal(0, 0.3, n_cells)[:, None] * library_scale
    x = rng.poisson(rates * lib).astype(np.float32)
    return x, labels


def annotation_data(n_cells: int = 500, n_genes: int = 200, n_types: int = 4,
                    train_frac: float = 0.7, seed: int = 0) -> Data:
    """Data shaped like a cell-type annotation dataset: multi-hot
    ``obsm["cell_type"]`` labels and train/test splits."""
    x, labels = synthetic_expression(n_cells, n_genes, n_types, seed=seed)
    idx_to_label = [f"type{i}" for i in range(n_types)]
    names = [idx_to_label[i] for i in labels]
    adata = AnnData(x, obs={"cell_type": names},
                    var=Frame(index=[f"g{i}" for i in range(n_genes)]))
    adata.obsm["cell_type"] = cell_label_to_df(names, idx_to_label, index=adata.obs.index)
    n_train = int(n_cells * train_frac)
    return Data(adata, train_size=n_train, val_size=0, test_size=-1)


def clustering_data(n_cells: int = 400, n_genes: int = 150, n_types: int = 3,
                    seed: int = 0) -> Data:
    """Data shaped like a clustering dataset: ``obsm["Group"]`` labels."""
    x, labels = synthetic_expression(n_cells, n_genes, n_types, seed=seed)
    adata = AnnData(x)
    adata.obsm["Group"] = labels
    return Data(adata, train_size="all")


def imputation_data(n_cells: int = 300, n_genes: int = 120, seed: int = 0,
                    train_frac: float = 0.9) -> Data:
    x, _ = synthetic_expression(n_cells, n_genes, 3, seed=seed)
    data = Data(AnnData(x))
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_cells)
    n_train = int(n_cells * train_frac)
    data.set_split_idx("train", sorted(perm[:n_train].tolist()))
    data.set_split_idx("test", sorted(perm[n_train:].tolist()))
    return data


def multimodal_data(n_cells: int = 300, n_genes: int = 150, n_prot: int = 30,
                    n_types: int = 3, seed: int = 0) -> Data:
    """Paired GEX/ADT MuData with shared latent cell-type structure."""
    rng = np.random.default_rng(seed)
    x1, labels = synthetic_expression(n_cells, n_genes, n_types, seed=seed)
    # shared per-cell continuous factors, so that the two modalities
    # correspond cell by cell and not only by cluster
    n_factors = 4
    factors = rng.standard_normal((n_cells, n_factors))
    load1 = rng.standard_normal((n_factors, n_genes)) * 0.3
    load2 = rng.standard_normal((n_factors, n_prot)) * 0.3
    x1 = rng.poisson(np.maximum(x1 * np.exp(factors @ load1), 0)).astype(np.float32)
    proj = rng.gamma(1.5, 1.0, (n_types, n_prot))
    rates = proj[labels] * np.exp(factors @ load2)
    x2 = rng.poisson(rates).astype(np.float32)
    obs = Frame({"cell_type": [f"type{i}" for i in labels],
                 "batch": rng.choice(["s1", "s2"], n_cells)})
    m1 = AnnData(x1, obs=obs.copy())
    m2 = AnnData(x2, obs=obs.copy())
    md = MuData({"mod1": m1, "mod2": m2}, obs=obs)
    n_train = int(n_cells * 0.7)
    return Data(md, train_size=n_train, val_size=0, test_size=-1)


def spatial_data(n_spots: int = 300, n_genes: int = 120, n_domains: int = 3,
                 seed: int = 0) -> Data:
    """Spatial spots on a grid with spatially-contiguous domains."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n_spots)))
    xy = np.array([(i, j) for i in range(side) for j in range(side)])[:n_spots]
    domains = (xy[:, 0] * n_domains // side).astype(int)
    x, _ = synthetic_expression(n_spots, n_genes, n_domains, seed=seed)
    # reorder cells so planted types align with spatial domains
    x_sorted = np.zeros_like(x)
    _, labels = synthetic_expression(n_spots, n_genes, n_domains, seed=seed)
    for d in range(n_domains):
        src = np.nonzero(labels == d)[0]
        dst = np.nonzero(domains == d)[0]
        m = min(len(src), len(dst))
        x_sorted[dst[:m]] = x[src[:m]]
    adata = AnnData(x_sorted, obs={"domain": domains})
    adata.obsm["spatial"] = xy.astype(np.float32)
    adata.obsm["spatial_pixel"] = (xy * 10).astype(np.float32)
    adata.uns["image"] = rng.random((side * 10 + 20, side * 10 + 20, 3)).astype(np.float32)
    return Data(adata, train_size="all")


def deconvo_data(n_spots: int = 60, n_genes: int = 80, n_types: int = 3,
                 n_ref_cells: int = 150, mix_scale: float = 3.0, seed: int = 0):
    """Synthetic deconvolution bundle (a namespace): pseudo-spot mixtures
    over planted cell-type profiles. Fields: ``profiles_df`` (genes x types,
    a Frame), ``profiles`` (types x genes), ``x_mix``/``portions``/``spatial``
    (spots), ``x_ref``/``labels`` (reference cells), ``n_types``."""
    rng = np.random.default_rng(seed)
    x_ref, labels = synthetic_expression(n_ref_cells, n_genes, n_types,
                                         seed=seed + 1, effect=6.0)
    profiles = np.stack([x_ref[labels == c].mean(0) for c in range(n_types)])
    portions = rng.dirichlet(np.ones(n_types), n_spots)
    x_mix = rng.poisson(portions @ profiles * mix_scale).astype(np.float32)
    spatial = rng.random((n_spots, 2)).astype(np.float32)
    profiles_df = Frame(profiles.T, columns=[f"ct{i}" for i in range(n_types)])
    return SimpleNamespace(profiles_df=profiles_df, profiles=profiles,
                           x_mix=x_mix, portions=portions.astype(np.float32),
                           spatial=spatial, x_ref=x_ref, labels=labels,
                           n_types=n_types)


__all__ = ["annotation_data", "clustering_data", "deconvo_data", "imputation_data",
           "multimodal_data", "spatial_data", "synthetic_expression"]
