"""The preprocessing utilities of the multimodal and legacy pipelines on
arrays (counterpart: dance_tpu/transforms/preprocess.py): TF-IDF and LSI
(``tfidfTransformer`` :16, ``lsiTransformer`` :41), the imputation mask
helper ``MaskedArray`` (:82), the subgraph samplers (``SubgraphSampler``,
``SAINTSampler``, ``SAINTRandomWalkSampler`` :143-199), scDCC's
``generate_random_pair`` (:202-237), the legacy filters and normalisations
(``prefilter_cells``/``_genes``/``_specialgenes`` :244-289, ``filter_data``
:365, ``geneSelection`` :379, ``normalize_adata`` :438, ``row_normalize``
:460, ``sparse_mx_to_torch_sparse_tensor`` :469, ``load_graph`` :480,
``calculate_log_library_size`` :495) and DSTG's CCA gene helpers
(``l2norm``, ``SVD``, ``ccaEmbed``, ``sortGenes`` and ``selectTopGenes``
:292-362).

``generate_random_pair`` draws from Python's global ``random`` and numpy's
global ``np.random`` as the JAX function does, making the same calls in the
same order, so after ``random.seed(s)`` and ``np.random.seed(s)`` both give
the same pairs. ``MaskedArray`` and the samplers draw from
``np.random.default_rng(seed)`` in JAX's order: their masks and node sets are
JAX's bit for bit.

Where JAX reads or subsets an ``AnnData``, the port takes the cells x genes
matrix (and the gene names where JAX matches on them) and returns masks and
arrays:

- the ``prefilter_*`` functions return the masks of the kept cells or genes
  (``prefilter_cells`` also the log1p snapshot JAX keeps as ``raw``);
  ``filter_data`` the kept cells' mask and genes' indices;
  ``normalize_adata`` a dict of what JAX writes.
- ``lsiTransformer`` takes the counts where JAX reads ``layers["counts"]``
  and returns an array where JAX returns a DataFrame. TF-IDF and the
  normalisation run in float64 on the stored entries (JAX's sparse path; a
  dense input is taken as sparse), the truncated SVD in float32 on
  ``device`` (the CUDA card unless the CPU is named); the SVD's random start
  is a torch draw (:func:`~dance_tpu_torch.ops.linalg.randomized_svd`).
- ``load_graph`` takes the edge array where JAX reads a file, and returns
  the port's :class:`~dance_tpu_torch.ops.sparse.CSRMatrix`;
  ``sparse_mx_to_torch_sparse_tensor`` returns a torch sparse COO tensor.

The CCA helpers take genes x spots arrays where the JAX package takes pandas
frames, and name genes and spots by their row and column indices. Where
this differs from the JAX package:

- Genes with equal loadings are ranked by gene index; JAX's
  ``sort_values`` leaves them in pandas' order.
- :func:`selectTopGenes` returns the sorted gene indices; JAX returns
  ``list(set(...))`` of names, whose order follows string hashes and
  changes from process to process.
"""

import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch
from scipy.stats import expon

from dance_tpu_torch.ops.linalg import randomized_svd
from dance_tpu_torch.ops.segment import segment_sum_csr
from dance_tpu_torch.ops.sparse import CSRMatrix, csr_from_scipy, index_order
from dance_tpu_torch.settings import logger
from dance_tpu_torch.utils import resolve_device


class tfidfTransformer:
    """TF-IDF with a fit/transform surface (counterpart: preprocess.py:16):
    ``idf = n / column sums`` from ``fit``, then each row over its sum times
    the idf. A sparse input stays sparse, as in JAX; host scipy/numpy."""

    def __init__(self):
        self.idf = None
        self.fitted = False

    def fit(self, X):
        self.idf = np.asarray(X.shape[0] / X.sum(axis=0)).ravel()
        self.fitted = True

    def transform(self, X):
        if not self.fitted:
            raise RuntimeError("Transformer was not fitted on any data")
        if sp.issparse(X):
            tf = X.multiply(1 / X.sum(axis=1))
            return sp.csr_matrix(tf.multiply(self.idf[None, :]))
        tf = X / X.sum(axis=1, keepdims=True)
        return tf * self.idf[None, :]

    def fit_transform(self, X):
        self.fit(X)
        return self.transform(X)


class lsiTransformer:
    """Latent semantic indexing of a cells x peaks count matrix
    (counterpart: preprocess.py:41): TF-IDF, each row over its L1 norm,
    ``log1p(1e4 x)``, then the truncated SVD's leading ``n_components``
    (one more with ``drop_first``, which drops the first). ``fit(counts)``,
    ``transform(counts)`` and ``fit_transform(counts)`` take the counts that
    JAX reads from ``layers["counts"]``; ``transform`` returns the (cells,
    n_components) float64 array."""

    def __init__(self, n_components: int = 20, drop_first: bool = True, device="auto"):
        self.drop_first = drop_first
        self.n_components = n_components + drop_first
        self.device = device
        self.fitted = False
        self.idf: Optional[torch.Tensor] = None
        self._components: Optional[torch.Tensor] = None

    def _normalized(self, counts) -> torch.Tensor:
        """TF-IDF, each row over its L1 norm (at least 1e-12), ``log1p(1e4
        x)``, in float64 on the stored entries, as JAX's sparse path does (an
        entry that is 0 stays 0); returned as a sparse COO tensor. Every sum
        runs in a fixed order, the same bits on every run: the row sums over
        the CSR's ``indptr``, the column sums over the sort of the column
        indices."""
        device = resolve_device(self.device)
        csr = sp.csr_matrix(counts)
        n, m = csr.shape
        indptr = torch.from_numpy(csr.indptr.astype(np.int64)).to(device)
        cols = torch.from_numpy(csr.indices.astype(np.int64)).to(device)
        v = torch.from_numpy(csr.data.astype(np.float64)).to(device)
        rows = torch.repeat_interleave(torch.arange(n, device=device), indptr.diff(),
                                       output_size=v.shape[0])
        if self.idf is None:
            perm, offsets = index_order(cols, m)
            self.idf = n / segment_sum_csr(v.index_select(0, perm), offsets)
        tf = v / segment_sum_csr(v, indptr)[rows]
        tfidf = tf * self.idf[cols]
        l1 = segment_sum_csr(tfidf.abs(), indptr)
        vals = torch.log1p(tfidf / l1.clamp(min=1e-12)[rows] * 1e4)
        return torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (n, m),
                                       check_invariants=False).coalesce()

    def fit(self, counts):
        self.idf = None
        x = self._normalized(counts).to(torch.float32).to_dense()
        _, _, vt = randomized_svd(x, self.n_components, seed=777)
        self._components = vt.to(torch.float64)
        self.fitted = True
        return self

    def transform(self, counts) -> np.ndarray:
        if not self.fitted:
            raise RuntimeError("Transformer was not fitted on any data")
        x_lsi = torch.sparse.mm(self._normalized(counts), self._components.T)
        return x_lsi[:, int(self.drop_first):].cpu().numpy()

    def fit_transform(self, counts) -> np.ndarray:
        return self.fit(counts).transform(counts)


class MaskedArray:
    """A matrix and a boolean keep mask for imputation evaluation
    (counterpart: preprocess.py:82). ``generate`` masks, in each gene with
    at least two nonzero cells, ``floor(dropout x`` their count``)`` of them
    (at most all but one), drawn without replacement from
    ``np.random.default_rng(seed)`` with weights ``expon.pdf(value, 0, 20)``
    (``"exp"``) or uniform, JAX's draws bit for bit."""

    def __init__(self, data=None, mask=None, distr: str = "exp", dropout: float = 0.01,
                 seed: int = 1):
        self.data = np.array(data)
        self._binMask = np.array(mask) if mask is not None else np.ones_like(self.data,
                                                                             dtype=bool)
        self.shape = self.data.shape
        self.distr = distr
        self.dropout = dropout
        self.seed = seed

    @property
    def binMask(self):
        return self._binMask

    @binMask.setter
    def binMask(self, value):
        self._binMask = value.astype(bool)

    def getMaskedMatrix(self):
        out = self.data.copy()
        out[~self.binMask] = 0
        return out

    def getMasked_flat(self):
        return self.data[~self.binMask]

    def copy(self):
        return MaskedArray(data=self.data.copy(), mask=self.binMask.copy(), distr=self.distr,
                           dropout=self.dropout, seed=self.seed)

    def get_probs(self, vec):
        return {"exp": expon.pdf(vec, 0, 20),
                "uniform": np.tile([1.0 / len(vec)], len(vec))}.get(self.distr)

    def get_Nmasked(self, idx):
        col = self.data[:, idx]
        dp_i = (1 + (col == 0).sum()) / self.shape[0]
        dp_f = np.exp(-2 * np.log10(max(col.mean(), 1e-12)) ** 2)
        return 1 + int((col == 0).sum() * dp_f / dp_i)

    def generate(self):
        rng = np.random.default_rng(self.seed)
        self._binMask = np.ones(self.shape, dtype=bool)
        for g in range(self.shape[1]):
            col = self.data[:, g]
            pos = np.nonzero(col)[0]
            if len(pos) < 2:
                continue
            n_mask = min(int(np.floor(self.dropout * len(pos))), len(pos) - 1)
            if n_mask == 0:
                continue
            probs = self.get_probs(col[pos])
            probs = probs / probs.sum()
            chosen = rng.choice(len(pos), n_mask, p=probs, replace=False)
            self._binMask[pos[chosen], g] = False


class SubgraphSampler:
    """A node-induced subgraph of a fixed number of nodes drawn uniformly
    without replacement (counterpart: preprocess.py:143). ``sample()``
    returns the sorted node ids and the induced scipy CSR block."""

    def __init__(self, adj, num_nodes_per_batch: int, seed: int = 0):
        self.adj = sp.csr_matrix(adj)
        self.num_nodes_per_batch = int(min(num_nodes_per_batch, self.adj.shape[0]))
        self.rng = np.random.default_rng(seed)

    def sample(self):
        n = self.adj.shape[0]
        nodes = np.sort(self.rng.choice(n, self.num_nodes_per_batch, replace=False))
        return nodes, self.adj[nodes][:, nodes]


class SAINTSampler(SubgraphSampler):
    """The random-node SAINT sampler's name (counterpart: preprocess.py:165)."""


class SAINTRandomWalkSampler(SubgraphSampler):
    """``num_roots`` random walks of ``walk_length`` steps, their nodes
    padded from the rest (or cut) to ``num_roots (walk_length + 1)``
    distinct nodes (counterpart: preprocess.py:169)."""

    def __init__(self, adj, num_roots: int, walk_length: int, seed: int = 0):
        super().__init__(adj, num_roots * (walk_length + 1), seed)
        self.num_roots = num_roots
        self.walk_length = walk_length

    def sample(self):
        n = self.adj.shape[0]
        roots = self.rng.choice(n, self.num_roots, replace=False)
        nodes = set(roots.tolist())
        frontier = roots
        for _ in range(self.walk_length):
            nxt = []
            for u in frontier:
                nbrs = self.adj.indices[self.adj.indptr[u]:self.adj.indptr[u + 1]]
                nxt.append(self.rng.choice(nbrs) if len(nbrs) else u)
            frontier = np.asarray(nxt)
            nodes.update(frontier.tolist())
        target = self.num_nodes_per_batch
        nodes = list(nodes)
        if len(nodes) < target:
            pool = np.setdiff1d(np.arange(n), np.asarray(nodes, dtype=np.int64))
            n_pad = min(target - len(nodes), len(pool))
            nodes.extend(self.rng.choice(pool, n_pad, replace=False).tolist())
        nodes = np.sort(np.asarray(nodes[:target]))
        return nodes, self.adj[nodes][:, nodes]


def generate_random_pair(y, label_cell_indx, num, error_rate=0):
    """Random must-link / cannot-link pairs from labels ``y`` over the cells
    ``label_cell_indx``: ``num`` draws of two distinct cells, a same-label
    pair a must-link (each ordered pair once) and any other a cannot-link,
    the first ``error_rate · num`` draws flipped to simulate noisy
    supervision. Returns ``(ml_ind1, ml_ind2, cl_ind1, cl_ind2,
    error_num)``, each list in a random order."""
    y = np.asarray(y)
    label_cell_indx = list(label_cell_indx)
    ml_ind1, ml_ind2, cl_ind1, cl_ind2 = [], [], [], []
    seen_ml = set()
    error_num = 0
    num0 = num
    while num > 0:
        tmp1 = random.choice(label_cell_indx)
        tmp2 = random.choice(label_cell_indx)
        if tmp1 == tmp2 or (tmp1, tmp2) in seen_ml:
            continue
        flip = error_num < error_rate * num0
        if (y[tmp1] == y[tmp2]) != flip:  # a true pair kept, or a flipped link
            ml_ind1.append(tmp1)
            ml_ind2.append(tmp2)
            seen_ml.add((tmp1, tmp2))
        else:
            cl_ind1.append(tmp1)
            cl_ind2.append(tmp2)
        if flip:
            error_num += 1
        num -= 1
    ml_ind1, ml_ind2 = np.array(ml_ind1, int), np.array(ml_ind2, int)
    cl_ind1, cl_ind2 = np.array(cl_ind1, int), np.array(cl_ind2, int)
    ml_perm = np.random.permutation(len(ml_ind1))
    cl_perm = np.random.permutation(len(cl_ind1))
    return (ml_ind1[ml_perm], ml_ind2[ml_perm], cl_ind1[cl_perm], cl_ind2[cl_perm], error_num)


def l2norm(mat) -> np.ndarray:
    """Rows over their L2 norms, float64; a row of zeros stays zeros
    (counterpart: preprocess.py:292)."""
    arr = np.asarray(mat)
    stat = np.sqrt((arr ** 2).sum(1))
    return np.divide(arr, stat[:, None], out=np.zeros_like(arr, dtype=float),
                     where=stat[:, None] != 0)


def SVD(mat, num_cc, *, device="auto"):
    """The leading ``num_cc`` singular triplets in float64 on ``device``, in
    the reference's layout ``(u, v, d)`` with ``v`` already (n, num_cc)
    (counterpart: preprocess.py:305). Signs are LAPACK's or cuSOLVER's."""
    a = torch.from_numpy(np.asarray(mat, np.float64)).to(resolve_device(device))
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    k = int(num_cc)
    return u[:, :k].cpu().numpy(), vt[:k].T.cpu().numpy(), s[:k].cpu().numpy()


def _scale_columns(a: torch.Tensor) -> torch.Tensor:
    """scikit-learn's ``scale``: each column centred and over its population
    std, a std under 10 float64 epsilons taken as 1."""
    std = a.std(0, correction=0)
    std = torch.where(std < 10 * np.finfo(np.float64).eps, 1.0, std)
    return (a - a.mean(0)) / std


def ccaEmbed(data1, data2, num_cc: int = 30, *,
             device="auto") -> Tuple[List[np.ndarray], np.ndarray]:
    """The CCA embedding of two genes x spots sets over the same genes
    (counterpart: preprocess.py:314): each spot standardised over the genes,
    the SVD of the two sets' cross-product, in float64 on ``device``.
    Returns ``([embeds, d], loadings)``: the (spots1 + spots2, num_cc)
    embedding of both sets stacked, each component's sign set so that its
    first row is not negative, the singular values, and the (genes,
    num_cc) gene loadings of the stacked sets. JAX's inner join on the gene
    names and its ``dropna`` have nothing to do on arrays of the same genes;
    a NaN raises."""
    device = resolve_device(device)
    a = torch.as_tensor(np.asarray(data1, np.float64)).to(device)
    b = torch.as_tensor(np.asarray(data2, np.float64)).to(device)
    if torch.isnan(a).any() or torch.isnan(b).any():
        raise ValueError("ccaEmbed: NaN in the inputs (JAX drops those genes)")
    u, s, vt = torch.linalg.svd(_scale_columns(a).T @ _scale_columns(b), full_matrices=False)
    k = int(num_cc)
    embeds = torch.cat([u[:, :k], vt[:k].T])
    embeds = embeds * torch.where(embeds[0] < 0, -1.0, 1.0)
    loadings = torch.cat([a, b], dim=1) @ embeds
    return [embeds.cpu().numpy(), s[:k].cpu().numpy()], loadings.cpu().numpy()


def _top_genes(loadings: np.ndarray, dim: int):
    """Gene indices by decreasing and by increasing loading on ``dim``, ties
    by gene index."""
    data = np.asarray(loadings)[:, dim]
    return np.argsort(-data, kind="stable"), np.argsort(data, kind="stable")


def sortGenes(Loadings, dim: int, numG: int) -> np.ndarray:
    """The round(numG / 2) genes of largest loading on component ``dim``,
    then as many of the smallest (counterpart: preprocess.py:338)."""
    num = int(np.round(numG / 2))
    pos, neg = _top_genes(Loadings, dim)
    return np.concatenate((pos[:num], neg[:num]))


def selectTopGenes(Loadings, dims: Sequence[int], DimGenes: int, maxGenes: int) -> np.ndarray:
    """The union over ``dims`` of :func:`sortGenes` at the largest gene count
    per component, up to ``DimGenes``, whose union stays under ``max(2
    len(dims), maxGenes)`` genes (counterpart: preprocess.py:347). Returns
    the sorted gene indices."""
    max_g = max(len(dims) * 2, maxGenes)
    orders = [_top_genes(Loadings, j) for j in dims]

    def union(num_g):
        num = int(np.round(num_g / 2))
        return set(np.concatenate([np.concatenate((pos[:num], neg[:num]))
                                   for pos, neg in orders]).tolist())

    lens = np.array([len(union(i)) for i in range(1, DimGenes + 1)])
    lens = lens[lens < max_g]
    max_per = int(np.where(lens == lens.max())[0][0]) + 1
    return np.array(sorted(union(max_per)), dtype=np.int64)


def _one_of(names, values):
    if all(v is None for v in values):
        raise ValueError(f"Provide one of {', '.join(names)}.")


def prefilter_cells(x, min_counts=None, max_counts=None, min_genes=200, max_genes=None):
    """Every given cell threshold ANDed into one mask (counterpart:
    preprocess.py:244). Returns ``(keep, raw)``: the mask and the kept
    cells' log1p, which JAX keeps as ``raw``."""
    from dance_tpu_torch.sc import pp

    _one_of(("min_counts", "min_genes", "max_counts", "max_genes"),
            (min_counts, min_genes, max_counts, max_genes))
    keep = np.ones(x.shape[0], dtype=bool)
    for kw, val in (("min_genes", min_genes), ("max_genes", max_genes),
                    ("min_counts", min_counts), ("max_counts", max_counts)):
        if val is not None:
            keep &= pp.filter_cells(x, **{kw: val})[0]
    return keep, pp.log1p(x[np.nonzero(keep)[0]])


def prefilter_genes(x, min_counts=None, max_counts=None, min_cells=10, max_cells=None):
    """Every given gene threshold ANDed into one mask (counterpart:
    preprocess.py:268)."""
    from dance_tpu_torch.sc import pp

    _one_of(("min_counts", "min_cells", "max_counts", "max_cells"),
            (min_counts, min_cells, max_counts, max_cells))
    keep = np.ones(x.shape[1], dtype=bool)
    for kw, val in (("min_cells", min_cells), ("max_cells", max_cells),
                    ("min_counts", min_counts), ("max_counts", max_counts)):
        if val is not None:
            keep &= pp.filter_genes(x, **{kw: val})[0]
    return keep


def prefilter_specialgenes(gene_names, Gene1Pattern="ERCC", Gene2Pattern="MT-"):
    """The mask of the genes whose names start with neither prefix
    (counterpart: preprocess.py:284)."""
    return np.array([not (str(n).startswith(Gene1Pattern) or str(n).startswith(Gene2Pattern))
                     for n in gene_names], dtype=bool)


def filter_data(x, highly_genes: int = 500) -> Tuple[np.ndarray, np.ndarray]:
    """The cells and genes that survive genes of at least 3 counts, cells of
    at least 1, ``normalize_per_cell``, ``log1p`` and ``highly_genes``
    cell_ranger HVGs (counterpart: preprocess.py:365, which subsets the raw
    container to them). Returns the kept cells' mask and the kept genes'
    indices into ``x``, in order."""
    from dance_tpu_torch.sc import pp

    genes = np.nonzero(pp.filter_genes(x, min_counts=3)[0])[0]
    x1 = x[:, genes]
    cells = pp.filter_cells(x1, min_counts=1)[0]
    x2, kept, _ = pp.normalize_per_cell(x1[np.nonzero(cells)[0]])
    cells[np.nonzero(cells)[0][~kept]] = False
    hv = pp.highly_variable_genes(pp.log1p(x2), flavor="cell_ranger", min_mean=0.0125,
                                  max_mean=4, min_disp=0.5,
                                  n_top_genes=highly_genes)["highly_variable"]
    return cells, genes[hv]


def geneSelection(data, threshold=0, atleast=10, yoffset=.02, xoffset=5, decay=1.5, n=None,
                  verbose=1) -> np.ndarray:
    """scGNN's dropout-curve gene selection (counterpart: preprocess.py:379):
    the genes whose zero rate passes ``exp(-decay (mean log2 expression -
    xoffset)) + yoffset``; with ``n``, ``xoffset`` bisected until ``n`` genes
    pass. Host numpy."""
    if sp.issparse(data):
        zero_rate = 1 - np.squeeze(np.asarray((data > threshold).mean(axis=0)))
        A = data.multiply(data > threshold)
        A.data = np.log2(A.data)
        mean_expr = np.full_like(zero_rate, np.nan)
        detected = zero_rate < 1
        mean_expr[detected] = (np.squeeze(np.asarray(A[:, detected].mean(axis=0)))
                               / (1 - zero_rate[detected]))
    else:
        data = np.asarray(data)
        zero_rate = 1 - (data > threshold).mean(axis=0)
        mean_expr = np.full_like(zero_rate, np.nan)
        detected = zero_rate < 1
        mask = data[:, detected] > threshold
        logs = np.full_like(data[:, detected], np.nan, dtype=float)
        logs[mask] = np.log2(data[:, detected][mask])
        mean_expr[detected] = np.nanmean(logs, axis=0)
    detected_counts = (np.squeeze(np.asarray((data > threshold).sum(axis=0)))
                       if sp.issparse(data) else (np.asarray(data) > threshold).sum(axis=0))
    low_detection = detected_counts < atleast
    zero_rate[low_detection] = np.nan
    mean_expr[low_detection] = np.nan
    nonan = ~np.isnan(zero_rate)

    def select(xoff):
        sel = np.zeros_like(zero_rate, dtype=bool)
        sel[nonan] = zero_rate[nonan] > np.exp(-decay * (mean_expr[nonan] - xoff)) + yoffset
        return sel

    if n is None:
        return select(xoffset)
    up, low = 10, 0
    for _ in range(100):
        selected = select(xoffset)
        if selected.sum() == n:
            break
        if selected.sum() < n:
            up = xoffset
            xoffset = (xoffset + low) / 2
        else:
            low = xoffset
            xoffset = (xoffset + up) / 2
    if verbose > 0:
        logger.info("Chosen offset: %.2f", xoffset)
    return selected


def normalize_adata(x, filter_min_counts=True, size_factors=True, normalize_input=True,
                    logtrans_input=True) -> Dict[str, np.ndarray]:
    """The ZINB autoencoders' recipe (counterpart: preprocess.py:438): genes
    and cells of at least one count, ``normalize_per_cell`` with size
    factors over the median total, ``log1p``, ``scale``. Returns ``X``, the
    ``raw`` counts of the kept cells and genes, ``size_factors`` and the
    masks ``cells`` and ``genes`` of what was kept."""
    from dance_tpu_torch.sc import pp

    cells, genes = np.ones(x.shape[0], bool), np.ones(x.shape[1], bool)
    if filter_min_counts:
        genes = pp.filter_genes(x, min_counts=1)[0]
        x = x[:, np.nonzero(genes)[0]]
        cells = pp.filter_cells(x, min_counts=1)[0]
        x = x[np.nonzero(cells)[0]]
    raw = x.copy()
    if size_factors:
        x, kept, n_counts = pp.normalize_per_cell(x)
        cells[np.nonzero(cells)[0][~kept]] = False
        raw = raw[np.nonzero(kept)[0]]
        sf = n_counts / np.median(n_counts)
    else:
        sf = np.ones(x.shape[0])
    if logtrans_input:
        x = pp.log1p(x)
    if normalize_input:
        x = pp.scale(x)[0]
    return {"X": x, "raw": raw, "size_factors": sf, "cells": cells, "genes": genes}


def row_normalize(mx):
    """Each row of a scipy sparse matrix over its sum, an empty row left
    empty (counterpart: preprocess.py:460)."""
    rowsum = np.asarray(mx.sum(1)).ravel()
    with np.errstate(divide="ignore"):
        r_inv = np.power(rowsum, -1.0)
    r_inv[np.isinf(r_inv)] = 0.0
    return sp.diags(r_inv).dot(mx)


def sparse_mx_to_torch_sparse_tensor(sparse_mx) -> torch.Tensor:
    """A scipy sparse matrix as a float32 torch sparse COO tensor
    (counterpart: preprocess.py:469)."""
    sparse_mx = sparse_mx.tocoo().astype(np.float32)
    indices = torch.from_numpy(np.vstack((sparse_mx.row, sparse_mx.col)).astype(np.int64))
    return torch.sparse_coo_tensor(indices, torch.from_numpy(sparse_mx.data),
                                   tuple(sparse_mx.shape))


def load_graph(edges, data) -> CSRMatrix:
    """An edge list (rows of two node ids) as the symmetric, row-normalised
    adjacency with self-loops over ``data.shape[0]`` nodes (counterpart:
    preprocess.py:480, which reads the edges from a file)."""
    n = data.shape[0]
    edges = np.asarray(edges, dtype=np.int32).reshape(-1, 2)
    adj = sp.coo_matrix((np.ones(edges.shape[0]), (edges[:, 0], edges[:, 1])), shape=(n, n),
                        dtype=np.float32)
    adj = adj + adj.T.multiply(adj.T > adj) - adj.multiply(adj.T > adj)
    adj = sp.csr_matrix(adj) + sp.eye(adj.shape[0], format="csr")
    return csr_from_scipy(sp.csr_matrix(row_normalize(adj), dtype=np.float32))


def calculate_log_library_size(Dataset) -> Tuple[np.ndarray, np.ndarray]:
    """The mean and variance of the cells' log library sizes, each as a
    (cells, 1) float64 column; a cell without reads raises (counterpart:
    preprocess.py:495)."""
    t = np.asarray(np.asarray(Dataset).sum(axis=1)).astype(np.float64).ravel()
    zero_idx = np.where(t == 0)[0]
    if zero_idx.any():
        raise ValueError(f"Cells with zero reads encountered (index up to first ten): "
                         f"{zero_idx[:10]}\nPlease perform necessary filtering to remove "
                         "trivial cells to suppress this error.")
    lib_size = np.log(t)
    n = len(t)
    return np.full((n, 1), np.mean(lib_size)), np.full((n, 1), np.var(lib_size))


__all__ = ["MaskedArray", "SAINTRandomWalkSampler", "SAINTSampler", "SVD", "SubgraphSampler",
           "calculate_log_library_size", "ccaEmbed", "filter_data", "geneSelection",
           "generate_random_pair", "l2norm", "load_graph", "lsiTransformer", "normalize_adata",
           "prefilter_cells", "prefilter_genes", "prefilter_specialgenes", "row_normalize",
           "selectTopGenes", "sortGenes", "sparse_mx_to_torch_sparse_tensor",
           "tfidfTransformer"]
