"""Shared inputs of the dance_tpu_torch tests; imports no JAX, so the card's
tests (test_torch_cuda.py) can use it where JAX is not installed.

Importing it caps torch's CPU threads at one. pytest-xdist runs several
workers, and each collects every test file, so each worker imports this
module before its first test. Torch otherwise sizes its OpenMP pool to every
core in each worker, and the workers' pools oversubscribe the CPU: one
STAGATE fit took 3.3 s alone and 1,040 s with six copies running at once
on 8 cores, and 4 s each with one thread.
"""

import numpy as np
import scipy.sparse as sp
import torch

from dance_tpu_torch.ops import bsr as tbsr

torch.set_num_threads(1)


def _adj(n, m, density, seed, empty_rows=()):
    """Random sparse matrix; the listed row ranges are emptied so that whole
    block-rows have no tiles."""
    adj = sp.random(n, m, density=density, random_state=seed, format="lil",
                    dtype=np.float32)
    for lo, hi in empty_rows:
        adj[lo:hi] = 0
    return sp.csr_matrix(adj)


CASES = {
    "square_with_empty_block_rows": lambda: _adj(400, 400, 0.02, 0, [(128, 256)]),
    "rectangular": lambda: _adj(300, 200, 0.05, 1),
    "exact_blocks_dense": lambda: _adj(256, 384, 0.3, 2),
}


def no_pad(bsr: tbsr.BSRMatrix) -> tbsr.BSRMatrix:
    """The same matrix without the all-zero pad tiles bsr_from_scipy adds:
    the CUDA kernel must not need them."""
    keep = torch.nonzero(bsr.tiles.abs().sum(dim=(1, 2)) != 0).ravel()
    rows = bsr.block_rows[keep]
    return tbsr.BSRMatrix(bsr.tiles[keep].contiguous(), rows, bsr.block_cols[keep],
                          tbsr._rowptr(rows, bsr.shape[0] // bsr.block), bsr.shape)


# tiles of each block-row of skewed_bsr: one long row, short ones, empty ones
SKEWED_ROW_TILES = (2, 110, 0, 1, 2, 0, 1)


def skewed_bsr(seed: int = 0, n_bcols: int = 120) -> tbsr.BSRMatrix:
    """A tiling as skewed as a bipartite cell-gene graph's: one block-row of
    110 tiles, the others 0-2, and no pad tiles. Tiles are 10 % dense with
    standard-normal values; each row's block-columns are distinct and
    sorted."""
    rng = np.random.default_rng(seed)
    blk = tbsr.BLOCK
    rows = np.repeat(np.arange(len(SKEWED_ROW_TILES)), SKEWED_ROW_TILES)
    cols = np.concatenate([np.sort(rng.choice(n_bcols, n, replace=False))
                           for n in SKEWED_ROW_TILES])
    tiles = rng.standard_normal((len(rows), blk, blk)) * (rng.random((len(rows), blk, blk)) < 0.1)
    rows_t = torch.from_numpy(rows.astype(np.int32))
    return tbsr.BSRMatrix(torch.from_numpy(tiles.astype(np.float32)), rows_t,
                          torch.from_numpy(cols.astype(np.int32)),
                          tbsr._rowptr(rows_t, len(SKEWED_ROW_TILES)),
                          (len(SKEWED_ROW_TILES) * blk, n_bcols * blk))


def signed(adj: sp.csr_matrix) -> sp.csr_matrix:
    """Weights shifted to [-0.5, 0.5), zeros dropped: negative weights make a
    max aggregation's masking of empty slots matter."""
    adj = adj.copy()
    adj.data = adj.data - np.float32(0.5)
    adj.eliminate_zeros()
    return adj


def max_edge_case():
    """A 300 x 260 tiling with empty rows and a whole empty block-row, the
    pad tiles of bsr_from_scipy, a NaN weight, and NaN, +inf and -inf in the
    features: the max aggregation's edge semantics. Returns (bsr, h)."""
    rng = np.random.default_rng(7)
    adj = signed(_adj(300, 260, 0.05, 7, [(128, 256), (10, 12)]))
    adj = sp.lil_matrix(adj)
    adj[5, 3] = np.nan
    bsr = tbsr.bsr_from_scipy(sp.csr_matrix(adj))
    h = rng.standard_normal((bsr.shape[1], 9)).astype(np.float32)
    h[7, 0], h[8, 1], h[9, 2] = np.nan, np.inf, -np.inf
    h[:, 3] = np.inf
    return bsr, torch.from_numpy(h)


def gat_inputs(bsr: tbsr.BSRMatrix, d: int, seed: int):
    """er, el, h and an output cotangent g for the GAT ops on ``bsr``, unpadded
    (er and g one row short of the tiling, el and h two short)."""
    rng = np.random.default_rng(seed)
    n_rows, n_cols = bsr.shape[0] - 1, bsr.shape[1] - 2
    return tuple(torch.from_numpy(a.astype(np.float32)) for a in (
        rng.normal(0, 1, n_rows), rng.normal(0, 1, n_cols),
        rng.standard_normal((n_cols, d)), rng.standard_normal((n_rows, d))))


def spatial_case(n: int, d: int, seed: int, k: int = 3):
    """Structured spatial data: ``k`` domains, each a cluster of spots and a
    gene profile; returns (features, radius graph, domain labels)."""
    from dance_tpu_torch.ops.neighbors import radius_graph

    rng = np.random.default_rng(seed)
    dom = rng.integers(0, k, n)
    xy = (rng.random((n, 2)) + dom[:, None] * 2).astype(np.float32)
    x = (np.eye(k)[dom] @ rng.random((k, d)) * 4 + rng.random((n, d))).astype(np.float32)
    return x, radius_graph(xy, 0.6), dom


def dense(bsr: tbsr.BSRMatrix) -> np.ndarray:
    out = np.zeros(bsr.shape, np.float64)
    blk = bsr.block
    for t, r, c in zip(bsr.tiles.numpy(), bsr.block_rows.numpy(), bsr.block_cols.numpy()):
        out[r * blk:(r + 1) * blk, c * blk:(c + 1) * blk] += t
    return out


def knn_bsr(n: int = 1280, k: int = 12, seed: int = 0) -> tbsr.BSRMatrix:
    """A kNN graph as STAGATE tiles one (self-loops included, RCM-banded):
    ``n`` points uniform in the unit square, each joined to its ``k`` nearest
    (itself first), so the density is k / n, ~1 % by default."""
    rng = np.random.default_rng(seed)
    xy = rng.random((n, 2))
    d2 = ((xy[:, None, :] - xy[None]) ** 2).sum(-1)
    nbrs = np.argsort(d2, axis=1, kind="stable")[:, :k]
    adj = sp.csr_matrix((np.ones(n * k, np.float32), nbrs.ravel(), np.arange(0, n * k + 1, k)),
                        shape=(n, n))
    return tbsr.bsr_with_rcm(adj)[1]


# slots of gat_nonfinite_case's features and cotangent that hold each kind of
# value: ±inf, NaN, the card's full-payload NaN and finite values whose
# products overflow
NONFINITE = (np.inf, -np.inf, np.nan, "0x7fffffff", 3.4e38, -3.4e38)
# widths for it: d of one lane column (12), of part of a 512-column register
# chunk (130), STAGATE's (512) and one past the chunk (513)
NONFINITE_WIDTHS = (12, 130, 512, 513)


def gat_nonfinite_case(d: int = 12, seed: int = 6):
    """GAT backward inputs (bsr, er, el, h, g), unpadded, with the values of
    ``NONFINITE`` placed in h, in ḡ, and in rows and columns that have no
    edge but share stored tiles (pad tiles included): there only the plain
    version's off-edge terms carry them. The rows of block-row 1 and rows 5,
    6 have no edge; column 300 has none. The values' feature columns spread
    from the first to the last of ``d``, so that a wide d puts some past the
    first 512."""
    adj = sp.lil_matrix(_adj(400, 400, 0.02, seed, [(128, 256), (5, 7)]))
    adj[:, 300] = 0
    bsr = tbsr.bsr_from_scipy(sp.csr_matrix(adj))
    er, el, h, g = (t.numpy().copy() for t in gat_inputs(bsr, d, seed))

    def put(arr, row, col, value):
        if value == "0x7fffffff":
            arr.view(np.int32)[row, col] = 0x7FFFFFFF
        else:
            arr[row, col] = value

    col = [q * (d - 1) // (len(NONFINITE) - 1) for q in range(len(NONFINITE))]
    for q, value in enumerate(NONFINITE):
        put(h, 20 + q, col[q], value)   # columns with edges
        put(g, 40 + q, col[q], value)   # rows with edges
    put(h, 300, col[1], np.nan)         # a column without edges
    put(g, 5, col[2], np.inf)           # a row without edges
    put(g, 6, col[3], 3.4e38)
    put(g, 130, col[4], -np.inf)        # a row of a block-row with only a pad tile
    return (bsr,) + tuple(torch.from_numpy(a) for a in (er, el, h, g))


def cell_knn_bsr(n: int = 2000, dim: int = 50, k: int = 15, seed: int = 0) -> tbsr.BSRMatrix:
    """A cell kNN graph as scTAG and scDSC tile one: the gauss-weighted,
    symmetrised ``k``-NN graph of ``n`` points in ``dim`` dimensions, with
    self-loops, symmetric-normalised and RCM-banded. Uniform points in 50-D
    band poorly: ~1.3 % of the stored slots hold an edge by default."""
    from dance_tpu_torch.ops.sparse import sym_norm_adjacency
    from dance_tpu_torch.ops.neighbors import knn_graph

    pts = np.random.default_rng(seed).normal(0, 1, (n, dim)).astype(np.float32)
    _, adj_n = sym_norm_adjacency(knn_graph(pts, k, mode="gauss"))
    return tbsr.bsr_with_rcm(adj_n)[1]


def bipartite_case(n_cells: int = 6000, n_feats: int = 1000, density: float = 0.05,
                   seed: int = 7):
    """scMoGNN's kind of rectangular tilings (``bipartite_bsr``): ``f2c`` of
    47 block-rows x 8 block-columns, every tile stored, and its transpose
    ``c2f`` of 8 block-rows of 47 tiles, long enough that the work schedule
    splits them. Expression-like weights: small positive counts."""
    rng = np.random.default_rng(seed)
    a = sp.random(n_cells, n_feats, density=density, random_state=seed, format="csr",
                  dtype=np.float32)
    a.data = rng.poisson(2.0, a.data.shape).astype(np.float32) + 1.0
    return tbsr.bipartite_bsr(a)


def deconvo_case(n_ref: int = 150, n_genes: int = 80, n_types: int = 3, n_spots: int = 60,
                 seed: int = 0):
    """Reference cells and real spots for the deconvolution methods, as the
    JAX package's tests make them (tests/modules/test_spatial.py:69-80):
    negative-binomial-like counts with per-type marker genes, spots that are
    Poisson draws of Dirichlet portions of the type profiles, and spot
    coordinates in [0, 10)². Returns (x_ref, labels as strings, x_spots,
    portions, coords)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_types, n_ref)
    rates = np.tile(rng.gamma(2.0, 0.5, n_genes), (n_ref, 1))
    for t in range(n_types):
        markers = rng.choice(n_genes, max(n_genes // 10, 1), replace=False)
        rates[np.ix_(labels == t, markers)] *= 6.0
    x_ref = rng.poisson(rates * rng.lognormal(0, 0.3, (n_ref, 1))).astype(np.float32)
    profiles = np.stack([x_ref[labels == t].mean(0) for t in range(n_types)])
    portions = rng.dirichlet(np.ones(n_types), n_spots)
    x_spots = rng.poisson(portions @ profiles * 3).astype(np.float32)
    coords = (rng.random((n_spots, 2)) * 10).astype(np.float32)
    return x_ref, np.array([f"ct{t}" for t in labels]), x_spots, portions, coords


def deconvo_tilings(seed: int = 0, batch_removal=None):
    """DSTG's link graph (RCM-banded) and stdGCN's two towers under their
    shared RCM order, tiled: 300 pseudo + 900 real spots from
    :func:`deconvo_case` (400 cells, 200 genes, 4 types), the graphs built by
    the port on the CPU at the models' defaults (DSTG at k_filter 30, num_cc
    10; stdGCN's integration with ``batch_removal``, e.g. ``"combat"``).
    Returns {"dstg", "stdgcn_exp", "stdgcn_sp"} of BSR matrices."""
    from dance_tpu_torch.modules.spatial.cell_type_deconvo import dstg_preprocess
    from dance_tpu_torch.modules.spatial.cell_type_deconvo.stdgcn import build_stdgcn_adjacencies
    from dance_tpu_torch.transforms import PseudoMixture

    x_ref, labels, x_spots, _, coords = deconvo_case(400, 200, 4, 900, seed)
    inp = dstg_preprocess(x_ref, labels, x_spots, n_pseudo=300, k_filter=30, num_cc=10,
                          device="cpu")
    mix, _, _ = PseudoMixture(n_pseudo=300)(x_ref, labels)
    feat = np.log1p(np.concatenate([mix, x_spots])).astype(np.float32)
    a_exp, a_sp = build_stdgcn_adjacencies(feat, coords, 300, device="cpu",
                                           integration_batch_removal=batch_removal)
    perm, _ = tbsr.rcm_reorder(a_exp + a_sp)
    return {"dstg": tbsr.bsr_with_rcm(inp.adj)[1],
            "stdgcn_exp": tbsr.bsr_from_scipy(a_exp[perm][:, perm]),
            "stdgcn_sp": tbsr.bsr_from_scipy(a_sp[perm][:, perm])}


def heteronet_hops(n: int = 1500, dim: int = 100, hubs: int = 16, k: int = 5, seed: int = 0):
    """scHeteroNet's two hop tilings under one RCM order, with hub rows:
    ``n`` points in ``dim`` dimensions of which ``hubs`` sit near the
    origin, so that every point's ``k`` nearest neighbours are hubs and the
    hubs' rows of the symmetrised ``k``-NN graph are long; the strict
    two-hop links the points that share a hub, so most of its tiles' slots
    hold an edge (85 % at the defaults, every tile stored). Returns
    (one-hop, two-hop) BSR matrices, GCN-normalised as the model builds
    them."""
    from dance_tpu_torch.modules.single_modality.cell_type_annotation.scheteronet import (
        build_hop_adjacencies)
    from dance_tpu_torch.ops.neighbors import knn_graph

    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 1, (n, dim)).astype(np.float32)
    pts[rng.choice(n, hubs, replace=False)] *= 0.01
    _, adj = tbsr.rcm_reorder(knn_graph(pts, k, mode="connectivity"))
    return tuple(tbsr.bsr_from_scipy(a) for a in build_hop_adjacencies(adj))


def typed_counts(n: int = 160, g: int = 48, n_types: int = 3, seed: int = 0):
    """Raw counts of ``n`` cells in ``n_types`` types sharing gene programs,
    with a few genes never expressed and a few low-count cells, and the genes'
    names: ``g{k}`` in a shuffled order, so that their sorted order (where
    "g10" comes before "g2") is not their column order. Returns (float32
    counts, types, names)."""
    rng = np.random.default_rng(seed)
    types = rng.integers(0, n_types, n)
    programs = rng.gamma(1.0, 1.0, (n_types, g)) * (rng.random((n_types, g)) < 0.6)
    depth = rng.gamma(3.0, 1.0, (n, 1))
    counts = rng.poisson((programs[types] + 0.3) * depth).astype(np.float32)
    counts[:, rng.choice(g, 3, replace=False)] = 0
    counts[rng.choice(n, 2, replace=False)] = 0
    names = np.array([f"g{k}" for k in rng.permutation(g)])
    return counts, types, names


def multimodal_pair(n: int = 240, g: int = 100, p: int = 25, seed: int = 0):
    """Raw counts of ``g`` genes in 3 types and ``p`` proteins that follow
    their log1p, as the JAX package's benchmark makes the second modality
    (``log1p(x) @ w / g * 4``, ``w`` uniform). Returns (counts, proteins,
    types)."""
    rng = np.random.default_rng(seed)
    types = rng.integers(0, 3, n)
    rate = rng.gamma(0.6, 1.0, (3, g))[types] * rng.gamma(4.0, 0.25, (n, 1))
    x1 = rng.poisson(rate).astype(np.float32)
    w = rng.random((g, p)).astype(np.float32)
    return x1, (np.log1p(x1) @ w / g * 4).astype(np.float32), types


def assert_weights(got: dict, want: dict, lr: float, steps: int, skip=()) -> int:
    """Adam-trained weights of two runs from the same start: each within two
    learning rates a step (Adam moves a weight by at most about lr a step,
    even on a gradient at rounding level, as a ReLU unit at its kink gets),
    and all but 0.1 % of them (``skip`` aside) at rtol 1e-4 / atol 1e-5.
    ``got`` and ``want`` map names to numpy arrays. Returns how many were
    outside the rtol."""
    off = total = 0
    for name, ref in want.items():
        gap = np.abs(np.asarray(got[name]) - ref)
        assert gap.max() <= 2 * lr * steps, (name, float(gap.max()))
        if name not in skip:
            off += int((gap > 1e-5 + 1e-4 * np.abs(ref)).sum())
            total += ref.size
    assert off <= 1e-3 * total, (off, total)
    return off


def spatial_slide(n_rows: int = 12, n_cols: int = 10, g: int = 40, n_domains: int = 3,
                  seed: int = 0):
    """Spots on an ``n_rows`` x ``n_cols`` grid in domains (the Voronoi cells of
    random centres), Poisson counts whose rates a quarter of the genes scale
    per domain, and an H&E-like float32 image in [0, 1] whose colour and
    texture follow the domains, plus noise. Returns (counts float32, xy array
    coordinates, xy_pixel (row, column) int, image, domain)."""
    rng = np.random.default_rng(seed)
    rr, cc = np.meshgrid(np.arange(n_rows), np.arange(n_cols), indexing="ij")
    xy = np.stack([rr.ravel(), cc.ravel()], 1).astype(np.float64)
    xy_pixel = (xy * 12 + 20).astype(np.int64)
    centres = rng.random((n_domains, 2)) * [n_rows, n_cols]
    dom = ((xy[:, None, :] - centres[None]) ** 2).sum(-1).argmin(1)
    base = rng.gamma(0.8, 1.5, g)
    fold = np.exp(rng.normal(0, 1.0, (n_domains, g)) * (rng.random((n_domains, g)) < 0.25))
    counts = rng.poisson(fold[dom] * base[None] * rng.gamma(4.0, 0.25, (len(dom), 1)))
    h, w = n_rows * 12 + 40, n_cols * 12 + 40
    pr, pc = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pix_dom = ((np.stack([(pr - 20) / 12, (pc - 20) / 12], -1)[:, :, None, :]
                - centres[None, None]) ** 2).sum(-1).argmin(-1)
    colours = rng.integers(60, 230, (n_domains, 3))
    texture = 20 * np.sin(pr[..., None] / (2 + pix_dom[..., None]))
    image = colours[pix_dom] + texture + rng.normal(0, 8, (h, w, 3))
    return (counts.astype(np.float32), xy, xy_pixel,
            (np.clip(image, 0, 255) / 255).astype(np.float32), dom)


def nb_counts(n: int = 300, g: int = 200, seed: int = 0) -> np.ndarray:
    """Negative-binomial counts (size 5), float32: per gene a gamma base
    rate, per cell a lognormal depth (ScTransform's tests)."""
    rng = np.random.default_rng(seed)
    mean = rng.gamma(0.6, 2.0, g) * np.exp(rng.normal(0, 0.3, n))[:, None]
    return rng.negative_binomial(5, 5 / (5 + mean)).astype(np.float32)
