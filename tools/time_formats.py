"""Time one graph layer's message passing, forward + backward, in each
adjacency format a model can take, on the tilings chip_smoke.py builds, and
print the format that ``use_bsr="auto"`` picks for each with the port's
defaults (``dance_tpu_torch.ops.bsr.DENSE_THRESHOLD``, ``DENSE_OCCUPANCY``,
``MAX_EXPANSION``).

    python3 tools/time_formats.py        # on a machine with a CUDA card

The formats of a sum: CSR (``spmm``: gather and ``index_add_``), DenseAdj
(one cuBLAS float32 product) and BSR (#1, ``csrc/bsr_spmm.cu``), each timed
as ``spmm(adj, h)`` and its backward ``Aᵀḡ`` at the model's width. The
tilings: scDeepSort's off-diagonal cell-gene graph (d = 256), graph-sc's
graph (d = 200), scTAG's and scDSC's RCM-banded cell kNN graphs (d = 128 and
512), scMoGNN's cell x feature matrix ``f2c`` and its transpose ``c2f`` (d =
48 and 96), DSTG's RCM-banded link graph (d = 32), stdGCN's two towers
under the RCM order of their sum (d = 256; the pick is the rule's on that
sum, as the model asks it), with the spatial tower under its own order
beside them, and scHeteroNet's one-hop and strict two-hop adjacencies under
the RCM order of its 5-NN graph (d = 64 and 128; the pick is the per-hop
rule, no reorder, once the graph went BSR). STAGATE's GAT layer (d = 512) is timed on CSR (``edge_softmax``)
against the fused kernels (#4 forward, #5 backward). Two sweeps on 16,384 x
16,384 matrices bracket the crossovers: random tiles at a 2 % fill covering
a share of the 128 x 128 tile grid from 0.2 to 1 (dense against BSR, by
occupancy), and 16 edges a row within a band of growing width (BSR against
CSR, by expansion), at d = 48 and 256. Each time is the median of 20
synchronised runs (``chip_smoke.median_ms``), TF32 off.

Prints one row per case and writes them to
``chiprun_out/time_formats.json``. Imports no JAX.
"""
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import numpy as np
import scipy.sparse as sp
import torch

import chip_smoke as cs
from dance_tpu_torch.ops import bsr
from dance_tpu_torch.ops.segment import spmm
from dance_tpu_torch.ops.sparse import csr_from_scipy, dense_adj_from_scipy, sym_norm_adjacency

SWEEP_N = 16384
SWEEP_OCCUPANCY = (0.2, 0.4, 0.6, 0.8, 1.0)  # share of the tile grid stored
SWEEP_BANDS = (256, 1024, 2048, 4096, 8192)  # band widths, 16 edges a row
SWEEP_WIDTHS = (48, 256)


def tiled_random(n: int, share: float, fill: float, seed: int) -> sp.csr_matrix:
    """``share`` of the (n / 128)² tiles, chosen at random (at least one per
    block-row), each with ``fill`` of its slots nonzero."""
    rng = np.random.default_rng(seed)
    nb, blk = n // bsr.BLOCK, bsr.BLOCK
    grid = rng.random((nb, nb)) < share
    grid[np.arange(nb), rng.integers(0, nb, nb)] = True
    tr, tc = np.nonzero(grid)
    per = int(fill * blk * blk)
    rows = (tr[:, None] * blk + rng.integers(0, blk, (len(tr), per))).ravel()
    cols = (tc[:, None] * blk + rng.integers(0, blk, (len(tr), per))).ravel()
    a = sp.csr_matrix((rng.random(rows.size, dtype=np.float32) + 0.1, (rows, cols)),
                      shape=(n, n))
    a.sum_duplicates()
    return a


def banded(n: int, width: int, per_row: int, seed: int) -> sp.csr_matrix:
    """``per_row`` edges a row at random columns within ``width`` of the diagonal."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = np.clip(rows + rng.integers(-width // 2, width // 2 + 1, rows.size), 0, n - 1)
    a = sp.csr_matrix((rng.random(rows.size, dtype=np.float32) + 0.1, (rows, cols)),
                      shape=(n, n))
    a.sum_duplicates()
    return a


def to_format(a: sp.csr_matrix, fmt: str, device):
    if fmt == "csr":
        return csr_from_scipy(a).to(device)
    if fmt == "dense":
        return dense_adj_from_scipy(a).to(device)
    return bsr.bsr_from_scipy(a).to(device)


def sum_ms(adj, n_rows: int, n_cols: int, d: int, device) -> float:
    """``spmm(adj, h)`` forward and ``Aᵀḡ`` backward, one synchronised run."""
    gen = torch.Generator().manual_seed(0)
    h = torch.randn((n_cols, d), generator=gen).to(device).requires_grad_()
    g = torch.randn((n_rows, d), generator=gen).to(device)

    def run():
        h.grad = None
        spmm(adj, h, n_out=n_rows).backward(g)
    return cs.median_ms(run)


def agree(name: str, adjs: dict, shape, d: int, device):
    """Fail unless every format's sum agrees with the CSR route's (relative to
    its largest entry, the chip_smoke bound)."""
    h = torch.randn((shape[1], d), generator=torch.Generator().manual_seed(1)).to(device)
    ref = spmm(adjs["csr"], h, n_out=shape[0])
    for fmt, adj in adjs.items():
        rel = float((spmm(adj, h, n_out=shape[0]) - ref).abs().max() / ref.abs().max())
        if not rel <= cs.REL_BOUND:
            raise AssertionError(f"{name} d={d}: {fmt} is {rel} off the CSR sum")


def gat_ms(adj, fmt: str, d: int, device) -> float:
    """STAGATE's attention layer forward + backward (``stagate.py``'s CSR and
    fused routes, sigmoid logits, messages = the features)."""
    from dance_tpu_torch.modules.spatial.spatial_domain import stagate as st

    n = adj.shape[0]
    gen = torch.Generator().manual_seed(0)
    f = torch.randn((n, d), generator=gen).to(device).requires_grad_()
    al, ar = (torch.randn((1, d), generator=gen).mul_(0.05).to(device).requires_grad_()
              for _ in range(2))
    g = torch.randn((n, d), generator=gen).to(device)

    def run():
        for t in (f, al, ar):
            t.grad = None
        if fmt == "bsr":
            out = st._fused_gat(adj, f, al, ar, f)
        else:
            out = st._att_aggregate(adj, f, st._edge_attention(adj, f, al, ar))
        out.backward(g)
    return cs.median_ms(run)


def tilings(cuda):
    """(name, matrix as the model tiles it, matrix and reorder flag the rule
    reads, widths, the model's formats) for each tiling of chip_smoke."""
    from dance_tpu_torch.graph import Graph
    from dance_tpu_torch.modules.single_modality.clustering import (graphsc_preprocess,
                                                                    scdsc_preprocess,
                                                                    sctag_preprocess)
    from dance_tpu_torch.modules.spatial.spatial_domain import stagate_preprocess

    three = ("csr", "dense", "bsr")
    expr = sp.random(cs.N_CELLS, cs.N_GENES, density=cs.DENSITY, random_state=0,
                     dtype=np.float32, format="csr")
    rng = np.random.default_rng(0)
    g = Graph.from_cell_feature_matrix(expr, rng.random((cs.N_CELLS, 8), dtype=np.float32),
                                       rng.random((cs.N_GENES, 8), dtype=np.float32))
    off = g.adj - sp.diags(g.adj.diagonal())
    off.eliminate_zeros()
    yield "scDeepSort", off.tocsr(), off, False, (cs.DIM,), three

    counts, _ = cs.clustered_counts(cs.GSC_CELLS, cs.GSC_GENES, cs.GSC_TYPES, seed=0)
    gsc, _ = graphsc_preprocess(counts, n_top_genes=cs.GSC_HVG, device=cuda)
    yield "graph-sc", gsc.adj, gsc.adj, False, (cs.GSC_HIDDEN,), three
    inputs, _ = sctag_preprocess(counts, n_top_genes=cs.TAG_HVG, n_components=cs.TAG_PCS,
                                 n_neighbors=cs.TAG_NEIGHBORS, device=cuda)
    _, rcm = bsr.rcm_reorder(sp.csr_matrix(inputs[0]))
    yield "scTAG", sym_norm_adjacency(rcm)[1].tocsr(), inputs[0], True, (128,), ("csr", "bsr")
    inputs, _ = scdsc_preprocess(counts, n_top_genes=cs.DSC_HVG, n_neighbors=cs.DSC_NEIGHBORS,
                                 device=cuda)
    adj_n = sym_norm_adjacency(inputs[0])[1]
    yield "scDSC", bsr.rcm_reorder(adj_n)[1].tocsr(), adj_n, True, (512,), ("csr", "bsr")
    del counts, inputs

    x, _ = cs.multimodal_counts(cs.MM_CELLS, cs.MM_GENES, cs.MM_TYPES, seed=0)
    a = sp.csr_matrix(x)
    yield "scMoGNN f2c", a, a, False, (cs.MM_HIDDEN, 2 * cs.MM_HIDDEN), three
    yield "scMoGNN c2f", a.T.tocsr(), a.T.tocsr(), False, (cs.MM_HIDDEN, 2 * cs.MM_HIDDEN), three
    del x, a

    yield from deconvo_tilings(cuda)
    yield from heteronet_tilings()


def heteronet_tilings():
    """scHeteroNet's two hops on chip_smoke's 10,000 cells, under the RCM
    order of the 5-NN graph, at the two HetConv layers' widths."""
    from dance_tpu_torch.modules.single_modality.cell_type_annotation.scheteronet import (
        build_hop_adjacencies, scheteronet_preprocess)

    counts, types = cs.annotation_counts(cs.HN_CELLS, cs.HN_GENES, cs.HN_TYPES, cs.HN_RARE,
                                         seed=13)
    inp = scheteronet_preprocess(counts, types)
    one, two = build_hop_adjacencies(bsr.rcm_reorder(inp.graph.adj)[1])
    three = ("csr", "dense", "bsr")
    yield "scHeteroNet one-hop (RCM)", one.tocsr(), one, False, (64, 128), three
    yield "scHeteroNet strict two-hop (RCM)", two.tocsr(), two, False, (64, 128), three


def deconvo_tilings(cuda):
    """DSTG's link graph (d = 32, BSR or CSR) and stdGCN's two towers under
    the RCM order of their sum, the order the model tiles both by (d = 256;
    the rule reads the sum), and the spatial tower under its own order."""
    from dance_tpu_torch.modules.spatial.cell_type_deconvo import dstg_preprocess
    from dance_tpu_torch.modules.spatial.cell_type_deconvo.stdgcn import build_stdgcn_adjacencies

    three = ("csr", "dense", "bsr")
    x_ref, labels, x_real, _, coords = cs.deconvo_inputs(cs.DC_REF, cs.DC_GENES, cs.DC_TYPES,
                                                         cs.DC_REAL, seed=5)
    inp = dstg_preprocess(x_ref, labels, x_real, n_pseudo=cs.DC_PSEUDO, k_filter=cs.DC_K_FILTER,
                          num_cc=cs.DC_NUM_CC, device=cuda)
    yield "DSTG", bsr.rcm_reorder(inp.adj)[1].tocsr(), inp.adj, True, (32,), ("csr", "bsr")
    feat, _, _ = cs.stdgcn_inputs(x_ref, labels, x_real, coords, cs.DC_PSEUDO)
    a_exp, a_sp = build_stdgcn_adjacencies(feat, coords, cs.DC_PSEUDO, device=cuda)
    union = (a_exp + a_sp).tocsr()
    perm, _ = bsr.rcm_reorder(union)
    yield "stdGCN expression (union RCM)", a_exp[perm][:, perm].tocsr(), union, True, (256,), three
    yield "stdGCN spatial (union RCM)", a_sp[perm][:, perm].tocsr(), union, True, (256,), three
    yield "stdGCN spatial (own RCM)", bsr.rcm_reorder(a_sp)[1].tocsr(), a_sp, True, (256,), three


def main() -> int:
    if not torch.cuda.is_available():
        print("time_formats: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda")
    print(cs.card_line(), flush=True)
    print(f"defaults: dense_threshold {bsr.DENSE_THRESHOLD}, dense_occupancy "
          f"{bsr.DENSE_OCCUPANCY}, max_expansion {bsr.MAX_EXPANSION}", flush=True)
    t_start = time.perf_counter()
    rows = []

    def report(name, a, rule_adj, reorder, d, times, kind="sum"):
        n, m = a.shape
        density = a.nnz / (n * m)
        expansion = bsr.tile_expansion(a)
        pick = bsr.choose_adj_format(rule_adj, device=cuda, reorder=reorder)
        if "dense" not in times:  # a model without a dense route: the BSR-or-CSR step
            pick = "bsr" if bsr.resolve_use_bsr("auto", rule_adj, device=cuda,
                                                reorder=reorder) else "csr"
        fastest = min(times, key=times.get)
        row = {"tiling": name, "kind": kind, "shape": [n, m], "nnz": int(a.nnz),
               "density": density, "expansion": expansion, "occupancy": expansion * density,
               "d": d, "ms": times, "fastest": fastest, "pick": pick}
        rows.append(row)
        print(f"{name} {kind} d={d}: {n} x {m}, {a.nnz} edges, density {density!r}, expansion "
              f"{expansion!r}, occupancy {expansion * density!r}; "
              + ", ".join(f"{f} {ms!r} ms" for f, ms in times.items())
              + f"; fastest {fastest}, auto picks {pick}"
              + ("" if pick == fastest else f" ({times[pick] / times[fastest]!r} x the fastest)"),
              flush=True)

    for name, a, rule_adj, reorder, widths, formats in tilings(cuda):
        adjs = {f: to_format(a, f, cuda) for f in formats}
        for d in widths:
            times = {f: sum_ms(adj, a.shape[0], a.shape[1], d, cuda) for f, adj in adjs.items()}
            agree(name, adjs, a.shape, d, cuda)
            report(name, a, rule_adj, reorder, d, times)
        del adjs
        torch.cuda.empty_cache()

    # STAGATE's GAT layer: CSR edge softmax against #4 + #5
    counts, xy, _ = cs.spatial_counts(cs.N_SPOTS, cs.N_RAW_GENES, cs.N_DOMAINS, seed=0)
    from dance_tpu_torch.modules.spatial.spatial_domain import stagate_preprocess
    _, adj = stagate_preprocess(counts, xy, n_top_genes=cs.N_HVG, model_name="knn",
                                n_neighbors=cs.N_NEIGHBORS)
    adj = sp.csr_matrix(adj) + sp.eye(adj.shape[0], format="csr", dtype=np.float32)
    _, rcm = bsr.rcm_reorder(adj)
    times = {f: gat_ms(to_format(rcm, f, cuda), f, cs.STAGATE_DIMS[1], cuda)
             for f in ("csr", "bsr")}
    report("STAGATE", rcm.tocsr(), adj, True, cs.STAGATE_DIMS[1], times, kind="gat")

    # the sweeps: dense against BSR by occupancy, BSR against CSR by expansion
    sweeps = [(f"tiles {share}", tiled_random(SWEEP_N, share, 0.02, seed=1))
              for share in SWEEP_OCCUPANCY]
    sweeps += [(f"band {w}", banded(SWEEP_N, w, 16, seed=2)) for w in SWEEP_BANDS]
    for name, a in sweeps:
        adjs = {f: to_format(a, f, cuda) for f in ("csr", "dense", "bsr")}
        for d in SWEEP_WIDTHS:
            times = {f: sum_ms(adj, a.shape[0], a.shape[1], d, cuda) for f, adj in adjs.items()}
            report(name, a, a, False, d, times)
        del adjs
        torch.cuda.empty_cache()
    print(f"time_formats: {time.perf_counter() - t_start:.3f} s", flush=True)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "time_formats.json").write_text(json.dumps({"card": cs.card_line(), "rows": rows},
                                                      indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
