#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU: scDeepSort
training and STAGATE training.

    python3 chip_smoke.py        # from the root of the repository

What it does, in order (any failure exits non-zero, and the result line is
printed only when every phase passed):

1. Prints the card (``nvidia-smi --query-gpu=name,power.limit``), the
   torch/CUDA versions, and builds the CUDA kernels of
   ``dance_tpu_torch/csrc`` with nvcc for sm_90a (timed).
2. scDeepSort at bench width, with every kernel launch count set to 0 just
   before it: a 12,000-cell x 2,000-gene expression matrix at density 0.025
   -> ``weighted_feature_pca`` (k = 256) -> ``Graph.from_cell_feature_matrix``
   -> ``ScDeepSort(dim_in=256, dim_hid=256, num_layers=2).fit(epochs=5,
   val_ratio=0.2, use_bsr=True)`` on cuda -> ``predict``. Checks finite
   losses, output shapes and probabilities, and that the ``bsr_spmm`` kernel
   ran at least 4 x epochs times.
3. Each SpMM kernel against its plain PyTorch version on the bench tiling
   (d = 256): ``bsr_spmm`` on A and on its transpose, ``bsr_sddmm``; the max
   error of each under its stated bound; median times of kernel and plain
   version (CUDA events, synchronised around each run).
4. scDeepSort on a small graph, fitted on the card and on the CPU (the plain
   versions) from the same seed: losses and probabilities must agree.
5. STAGATE at its published width, counts set to 0 just before it: raw
   Poisson counts of 10,000 spots x 5,000 genes in 7 spatial domains,
   coordinates in [0, 100)^2 -> ``stagate_preprocess`` (seurat_v3 HVGs ->
   3,000 genes, normalize_total, log1p, 6-NN graph) -> ``Stagate(
   hidden_dims=(3000, 512, 30)).fit(epochs=50, use_bsr=True)`` on cuda ->
   ``predict`` (k-means, 7 clusters). Checks finite, falling losses, the
   embedding's shape, the labels' range, and that ``bsr_gat_stats`` and
   ``bsr_gat_grads`` ran at least 2 x epochs times and ``bsr_gat`` at least
   twice.
6. Each fused GAT kernel against its plain version on that RCM tiling at
   d = 512, for both attention activations: ``bsr_gat`` (out),
   ``bsr_gat_stats`` (out, m, l), ``bsr_gat_grads`` (der, del, dh); bounds
   and median times as in phase 3.
7. STAGATE on a few hundred spots, fitted on the card and on the CPU from
   the same seed: losses and embeddings must agree.

TF32 is off for every phase. The line before the last is a JSON object
with one entry per kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero without a result where there is no CUDA device, and where
``dance_tpu_torch`` is not importable next to this script.
"""

import json
import statistics
import subprocess
import sys
import time

N_CELLS, N_GENES, DIM, DENSITY, N_LABELS, EPOCHS = 12000, 2000, 256, 0.025, 8, 5
N_SPOTS, N_RAW_GENES, N_HVG, N_DOMAINS, N_NEIGHBORS = 10000, 5000, 3000, 7, 6
STAGATE_DIMS, STAGATE_EPOCHS = (N_HVG, 512, 30), 50
REPS = 20
# Max |kernel - plain| relative to max |plain|. Both sides sum in IEEE float32
# in another order (the plain SpMM through index_add_), over up to ~12k terms:
# the expected gap is ~1e-6; TF32 anywhere would show as ~1e-3. The same holds
# for the GAT forward (softmax-weighted means of h rows, expf against
# torch.exp, each within an ulp or two) and its stats m and l.
REL_BOUND = 1e-5
# The GAT backward's da = p (s - r) act' takes the difference of two 512-term
# dot products (s = g·h_j, r = g·out), which cancel to well below their terms'
# size, so its float32 rounding, relative to the largest gradient, is ~1e-5;
# TF32 would still show as ~1e-3.
GRAD_REL_BOUND = 1e-4
PALLAS = "dance_tpu/ops/pallas_kernels.py"
REPLACES = {"bsr_spmm": f"{PALLAS}:101", "bsr_sddmm": f"{PALLAS}:159",
            "bsr_gat": f"{PALLAS}:354", "bsr_gat_stats": f"{PALLAS}:426",
            "bsr_gat_grads": f"{PALLAS}:507"}
SOURCES = {"bsr_spmm": "bsr_spmm.cu", "bsr_sddmm": "bsr_sddmm.cu", "bsr_gat": "bsr_gat.cu",
           "bsr_gat_stats": "bsr_gat.cu", "bsr_gat_grads": "bsr_gat_bwd.cu"}


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True)
    return proc.stdout.strip()


def median_ms(fn, reps: int = REPS) -> float:
    import torch

    fn()  # warm-up
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check(name: str, outs, refs, bound: float = REL_BOUND, masks=None) -> float:
    """Hold each kernel output against the plain version's under ``bound``
    (max |kernel - plain| relative to max |plain|, over ``masks`` where given);
    return the largest absolute error."""
    import torch

    torch.cuda.synchronize()
    worst = 0.0
    for i, (out, ref) in enumerate(zip(outs, refs)):
        if out.shape != ref.shape or not torch.isfinite(out).all():
            raise AssertionError(f"{name}[{i}]: shape {tuple(out.shape)} (plain "
                                 f"{tuple(ref.shape)}) or non-finite values")
        if masks is not None and masks[i] is not None:
            out, ref = out[masks[i]], ref[masks[i]]
        max_abs = float((out - ref).abs().max()) if out.numel() else 0.0
        scale = float(ref.abs().max()) if ref.numel() else 0.0
        rel = max_abs / scale if scale else max_abs
        print(f"check {name}[{i}]: shape {tuple(out.shape)} max_abs_err {max_abs!r} "
              f"max|plain| {scale!r} rel {rel!r} (bound {bound})", flush=True)
        if not rel <= bound:
            raise AssertionError(f"{name}[{i}]: relative error {rel} above {bound}")
        worst = max(worst, max_abs)
    return worst


def compare(name: str, kernel, plain, bound: float = REL_BOUND) -> dict:
    """Run kernel and plain version once on the same inputs, check the error
    bound, then time both."""
    max_abs = check(name, [kernel()], [plain()], bound)
    ms, plain_ms = median_ms(kernel), median_ms(plain)
    print(f"time {name}: kernel {ms!r} ms, plain {plain_ms!r} ms (median of {REPS})",
          flush=True)
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


def spatial_counts(n_spots: int, n_genes: int, n_domains: int, seed: int):
    """Raw counts of spots in spatial domains: coordinates uniform in
    [0, 100)^2, domains the Voronoi cells of random centres, and per gene a
    baseline Poisson rate that a tenth of the genes scale up or down in each
    domain; spots differ in depth. Returns (counts float32, xy, domain)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    xy = (rng.random((n_spots, 2)) * 100).astype(np.float32)
    centres = rng.random((n_domains, 2)) * 100
    dom = ((xy[:, None, :] - centres[None]) ** 2).sum(-1).argmin(1)
    base = rng.gamma(0.6, 1.5, n_genes)
    fold = np.exp(rng.normal(0, 1.0, (n_domains, n_genes))
                  * (rng.random((n_domains, n_genes)) < 0.1))
    rates = fold[dom] * base[None]
    rates *= rng.gamma(4.0, 0.25, (n_spots, 1))
    return rng.poisson(rates).astype(np.float32), xy, dom


def scdeepsort_phases(cuda) -> dict:
    """Phases 2-4; returns the kernel entries' numbers and launch counts."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from dance_tpu_torch.graph import Graph
    from dance_tpu_torch.modules.single_modality.cell_type_annotation import ScDeepSort
    from dance_tpu_torch.ops import bsr
    from dance_tpu_torch.transforms import weighted_feature_pca

    # -- 2. the main path at bench width -----------------------------------
    rng = np.random.default_rng(0)
    expr = sp.random(N_CELLS, N_GENES, density=DENSITY, random_state=0, dtype=np.float32,
                     format="csr")
    labels = rng.integers(0, N_LABELS, N_CELLS)
    for kernel in (bsr.bsr_spmm, bsr.bsr_sddmm, bsr.bsr_gat, bsr.bsr_gat_stats,
                   bsr.bsr_gat_grads):
        kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cell_feat, gene_feat = weighted_feature_pca(expr, expr, DIM, device=cuda)
    t_pca = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = Graph.from_cell_feature_matrix(expr, cell_feat, gene_feat)
    t_graph = time.perf_counter() - t0
    model = ScDeepSort(dim_in=DIM, dim_hid=DIM, num_layers=2, seed=0, device=cuda)
    t0 = time.perf_counter()
    model.fit(graph, labels, epochs=EPOCHS, val_ratio=0.2, use_bsr=True)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = model.predict(graph)
    probs = model.predict_proba(graph)
    t_pred = time.perf_counter() - t0
    launches = {"bsr_spmm": bsr.bsr_spmm.launches, "bsr_sddmm": bsr.bsr_sddmm.launches}

    losses = [h["loss"] for h in model.history]
    epoch_s = [h["seconds"] for h in model.history]
    print(f"scDeepSort: pca {t_pca:.3f} s, graph {t_graph:.3f} s "
          f"({graph.num_nodes} nodes, {graph.num_edges} edges), fit {t_fit:.3f} s, "
          f"predict {t_pred:.3f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    print(f"losses {losses}", flush=True)
    print(f"val acc {[h['val_acc'] for h in model.history]}", flush=True)
    print(f"epoch seconds {epoch_s}; after the first epoch: median "
          f"{statistics.median(epoch_s[1:])!r} s/epoch", flush=True)
    print(f"launches in the scDeepSort path: {launches}", flush=True)
    if cell_feat.shape != (N_CELLS, DIM) or gene_feat.shape != (N_GENES, DIM) \
            or not (np.isfinite(cell_feat).all() and np.isfinite(gene_feat).all()):
        raise AssertionError("weighted_feature_pca: wrong shape or non-finite features")
    if len(losses) != EPOCHS or not np.isfinite(losses).all():
        raise AssertionError(f"non-finite or missing losses: {losses}")
    if pred.shape != (N_CELLS,) or probs.shape != (N_CELLS, N_LABELS):
        raise AssertionError(f"prediction shapes {pred.shape}, {probs.shape}")
    if not (np.isfinite(probs).all() and np.allclose(probs.sum(1), 1.0, atol=1e-4)):
        raise AssertionError("predict_proba rows are not probabilities")
    if not ((pred >= -1) & (pred < N_LABELS)).all():
        raise AssertionError("predictions out of range")
    if launches["bsr_spmm"] < 4 * EPOCHS:
        raise AssertionError(f"bsr_spmm launched {launches['bsr_spmm']} times, "
                             f"fewer than 4 x {EPOCHS} epochs")

    # -- 3. kernels against their plain versions on the bench tiling -------
    a = graph.to_adaptive_bsr(device=cuda).bsr
    at = bsr.bsr_transpose(a)
    print(f"bench tiling: {a.nb} tiles of {a.block}x{a.block}, {a.shape[0] // a.block} "
          f"block-rows, {a.nb * a.block * a.block * 4 / 1e6:.1f} MB, "
          f"{2 * a.nb * a.block * a.block * DIM / 1e9:.2f} GFLOP per SpMM at d={DIM}",
          flush=True)
    gen = torch.Generator().manual_seed(0)
    b = torch.randn((a.shape[1], DIM), generator=gen).to(cuda)
    g = torch.randn((a.shape[0], DIM), generator=gen).to(cuda)
    spmm = compare("bsr_spmm A@B", lambda: bsr.bsr_spmm(a, b),
                   lambda: bsr.bsr_spmm_reference(a, b))
    spmm_t = compare("bsr_spmm At@G", lambda: bsr.bsr_spmm(at, g),
                     lambda: bsr.bsr_spmm_reference(at, g))
    sddmm = compare("bsr_sddmm", lambda: bsr.bsr_sddmm(a.block_rows, a.block_cols, g, b),
                    lambda: bsr.bsr_sddmm_reference(a.block_rows, a.block_cols, g, b))
    spmm["max_abs_err"] = max(spmm["max_abs_err"], spmm_t["max_abs_err"])

    # -- 4. a small graph: the card against the CPU's plain versions --------
    srng = np.random.default_rng(1)
    small_expr = sp.random(300, 140, density=0.1, random_state=1, dtype=np.float32,
                           format="csr")
    small = Graph.from_cell_feature_matrix(small_expr,
                                           srng.random((300, 32), dtype=np.float32),
                                           srng.random((140, 32), dtype=np.float32))
    small_labels = srng.integers(0, 5, 300)
    runs = {}
    for label, device in (("cpu", torch.device("cpu")), ("cuda", cuda)):
        m = ScDeepSort(dim_in=32, dim_hid=64, num_layers=2, seed=0, device=device)
        m.fit(small, small_labels, epochs=3, lr=1e-2, use_bsr=True)
        runs[label] = ([h["loss"] for h in m.history], m.predict_proba(small))
    loss_gap = float(np.max(np.abs(np.subtract(runs["cuda"][0], runs["cpu"][0]))))
    prob_gap = float(np.max(np.abs(runs["cuda"][1] - runs["cpu"][1])))
    print(f"small graph, card vs CPU: max loss gap {loss_gap!r}, max probability gap "
          f"{prob_gap!r} (bounds 1e-4, 1e-4)", flush=True)
    if not (loss_gap <= 1e-4 and prob_gap <= 1e-4):
        raise AssertionError("the card disagrees with the CPU on the small graph")
    return {"bsr_spmm": (spmm, launches["bsr_spmm"]),
            "bsr_sddmm": (sddmm, launches["bsr_sddmm"])}


def stagate_phases(cuda) -> dict:
    """Phases 5-7; returns the GAT kernels' numbers and launch counts."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from dance_tpu_torch.modules.spatial.spatial_domain import Stagate, stagate_preprocess
    from dance_tpu_torch.ops import bsr
    from dance_tpu_torch.transforms import stagate_graph
    from dance_tpu_torch.utils import ari

    # -- 5. STAGATE at its published width ---------------------------------
    t0 = time.perf_counter()
    counts, xy, dom = spatial_counts(N_SPOTS, N_RAW_GENES, N_DOMAINS, seed=0)
    print(f"STAGATE data: {counts.shape} raw counts (mean {counts.mean():.3f}, "
          f"{(counts > 0).mean():.3f} nonzero), made in {time.perf_counter() - t0:.3f} s",
          flush=True)
    gat_kernels = (bsr.bsr_gat, bsr.bsr_gat_stats, bsr.bsr_gat_grads)
    for kernel in (bsr.bsr_spmm, bsr.bsr_sddmm, *gat_kernels):
        kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    x, adj = stagate_preprocess(counts, xy, n_top_genes=N_HVG, model_name="knn",
                                n_neighbors=N_NEIGHBORS)
    t_pre = time.perf_counter() - t0
    model = Stagate(hidden_dims=STAGATE_DIMS, device=cuda, seed=0)
    t0 = time.perf_counter()
    model.fit((x, adj), epochs=STAGATE_EPOCHS, use_bsr=True, n_clusters=N_DOMAINS)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    labels = model.predict()
    t_pred = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in gat_kernels}
    peak = torch.cuda.max_memory_allocated()

    # host pieces of the path, timed on their own (they launch no kernel)
    t0 = time.perf_counter()
    stagate_graph(xy, "knn", n_neighbors=N_NEIGHBORS)
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    bsr.rcm_reorder(sp.csr_matrix(adj) + sp.eye(N_SPOTS, format="csr", dtype=np.float32))
    t_rcm = time.perf_counter() - t0
    tiling = model.adj
    losses = [h["loss"] for h in model.history]
    epoch_s = [h["seconds"] for h in model.history]
    z = model.get_latent()
    print(f"STAGATE: preprocess {t_pre:.3f} s (of which kNN graph {t_graph:.3f} s), RCM "
          f"{t_rcm:.3f} s, fit {t_fit:.3f} s, predict {t_pred:.3f} s, peak device memory "
          f"{peak / 2**20:.1f} MiB; graph {adj.nnz} edges, tiling {tiling.nb} tiles over "
          f"{tiling.shape[0] // tiling.block} block-rows ({tiling.nb * tiling.block ** 2 * 4 / 1e6:.1f}"
          f" MB)", flush=True)
    print(f"STAGATE losses {losses}", flush=True)
    print(f"STAGATE epoch seconds {epoch_s}; after the first epoch: median "
          f"{statistics.median(epoch_s[1:])!r} s/epoch", flush=True)
    print(f"STAGATE ARI against the generating domains {ari(dom, labels)!r}", flush=True)
    print(f"launches in the STAGATE path: {launches}", flush=True)
    if x.shape != (N_SPOTS, N_HVG) or not np.isfinite(x).all():
        raise AssertionError(f"stagate_preprocess: features {x.shape} or non-finite")
    if len(losses) != STAGATE_EPOCHS or not np.isfinite(losses).all() \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"STAGATE losses non-finite, missing or not falling: {losses}")
    if z.shape != (N_SPOTS, STAGATE_DIMS[2]) or not np.isfinite(z).all():
        raise AssertionError(f"STAGATE embedding {z.shape} or non-finite")
    if labels.shape != (N_SPOTS,) or not ((labels >= 0) & (labels < N_DOMAINS)).all():
        raise AssertionError("STAGATE labels out of range")
    if launches["bsr_gat_stats"] < 2 * STAGATE_EPOCHS \
            or launches["bsr_gat_grads"] < 2 * STAGATE_EPOCHS or launches["bsr_gat"] < 2:
        raise AssertionError(f"GAT kernels launched {launches}: fewer than 2 x "
                             f"{STAGATE_EPOCHS} epochs (stats, grads) or 2 (primal)")

    # -- 6. the GAT kernels against their plain versions on that tiling ----
    d = STAGATE_DIMS[1]
    print(f"STAGATE tiling: {2 * tiling.nb * tiling.block ** 2 * d / 1e9:.2f} GFLOP of p @ h "
          f"per GAT forward at d={d}", flush=True)
    gen = torch.Generator().manual_seed(2)
    n_rows, n_cols = tiling.shape
    er, el = torch.randn(n_rows, generator=gen), torch.randn(n_cols, generator=gen)
    h, g = torch.randn((n_cols, d), generator=gen), torch.randn((n_rows, d), generator=gen)
    er, el, h, g = (t.to(cuda) for t in (er, el, h, g))
    results = {"bsr_gat": {}, "bsr_gat_stats": {}, "bsr_gat_grads": {}}
    for act in ("sigmoid", "leaky_relu"):  # STAGATE's first, then GATConv's
        out, m, l = bsr.bsr_gat_reference(tiling, er, el, h, act=act, return_stats=True)
        live = l > 0  # rows with an edge; the others hold m = -1e30 on both sides
        if not (bsr.bsr_gat_stats(tiling, er, el, h, act=act)[1][~live] == -1e30).all():
            raise AssertionError("bsr_gat_stats: m of a row without edges is not -1e30")
        runs = {
            "bsr_gat": (lambda: [bsr.bsr_gat(tiling, er, el, h, act=act)],
                        lambda: [bsr.bsr_gat_reference(tiling, er, el, h, act=act)],
                        REL_BOUND, None),
            "bsr_gat_stats": (
                lambda: list(bsr.bsr_gat_stats(tiling, er, el, h, act=act)),
                lambda: list(bsr.bsr_gat_reference(tiling, er, el, h, act=act,
                                                   return_stats=True)),
                REL_BOUND, [None, live, None]),
            "bsr_gat_grads": (
                lambda: list(bsr.bsr_gat_grads(tiling, er, el, h, g, out, m, l, act=act)),
                lambda: list(bsr.bsr_gat_grads_reference(tiling, er, el, h, g, out, m, l,
                                                         act=act)),
                GRAD_REL_BOUND, None),
        }
        for name, (kernel, plain, bound, masks) in runs.items():
            err = check(f"{name} {act}", kernel(), plain(), bound, masks)
            ms, plain_ms = median_ms(kernel), median_ms(plain)
            print(f"time {name} {act}: kernel {ms!r} ms, plain {plain_ms!r} ms "
                  f"(median of {REPS})", flush=True)
            res = results[name]
            res["max_abs_err"] = max(res.get("max_abs_err", 0.0), err)
            if act == "sigmoid":  # the main path's activation gives the entry's times
                res["ms"], res["plain_ms"] = ms, plain_ms
    grads = [bsr.bsr_gat_grads(tiling, er, el, h, g, out, m, l, act="sigmoid")
             for _ in range(2)]
    if not all(torch.equal(a, b) for a, b in zip(*grads)):
        raise AssertionError("bsr_gat_grads: two runs on the same inputs differ")
    print("bsr_gat_grads: two runs bit-equal", flush=True)

    # -- 7. a few hundred spots: the card against the CPU's plain versions --
    counts, xy, _ = spatial_counts(400, 800, 4, seed=1)
    x, adj = stagate_preprocess(counts, xy, n_top_genes=200, model_name="knn",
                                n_neighbors=N_NEIGHBORS)
    runs = {}
    for label, device in (("cpu", torch.device("cpu")), ("cuda", cuda)):
        m = Stagate(hidden_dims=(200, 64, 8), device=device, seed=0)
        m.fit((x, adj), epochs=10, use_bsr=True, n_clusters=4)
        runs[label] = (np.array([h["loss"] for h in m.history]), m.get_latent())
    loss_gap = float(np.max(np.abs(runs["cuda"][0] / runs["cpu"][0] - 1)))
    z_gap = float(np.max(np.abs(runs["cuda"][1] - runs["cpu"][1])))
    z_scale = float(np.max(np.abs(runs["cpu"][1])))
    print(f"small STAGATE, card vs CPU: max relative loss gap {loss_gap!r}, max z gap "
          f"{z_gap!r} (max |z| {z_scale!r}; bounds 1e-4 and 1e-4 x max |z|)", flush=True)
    if not (loss_gap <= 1e-4 and z_gap <= 1e-4 * z_scale):
        raise AssertionError("the card disagrees with the CPU on the small STAGATE fit")
    return {name: (res, launches[name]) for name, res in results.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from dance_tpu_torch.ops._build import load_kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda")
    # -- 1. card, versions, kernel build -----------------------------------
    print(card_line(), flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    kernels = load_kernels()
    print(f"build: {time.perf_counter() - t0:.3f} s (nvcc {kernels.build_seconds:.3f} s) "
          f"-> {kernels.path.name}", flush=True)
    for line in kernels.log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    measured = scdeepsort_phases(cuda)
    measured.update(stagate_phases(cuda))

    def entry(name):
        result, launched = measured[name]
        return {"name": name, "route": "cuda",
                "source": f"dance_tpu_torch/csrc/{SOURCES[name]}", "replaces": REPLACES[name],
                "launches": launched, **result}

    print(json.dumps({
        "kernels": [entry(name) for name in
                    ("bsr_spmm", "bsr_gat", "bsr_gat_stats", "bsr_gat_grads")],
        # the dA kernel is not on a main path: AdaptiveBSR's tiles are constants
        "off_path_kernels": [entry("bsr_sddmm")],
    }), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
