#!/usr/bin/env python3
"""Drive the PyTorch port's scDeepSort main path once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of the repository

What it does, in order (any failure exits non-zero, and the result line is
printed only when every phase passed):

1. Prints the card (``nvidia-smi --query-gpu=name,power.limit``), the
   torch/CUDA versions, and builds the CUDA kernels of
   ``dance_tpu_torch/csrc`` with nvcc for sm_90a (timed).
2. The main path at bench width, with every kernel launch count set to 0
   just before it: a 12,000-cell x 2,000-gene expression matrix at density
   0.025 -> ``weighted_feature_pca`` (k = 256) -> ``Graph.
   from_cell_feature_matrix`` -> ``ScDeepSort(dim_in=256, dim_hid=256,
   num_layers=2).fit(epochs=5, val_ratio=0.2, use_bsr=True)`` on cuda ->
   ``predict``. Checks finite losses, output shapes and probabilities, and
   that the ``bsr_spmm`` kernel ran at least 4 x epochs times.
3. Each kernel against its plain PyTorch version on the bench tiling
   (d = 256): ``bsr_spmm`` on A and on its transpose, ``bsr_sddmm``; the max
   error of each under its stated bound; median times of kernel and plain
   version (CUDA events, synchronised around each run).
4. The port on a small graph, fitted on the card and on the CPU (the plain
   versions) from the same seed: losses and probabilities must agree.

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
REPS = 20
# Max |kernel - plain| relative to max |plain|. Both sides sum in IEEE float32
# in another order (the plain SpMM through index_add_), over up to ~12k terms:
# the expected gap is ~1e-6; TF32 anywhere would show as ~1e-3.
REL_BOUND = 1e-5


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


def compare(name: str, kernel, plain) -> dict:
    """Run kernel and plain version once on the same inputs, check the error
    bound, then time both."""
    import torch

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    max_abs = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    rel = max_abs / scale if scale else max_abs
    print(f"check {name}: shape {tuple(out.shape)} max_abs_err {max_abs!r} "
          f"max|plain| {scale!r} rel {rel!r} (bound {REL_BOUND})", flush=True)
    if not rel <= REL_BOUND:
        raise AssertionError(f"{name}: relative error {rel} above {REL_BOUND}")
    ms, plain_ms = median_ms(kernel), median_ms(plain)
    print(f"time {name}: kernel {ms!r} ms, plain {plain_ms!r} ms (median of {REPS})",
          flush=True)
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import numpy as np
    import scipy.sparse as sp

    from dance_tpu_torch.graph import Graph
    from dance_tpu_torch.modules.single_modality.cell_type_annotation import ScDeepSort
    from dance_tpu_torch.ops import bsr
    from dance_tpu_torch.ops._build import load_kernels
    from dance_tpu_torch.transforms import weighted_feature_pca

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

    # -- 2. the main path at bench width -----------------------------------
    rng = np.random.default_rng(0)
    expr = sp.random(N_CELLS, N_GENES, density=DENSITY, random_state=0, dtype=np.float32,
                     format="csr")
    labels = rng.integers(0, N_LABELS, N_CELLS)
    bsr.bsr_spmm.launches = 0
    bsr.bsr_sddmm.launches = 0
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
    print(f"main path: pca {t_pca:.3f} s, graph {t_graph:.3f} s "
          f"({graph.num_nodes} nodes, {graph.num_edges} edges), fit {t_fit:.3f} s, "
          f"predict {t_pred:.3f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    print(f"losses {losses}", flush=True)
    print(f"val acc {[h['val_acc'] for h in model.history]}", flush=True)
    print(f"epoch seconds {epoch_s}; after the first epoch: median "
          f"{statistics.median(epoch_s[1:])!r} s/epoch", flush=True)
    print(f"launches in the main path: {launches}", flush=True)
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

    def entry(name, result, launched):
        return {"name": name, "route": "cuda", "source": f"dance_tpu_torch/csrc/{name}.cu",
                "replaces": {"bsr_spmm": "dance_tpu/ops/pallas_kernels.py:101",
                             "bsr_sddmm": "dance_tpu/ops/pallas_kernels.py:159"}[name],
                "launches": launched, **result}

    spmm["max_abs_err"] = max(spmm["max_abs_err"], spmm_t["max_abs_err"])
    print(json.dumps({
        "kernels": [entry("bsr_spmm", spmm, launches["bsr_spmm"])],
        # the dA kernel is not on the main path: AdaptiveBSR's tiles are constants
        "off_path_kernels": [entry("bsr_sddmm", sddmm, launches["bsr_sddmm"])],
    }), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
