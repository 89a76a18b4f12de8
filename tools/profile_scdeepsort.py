"""Steady scDeepSort epoch at bench width on the card: untraced epoch times,
then a torch.profiler breakdown by kernel and by layer.

Run from the root of the checkout on a machine with a CUDA card, after (or
without) ``chip_smoke.py``, whose sizes it uses (12,000 cells x 2,000 genes
at density 0.025, 256-d PCA features, 2 AdaptiveSAGE layers of width 256,
validation split 0.2):

    python3 tools/profile_scdeepsort.py

It prints the tables. The steady epoch's device time is the difference of
two traced fits (1 + 10 epochs and 1 epoch), so the fit's set-up and first
epoch cancel; the idle share is 1 - that time over the untraced median
epoch. Imports no JAX.
"""
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import numpy as np
import scipy.sparse as sp
import torch

import chip_smoke as cs
from dance_tpu_torch.graph import Graph
from dance_tpu_torch.modules.single_modality.cell_type_annotation import ScDeepSort
from dance_tpu_torch.transforms import weighted_feature_pca

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cuda = torch.device("cuda")
print(cs.card_line(), flush=True)
expr = sp.random(cs.N_CELLS, cs.N_GENES, density=cs.DENSITY, random_state=0, dtype=np.float32,
                 format="csr")
labels = np.random.default_rng(0).integers(0, cs.N_LABELS, cs.N_CELLS)
cell_feat, gene_feat = weighted_feature_pca(expr, expr, cs.DIM, device=cuda)
graph = Graph.from_cell_feature_matrix(expr, cell_feat, gene_feat)
model = ScDeepSort(dim_in=cs.DIM, dim_hid=cs.DIM, num_layers=2, seed=0, device=cuda)
model.fit(graph, labels, epochs=3, val_ratio=0.2, use_bsr=True)  # builds the tiling; warms up
model.fit(graph, labels, epochs=20, val_ratio=0.2, use_bsr=True)
epoch_ms = [h["seconds"] * 1e3 for h in model.history][1:]
print(f"untraced epoch (fit's own clock, after the first): median "
      f"{statistics.median(epoch_ms)!r} ms, min {min(epoch_ms)!r} ms, max {max(epoch_ms)!r} ms "
      f"over {len(epoch_ms)}: {[round(ms, 3) for ms in epoch_ms]}", flush=True)

from torch.profiler import ProfilerActivity, profile

N_PROF = 10


def traced_fit(epochs: int) -> dict:
    """Device time (ms) and launches of each kernel in a traced fit."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.fit(graph, labels, epochs=epochs, val_ratio=0.2, use_bsr=True)
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


# a fit of 1 + N_PROF epochs less a fit of 1: N_PROF steady epochs, the
# fit's set-up and first epoch cancel
short, long_ = traced_fit(1), traced_fit(1 + N_PROF)
steady = {}
for k, (ms, n) in long_.items():
    ms0, n0 = short.get(k, (0.0, 0))
    steady[k] = ((ms - ms0) / N_PROF, (n - n0) // N_PROF)
device = sum(ms for ms, _ in steady.values())
lines = [cs.card_line(),
         f"traced: device kernel time {device:.3f} ms per steady epoch (a traced fit of "
         f"{1 + N_PROF} epochs less one of 1, over {N_PROF}); idle share of the untraced median "
         f"epoch 1 - device / untraced = {1 - device / statistics.median(epoch_ms):.3f}"]


def layer(name):
    n = name.lower()
    if "bsr_spmm_kernel" in n or "bsr_spmm_reduce" in n:
        return "SpMM fwd + bwd (bsr_spmm.cu)"
    if "gemm" in n or "cutlass" in n or "sm90" in n or "sm80" in n:
        return "dense GEMMs (layers, head, cuBLAS)"
    if "adam" in n or "multi_tensor" in n or "foreach" in n:
        return "optimizer"
    if "reduce" in n:
        return "reductions (loss, LayerNorm, accuracy)"
    return "elementwise, gathers, copies"


by_layer = {}
for k, (ms, n) in steady.items():
    by_layer.setdefault(layer(k), [0.0, 0])
    by_layer[layer(k)][0] += ms
    by_layer[layer(k)][1] += n
lines.append("by layer (ms per epoch, launches per epoch, share of device time):")
for k, (ms, n) in sorted(by_layer.items(), key=lambda kv: -kv[1][0]):
    lines.append(f"  {k:40s} {ms:9.4f} ms  {n:4d}  {ms / device:.3f}")
lines.append("by kernel (ms per epoch, launches per epoch):")
for k, (ms, n) in sorted(steady.items(), key=lambda kv: -kv[1][0])[:20]:
    lines.append(f"  {ms:9.4f} ms  {n:4d}  {k[:110]}")
print("\n".join(lines), flush=True)
