"""Steady graph-sc epoch at full width on the card: untraced epoch times,
then a torch.profiler breakdown by kernel and by layer.

Run from the root of the checkout on a machine with a CUDA card, after (or
without) ``chip_smoke.py``, whose data maker and sizes it uses:

    python3 tools/profile_graphsc.py

It prints the tables. Imports no JAX.
"""
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import torch

import chip_smoke as cs
from dance_tpu_torch.modules.single_modality.clustering import GraphSC, graphsc_preprocess

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cuda = torch.device("cuda")
print(cs.card_line(), flush=True)
counts, _ = cs.clustered_counts(cs.GSC_CELLS, cs.GSC_GENES, cs.GSC_TYPES, seed=0)
g, _ = graphsc_preprocess(counts, n_top_genes=cs.GSC_HVG, device=cuda)
model = GraphSC(n_clusters=cs.GSC_TYPES, device=cuda, seed=0)
model.fit(g, epochs=5, use_bsr=True)  # builds the device inputs; warms up
model.fit(g, epochs=30, use_bsr=True)
epoch_ms = [h["seconds"] * 1e3 for h in model.history]
print(f"untraced epoch (fit's own clock, one host read each): median "
      f"{statistics.median(epoch_ms)!r} ms, min {min(epoch_ms)!r} ms, max {max(epoch_ms)!r} ms "
      f"over {len(epoch_ms)}", flush=True)

from torch.profiler import ProfilerActivity, profile

N_PROF = 10
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    model.fit(g, epochs=N_PROF, use_bsr=True)  # N_PROF steps and one final embedding
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
total = sum(e.self_device_time_total for e in events) / 1e3  # ms
lines = [cs.card_line(),
         f"traced: fit of {N_PROF} epochs in {wall * 1e3:.3f} ms ({wall * 1e3 / N_PROF:.3f} "
         f"ms/epoch), device kernel time {total / N_PROF:.3f} ms/epoch, idle share "
         f"{1 - total / (wall * 1e3):.3f}"]


def layer(name):
    n = name.lower()
    if "bsr_spmm_kernel" in n:
        return "SpMM fwd + bwd (bsr_spmm.cu)"
    if "gemm" in n or "cutlass" in n or "sm90" in n or "sm80" in n:
        return "dense GEMMs (Gram + layers, cuBLAS)"
    if "adam" in n or "multi_tensor" in n or "foreach" in n:
        return "optimizer"
    if "reduce" in n:
        return "reductions (BCE mean, sums)"
    if "philox" in n or "uniform" in n or "random" in n:
        return "dropout mask"
    return "elementwise (BCE, ReLU, dropout), copies"


by_layer = {}
for e in events:
    by_layer.setdefault(layer(e.key), [0.0, 0])
    by_layer[layer(e.key)][0] += e.self_device_time_total / 1e3 / N_PROF
    by_layer[layer(e.key)][1] += e.count // N_PROF
lines.append("by layer (ms per epoch, launches per epoch, share of device time):")
for k, (ms, n) in sorted(by_layer.items(), key=lambda kv: -kv[1][0]):
    lines.append(f"  {k:40s} {ms:9.4f} ms  {n:4d}  {ms / (total / N_PROF):.3f}")
lines.append("by kernel (ms per epoch, launches per epoch):")
for e in sorted(events, key=lambda e: -e.self_device_time_total)[:25]:
    lines.append(f"  {e.self_device_time_total / 1e3 / N_PROF:9.4f} ms  "
                 f"{e.count // N_PROF:4d}  {e.key[:110]}")
print("\n".join(lines), flush=True)
