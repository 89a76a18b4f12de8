"""Steady STAGATE epoch at full width on the card: untraced time, then a
torch.profiler breakdown by kernel and by layer.

Run from the root of the checkout on a machine with a CUDA card, after (or
without) ``chip_smoke.py``, whose data maker and sizes it uses:

    python3 tools/profile_stagate.py

It prints the tables and writes them to ``chiprun_out/profile_stagate.txt``.
Imports no JAX.
"""
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import torch

import chip_smoke as cs
from dance_tpu_torch.modules.spatial.spatial_domain import Stagate, stagate_preprocess
from dance_tpu_torch.utils.optim import clip_by_global_norm_

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cuda = torch.device("cuda")
print(cs.card_line(), flush=True)
counts, xy, dom = cs.spatial_counts(cs.N_SPOTS, cs.N_RAW_GENES, cs.N_DOMAINS, seed=0)
x, adj = stagate_preprocess(counts, xy, n_top_genes=cs.N_HVG, model_name="knn",
                            n_neighbors=cs.N_NEIGHBORS)
model = Stagate(hidden_dims=cs.STAGATE_DIMS, device=cuda, seed=0)
model.fit((x, adj), epochs=2, use_bsr=True, n_clusters=cs.N_DOMAINS)
net, tiling = model.net, model.adj
xt = torch.from_numpy(x[model._perm]).to(cuda)
params = list(net.parameters())
opt = torch.optim.AdamW(params, lr=1e-3, weight_decay=1e-4)


def step():
    opt.zero_grad(set_to_none=True)
    _, x_hat = net(tiling, xt)
    loss = torch.mean((xt - x_hat) ** 2)
    loss.backward()
    clip_by_global_norm_(params, 5.0)
    opt.step()
    return float(loss.detach())


for _ in range(5):
    step()
times = []
for _ in range(30):
    t0 = time.perf_counter()
    step()
    times.append(time.perf_counter() - t0)
print(f"untraced steady epoch: median {statistics.median(times) * 1e3!r} ms, "
      f"min {min(times) * 1e3!r} ms, max {max(times) * 1e3!r} ms over 30", flush=True)

from torch.profiler import ProfilerActivity, profile

N_PROF = 10
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for _ in range(N_PROF):
        step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
total = sum(e.self_device_time_total for e in events) / 1e3  # ms
lines = [cs.card_line(),
         f"traced: {N_PROF} epochs in {wall * 1e3:.3f} ms ({wall * 1e3 / N_PROF:.3f} ms/epoch), "
         f"device kernel time {total / N_PROF:.3f} ms/epoch, idle share "
         f"{1 - total / (wall * 1e3):.3f}"]


def layer(name):
    n = name.lower()
    if "bsr_gat_kernel" in n or "bsr_gat_combine" in n:
        return "GAT forward (bsr_gat.cu)"
    if "gat_bwd" in n:
        return "GAT backward (bsr_gat_bwd.cu)"
    if "gemm" in n or "cutlass" in n or "sm90" in n or "sm80" in n:
        return "dense GEMMs (cuBLAS)"
    if "adam" in n or "multi_tensor" in n or "foreach" in n:
        return "optimizer"
    if "reduce" in n:
        return "reductions"
    return "elementwise, copies, other"


by_layer = {}
for e in events:
    by_layer.setdefault(layer(e.key), [0.0, 0])
    by_layer[layer(e.key)][0] += e.self_device_time_total / 1e3 / N_PROF
    by_layer[layer(e.key)][1] += e.count // N_PROF
lines.append("by layer (ms per epoch, launches per epoch, share of device time):")
for k, (ms, n) in sorted(by_layer.items(), key=lambda kv: -kv[1][0]):
    lines.append(f"  {k:36s} {ms:9.4f} ms  {n:4d}  {ms / (total / N_PROF):.3f}")
lines.append("by kernel (ms per epoch, launches per epoch):")
for e in sorted(events, key=lambda e: -e.self_device_time_total)[:25]:
    lines.append(f"  {e.self_device_time_total / 1e3 / N_PROF:9.4f} ms  "
                 f"{e.count // N_PROF:4d}  {e.key[:110]}")
text = "\n".join(lines)
print(text, flush=True)
out = REPO / "chiprun_out"
out.mkdir(exist_ok=True)
(out / "profile_stagate.txt").write_text(text + "\n")
