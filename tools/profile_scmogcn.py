"""Steady scMoGNN epochs at full width on the card: the untraced epoch and a
torch.profiler breakdown by kernel and by layer, for the BSR fit
(``use_bsr=True``: #1 on the ``f2c``/``c2f`` tilings with edge dropout on the
tiles) and for the format ``use_bsr="auto"`` picks (dense there).

Run from the root of the checkout on a machine with a CUDA card; it uses
``chip_smoke.py``'s data maker and sizes (10,000 cells x 2,000 genes -> 134
proteins, ``default_args``):

    python3 tools/profile_scmogcn.py

It prints the tables. A steady epoch's device time is the difference of two
traced fits (1 + 10 epochs and 1 epoch; the graph is kept across fits, so
set-up cancels); the idle share is 1 - that time over the untraced median
epoch (the fit's ``EpochClock``, 30 epochs). The kernels are summed by name,
without the ranges (such as ``Optimizer.step#AdamW.step``) that also carry
device time. It also counts the work schedules built on the host during the
traced fits (``ops.bsr.device_schedule.builds``). Imports no JAX.
"""
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import torch

import chip_smoke as cs
from dance_tpu_torch.modules.multi_modality.predict_modality import ScMoGCNWrapper
from dance_tpu_torch.ops import bsr

N_PROF = 10


def traced(fn) -> dict:
    """Device time (ms) and launches of each kernel while ``fn`` runs."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and "#" not in e.key}


def steady(fn) -> dict:
    """Per epoch: ``fn(1 + N_PROF)`` traced less ``fn(1)`` traced, over N_PROF."""
    short, long_ = traced(lambda: fn(1)), traced(lambda: fn(1 + N_PROF))
    out = {}
    for k, (ms, n) in long_.items():
        ms0, n0 = short.get(k, (0.0, 0))
        out[k] = ((ms - ms0) / N_PROF, (n - n0) / N_PROF)
    return out


def layer(name: str) -> str:
    n = name.lower()
    if "bsr_spmm" in n:
        return "SpMM #1 fwd + bwd (bsr_spmm.cu)"
    if "gemm" in n or "cutlass" in n or "sm90" in n or "sm80" in n or "gemv" in n:
        return "dense GEMMs (cuBLAS)"
    if "philox" in n or "uniform" in n or "random" in n or "bernoulli" in n:
        return "dropout random numbers"
    if "adam" in n or "multi_tensor" in n or "foreach" in n:
        return "optimizer"
    if "norm" in n:
        return "group norm"
    if "index" in n or "gather" in n or "scatter" in n:
        return "gathers, scatters (tile transposes)"
    if "reduce" in n:
        return "reductions"
    return "elementwise, copies"


def table(title: str, per_epoch: dict, untraced_ms: float):
    device = sum(ms for ms, _ in per_epoch.values())
    lines = [f"{title}: device kernel time {device:.3f} ms per steady epoch (traced 1 + "
             f"{N_PROF} epochs less 1, over {N_PROF}); untraced median epoch {untraced_ms:.3f} "
             f"ms; idle share 1 - device / untraced = {1 - device / untraced_ms:.3f}"]
    by_layer = {}
    for k, (ms, n) in per_epoch.items():
        acc = by_layer.setdefault(layer(k), [0.0, 0.0])
        acc[0] += ms
        acc[1] += n
    lines.append("  by layer (ms per epoch, launches per epoch, share of device time):")
    for k, (ms, n) in sorted(by_layer.items(), key=lambda kv: -kv[1][0]):
        lines.append(f"    {k:38s} {ms:9.4f} ms  {n:7.1f}  {ms / device:.3f}")
    lines.append("  by kernel (ms per epoch, launches per epoch):")
    for k, (ms, n) in sorted(per_epoch.items(), key=lambda kv: -kv[1][0])[:20]:
        lines.append(f"    {ms:9.4f} ms  {n:7.1f}  {k[:100]}")
    return lines


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda")
    lines = [cs.card_line()]
    counts, _ = cs.multimodal_counts(cs.MM_CELLS, cs.MM_GENES, cs.MM_TYPES, seed=0)
    y = cs.protein_targets(counts)
    for use_bsr in (True, "auto"):
        model = ScMoGCNWrapper(seed=0, device=cuda)
        model.fit(counts, y, epochs=3, use_bsr=use_bsr)  # the graph; warm-up
        model.fit(counts, y, epochs=30, use_bsr=use_bsr)
        untraced = statistics.median(h["seconds"] for h in model.history) * 1e3
        builds = bsr.device_schedule.builds
        per_epoch = steady(lambda epochs: model.fit(counts, y, epochs=epochs, use_bsr=use_bsr))
        lines += table(f"scMoGNN epoch, use_bsr={use_bsr!r} ({model._graph.fmt})", per_epoch,
                       untraced)
        lines.append(f"  work schedules built on the host during the traced fits: "
                     f"{bsr.device_schedule.builds - builds}")
    print("\n".join(lines), flush=True)


if __name__ == "__main__":
    main()
