"""Steady scTAG epochs at full width on the card: untraced epoch times of
both stages, a torch.profiler breakdown by kernel and by layer, and the share
of the epoch that encoder1's hops over the constant features take.

Run from the root of the checkout on a machine with a CUDA card; it uses
``chip_smoke.py``'s data maker and sizes:

    python3 tools/profile_sctag.py

It prints the tables.
A steady epoch's device time is the difference of two traced stages (1 + 10
epochs and 1 epoch, through ``ScTAG._run``), so set-up cancels; the idle
share is 1 - that time over the untraced median epoch (the fit's
``EpochClock``). The kernels are summed by name, without the ranges (such as
``Optimizer.step#Adam.step``) that also carry device time. Imports no JAX.
"""
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import torch

import chip_smoke as cs
from dance_tpu_torch.modules.single_modality.clustering import ScTAG, sctag_preprocess
from dance_tpu_torch.ops.segment import spmm

N_PROF = 10


def traced(fn) -> dict:
    """Device time (ms) and launches of each kernel while ``fn`` runs."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # kernels only: a range such as "Optimizer.step#Adam.step" also carries the
    # device time of the kernels inside it
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
    if "adam" in n or "multi_tensor" in n or "foreach" in n:
        return "optimizer"
    if "reduce" in n:
        return "reductions"
    return "elementwise, copies"


def table(title: str, per_epoch: dict, untraced_ms: float):
    """The lines of a stage's breakdown, and its device time per epoch."""
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
        lines.append(f"    {k:36s} {ms:9.4f} ms  {n:6.1f}  {ms / device:.3f}")
    lines.append("  by kernel (ms per epoch, launches per epoch):")
    for k, (ms, n) in sorted(per_epoch.items(), key=lambda kv: -kv[1][0])[:20]:
        lines.append(f"    {ms:9.4f} ms  {n:6.1f}  {k[:100]}")
    return lines, device


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda")
    lines = [cs.card_line()]
    counts, _ = cs.clustered_counts(cs.GSC_CELLS, cs.GSC_GENES, cs.GSC_TYPES, seed=0)
    inputs, _ = sctag_preprocess(counts, n_top_genes=cs.TAG_HVG, n_components=cs.TAG_PCS,
                                 n_neighbors=cs.TAG_NEIGHBORS, device=cuda)
    model = ScTAG(n_clusters=cs.GSC_TYPES, device=cuda, seed=0)
    model.fit(inputs, pretrain_epochs=3, epochs=3, use_bsr=True)  # graph, net, warm-up
    model.fit(inputs, pretrain_epochs=30, epochs=30, use_bsr=True, force_pretrain=True)
    pre_ms = statistics.median(h["seconds"] for h in model.pretrain_history) * 1e3
    dec_ms = statistics.median(h["seconds"] for h in model.history) * 1e3
    lines.append(f"untraced (EpochClock, 30 epochs each): pretrain median {pre_ms!r} ms, DEC "
                 f"median {dec_ms!r} ms")

    perm = model._perm
    x, xr, sf = model._tensors(inputs[1][perm], inputs[2][perm], inputs[3][perm])
    opt = torch.optim.Adam([*model.net.parameters(), model.mu], lr=5e-4)

    def stage(cluster):
        return lambda epochs: model._run(opt, x, xr, sf, 0.3, 1.0, 1.5 if cluster else None,
                                         0.0, 0.5, 20.0, epochs, cluster)

    for title, cluster, untraced in (("pretrain epoch", False, pre_ms),
                                     ("DEC epoch", True, dec_ms)):
        stage_lines, device = table(title, steady(stage(cluster)), untraced)
        lines += stage_lines
        if cluster:
            dec_device = device

    # encoder1's k hops run on the constant features: the same A^i x every
    # epoch. Timed with CUDA events (median of 5 runs of the k hops): a trace
    # of a few calls queued back to back has missed some of their launches
    def hops():
        h = x
        for _ in range(model.k):
            h = spmm(model.adj_n, h)

    hop_ms = cs.median_ms(hops, reps=5)
    lines.append(f"encoder1's {model.k} hops over the constant features (d = {x.shape[1]}): "
                 f"{hop_ms:.3f} ms with the pads and slices (CUDA events, median of 5), "
                 f"{hop_ms / dec_device:.3f} of the DEC epoch's device time, "
                 f"{hop_ms / dec_ms:.3f} of its untraced time")
    print("\n".join(lines), flush=True)


if __name__ == "__main__":
    main()
