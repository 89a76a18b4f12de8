"""Steady epochs of SpaGCN and EfNST (both phases) at full width on the card:
the untraced epoch and a torch.profiler breakdown by kernel and by class
(GEMMs, elementwise, optimizer, ...).

Run from the root of the checkout on a machine with a CUDA card; it uses
``chip_smoke.py``'s data makers and sizes (phases 47 and 49: 10,000 spots,
SpaGCN on the 50-d PCA and the 10,000² pixel distances, EfNST on its
pipeline's inputs through ``Data`` (the 50-d PCA beside the 50
morphology features, the 8-NN graph of the pixels), z 16, 6 clusters):

    python3 tools/profile_spatial.py

A steady epoch's device time is the difference of two traced fits (1 + 10
epochs and 1; set-up cancels; copies left out), with
``tools/profile_scmogcn.py``'s helpers;
the idle share is 1 - that time over the untraced median epoch of a 30-epoch
fit. SpaGCN runs with ``tol=0`` (no early stop); EfNST's pretrain fits run
no DEC epoch, its DEC fits one pretrain epoch. ``chip_smoke.py``'s phases 47
and 49 print the untraced epochs and leave their traces to this script.
Imports no JAX.
"""
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))
import numpy as np
import torch

import chip_smoke as cs
import dance_tpu_torch.modules.spatial.spatial_domain.EfNST as efnst
import profile_scmogcn as ps
from dance_tpu_torch.modules.spatial.spatial_domain import SpaGCN
from dance_tpu_torch.transforms import cell_pca, spagcn_graph_2d


def untraced_ms(history) -> float:
    return statistics.median(h["seconds"] for h in history[1:]) * 1e3


def steady_kernels(fit) -> dict:
    """``ps.steady`` without the copies: each fit uploads its inputs anew,
    and a copy from pageable host memory varies between fits."""
    return {k: v for k, v in ps.steady(fit).items()
            if not k.startswith(("Memcpy", "Memset"))}


def _result(title: str, per_epoch: dict, untraced: float):
    device_ms = sum(ms for ms, _ in per_epoch.values())
    return ps.table(title, per_epoch, untraced), device_ms, 1 - device_ms / untraced


def spagcn_profile(emb, dist, l: float, device, untraced: float):
    """SpaGCN's steady epoch (``tol=0``, no early stop) beside the untraced
    epoch ``untraced`` (ms): returns (the table's lines, the device ms an
    epoch, the idle share)."""
    model = SpaGCN(l=l, seed=0, device=device)
    per_epoch = steady_kernels(lambda epochs: model.fit((emb, dist), epochs=epochs, tol=0.0))
    return _result("SpaGCN epoch (10,000 spots, the dense 10,000² affinity)", per_epoch,
                   untraced)


def efnst_profile(concat, graph, phase: str, device, untraced: float):
    """EfNST's steady ``phase`` epoch (``"pretrain"``: fits with no DEC epoch;
    ``"dec"``: one pretrain epoch) beside ``untraced`` (ms): returns (the
    table's lines, the device ms an epoch, the idle share)."""
    model = efnst.EfNsSTRunner(n_clusters=6, z_dim=16, seed=0, device=device)
    kw = ((lambda e: dict(epochs=e, dec_epochs=0)) if phase == "pretrain"
          else (lambda e: dict(epochs=1, dec_epochs=e)))
    per_epoch = steady_kernels(lambda e: model.fit(concat_X=concat, graph_dict=graph, **kw(e)))
    return _result(f"EfNST {phase} epoch (10,000 spots, BCE over 10⁸ logits)", per_epoch,
                   untraced)


def main(device: str = "cuda"):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device(device)
    counts, xy, xy_pixel, image, _ = cs.spatial_slide_inputs(cs.N_SPOTS, cs.LV_GENES, seed=47)
    x = np.log1p(counts)
    lines = [cs.card_line()]

    emb, dist = cell_pca(x, cs.SG_DIM, device=cuda), spagcn_graph_2d(xy_pixel, device=cuda)
    model = SpaGCN(seed=0, device=cuda)
    model.set_l(model.search_l(0.5, dist))
    model.fit((emb, dist), epochs=30, tol=0.0)
    lines += spagcn_profile(emb, dist, model.l, cuda, untraced_ms(model.history))[0]

    concat, graph, _ = cs.efnst_inputs(cs.slide_data(counts, xy, xy_pixel, image), cuda)
    ef = efnst.EfNsSTRunner(n_clusters=6, z_dim=16, seed=0, device=cuda)
    ef.fit(concat_X=concat, graph_dict=graph, epochs=30, dec_epochs=30)
    for phase in ("pretrain", "dec"):
        hist = [h for h in ef.history if h["phase"] == phase]
        lines += efnst_profile(concat, graph, phase, cuda, untraced_ms(hist))[0]
    print("\n".join(lines), flush=True)


if __name__ == "__main__":
    main()
