"""Steady DSTG and stdGCN epochs at full width on the card: the untraced
epoch and a torch.profiler breakdown by kernel and by layer.

Run from the root of the checkout on a machine with a CUDA card; it uses
``chip_smoke.py``'s data maker and sizes (2,000 reference cells x 2,000 genes
in 8 types, 1,000 pseudo + 4,000 real spots):

    python3 tools/profile_deconvo.py

It prints the tables: DSTG at its defaults with ``use_bsr="auto"`` (BSR on
the card), stdGCN at its defaults on BSR with ``early_stopping_patience=0``
(8 #1 calls an epoch) and with the default patience (a validation forward
and a host read each epoch). A steady epoch's device time is the difference
of two traced fits (1 + 10 epochs and 1 epoch, 1 + 50 and 1 for DSTG; the
graph cancels), as in
``tools/profile_scmogcn.py``, whose helpers it uses; the idle share is 1 -
that time over the untraced median epoch (the fit's ``EpochClock``). Imports
no JAX.
"""
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))
import torch

import chip_smoke as cs
import profile_scmogcn as ps
from dance_tpu_torch.modules.spatial.cell_type_deconvo import DSTG, StdGCN, dstg_preprocess


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda")
    lines = [cs.card_line()]
    x_ref, labels, x_real, _, coords = cs.deconvo_inputs(cs.DC_REF, cs.DC_GENES, cs.DC_TYPES,
                                                         cs.DC_REAL, seed=5)
    inp = dstg_preprocess(x_ref, labels, x_real, n_pseudo=cs.DC_PSEUDO, k_filter=cs.DC_K_FILTER,
                          num_cc=cs.DC_NUM_CC, device=cuda)
    dstg = DSTG(seed=0, device=cuda)

    def fit_dstg(epochs):
        dstg.fit((inp.x, inp.adj), inp.y, max_epochs=epochs)

    fit_dstg(3)  # warm-up
    fit_dstg(300)
    untraced = statistics.median(h["seconds"] for h in dstg.history[1:]) * 1e3
    # a DSTG epoch is ~0.2 ms of kernels: 50 epochs, so that the fits' own
    # set-up (tiling, uploads) cancels in the difference
    ps.N_PROF = 50
    lines += ps.table("DSTG epoch, use_bsr='auto' (bsr)", ps.steady(fit_dstg), untraced)
    ps.N_PROF = 10

    feat, coords_all, y = cs.stdgcn_inputs(x_ref, labels, x_real, coords, cs.DC_PSEUDO)
    model = StdGCN(seed=0, device=cuda)
    for patience in (0, 5):
        def fit_stdgcn(epochs):
            model.fit((feat, coords_all), y, max_epochs=epochs, use_bsr=True,
                      early_stopping_patience=patience)

        fit_stdgcn(3)  # the graph (then kept) and the warm-up
        fit_stdgcn(60)
        untraced = statistics.median(h["seconds"] for h in model.history[1:]) * 1e3
        lines += ps.table(f"stdGCN epoch, use_bsr=True, early_stopping_patience={patience}",
                          ps.steady(fit_stdgcn), untraced)
    print("\n".join(lines), flush=True)


if __name__ == "__main__":
    main()
