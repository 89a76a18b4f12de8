"""Steady scDSC epochs at full width on the card: untraced epoch times of the
minibatch autoencoder pretrain and of the DEC loop, and a torch.profiler
breakdown of each by kernel and by layer.

Run from the root of the checkout on a machine with a CUDA card; it uses
``chip_smoke.py``'s data maker and sizes:

    python3 tools/profile_scdsc.py

It prints the tables.
A steady epoch's device time is the difference of two traced fits, one with
1 + 10 epochs of the stage and one with 1 (the other stage at 1 epoch in
both), so set-up cancels; the DEC difference holds one of the refreshes that
come every 10 epochs. The idle share is 1 - that time over the untraced
median epoch. Imports no JAX.
"""
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import torch

import chip_smoke as cs
from dance_tpu_torch.modules.single_modality.clustering import ScDSC, scdsc_preprocess
from tools.profile_sctag import steady, table


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda")
    lines = [cs.card_line()]
    counts, _ = cs.clustered_counts(cs.GSC_CELLS, cs.GSC_GENES, cs.GSC_TYPES, seed=0)
    inputs, _ = scdsc_preprocess(counts, n_top_genes=cs.DSC_HVG, n_neighbors=cs.DSC_NEIGHBORS,
                                 device=cuda)
    model = ScDSC(n_input=inputs[1].shape[1], n_clusters=cs.GSC_TYPES, device=cuda, seed=0)
    model.fit(inputs, pt_epochs=2, epochs=2, use_bsr=True)  # warm-up
    model.fit(inputs, pt_epochs=20, epochs=30, use_bsr=True)
    pre_ms = statistics.median(h["seconds"] for h in model.pretrain_history) * 1e3
    dec_ms = statistics.median(h["seconds"] for h in model.history) * 1e3
    lines.append(f"untraced (EpochClock): AE pretrain median {pre_ms!r} ms over 20, DEC median "
                 f"{dec_ms!r} ms over 30")
    for title, kw, untraced in (("AE pretrain epoch", "pt_epochs", pre_ms),
                                ("DEC epoch", "epochs", dec_ms)):
        def fit(epochs, kw=kw):
            model.fit(inputs, **{"pt_epochs": 1, "epochs": 1, kw: epochs}, use_bsr=True)

        lines += table(title, steady(fit), untraced)[0]
    print("\n".join(lines), flush=True)


if __name__ == "__main__":
    main()
