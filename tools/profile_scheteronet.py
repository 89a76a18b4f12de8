"""Steady scHeteroNet and GraphSCI epochs at full width on the card: the
untraced epoch and a torch.profiler breakdown by kernel and by layer.

Run from the root of the checkout on a machine with a CUDA card; it uses
``chip_smoke.py``'s data maker and sizes (10,000 cells x 2,000 genes in 8
types, the last rare):

    python3 tools/profile_scheteronet.py

It prints the tables: scHeteroNet at its defaults with ``use_bsr="auto"``
(both hops on BSR tiles on the card: 8 #1 calls an epoch) and GraphSCI at
its defaults (the gene graph in the format the rule picks). A steady
epoch's device time is the difference of two traced fits (1 + 10 epochs and
1 epoch; the graph is kept across fits, so set-up cancels), with
``tools/profile_scmogcn.py``'s helpers; the idle share is 1 - that time over
the untraced median epoch (the fit's ``EpochClock``). Imports no JAX.
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
from dance_tpu_torch.modules.single_modality.cell_type_annotation import (scHeteroNet,
                                                                          scheteronet_preprocess)
from dance_tpu_torch.modules.single_modality.imputation import GraphSCI, graphsci_preprocess


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda")
    lines = [cs.card_line()]
    counts, types = cs.annotation_counts(cs.HN_CELLS, cs.HN_GENES, cs.HN_TYPES, cs.HN_RARE,
                                         seed=13)
    inp = scheteronet_preprocess(counts, types)
    split = cs.split_60_20_20(inp.labels, seed=14)
    model = scHeteroNet(seed=0, device=cuda)

    def fit_heteronet(epochs):
        model.fit(inp.graph, inp.labels, x_raw=inp.x_raw, size_factors=inp.size_factors,
                  train_idx=split["train_idx"], epochs=epochs)

    fit_heteronet(3)  # the hops (then kept) and the warm-up
    fit_heteronet(60)
    untraced = statistics.median(h["seconds"] for h in model.history[1:]) * 1e3
    lines += ps.table(f"scHeteroNet epoch, use_bsr='auto' ({'/'.join(model.fmts)})",
                      ps.steady(fit_heteronet), untraced)
    del model, inp

    gs = graphsci_preprocess(counts, seed=0)
    imputer = GraphSCI(*gs.x.shape, seed=0, device=cuda)

    def fit_graphsci(epochs):
        imputer.n_epochs, imputer.net = epochs, None
        imputer.fit(gs.graph, gs.x, gs.x_raw, mask=gs.train_mask)

    fit_graphsci(3)
    fit_graphsci(30)
    untraced = statistics.median(h["seconds"] for h in imputer.history[1:]) * 1e3
    lines += ps.table(f"GraphSCI epoch ({imputer.fmt} gene graph)", ps.steady(fit_graphsci),
                      untraced)
    print("\n".join(lines), flush=True)


if __name__ == "__main__":
    main()
