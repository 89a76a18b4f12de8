"""Steady epochs of the dense single-modality models at full width on the
card: ACTINN, scDeepCluster's pretrain and DEC stages, scDCC's DEC stage
(with its constraint step) and DeepImpute, each as the untraced epoch and a
torch.profiler breakdown by kernel and by class (GEMMs, elementwise,
optimizer, ...).

Run from the root of the checkout on a machine with a CUDA card; it uses
``chip_smoke.py``'s data makers and sizes (phases 27-30: 10,000 cells x
2,000 genes in 8 types for ACTINN and DeepImpute, 10,000 cells x 5,000
genes for scDeepCluster and scDCC):

    python3 tools/profile_dense.py

A steady epoch's device time is the difference of two traced fits (1 + 10
epochs and 1 epoch; the rest of a fit, set-up and k-means, cancels), with
``tools/profile_scmogcn.py``'s helpers; the idle share is 1 - that time over
the untraced median epoch (the fit's ``EpochClock``). Imports no JAX.
"""
import random
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))
import numpy as np
import torch

import chip_smoke as cs
import profile_scmogcn as ps
from dance_tpu_torch.modules.single_modality.cell_type_annotation import (ACTINN,
                                                                          actinn_preprocess)
from dance_tpu_torch.modules.single_modality.clustering import (ScDCC, ScDeepCluster,
                                                                scdcc_preprocess,
                                                                scdeepcluster_preprocess)
from dance_tpu_torch.modules.single_modality.imputation import DeepImpute, deepimpute_preprocess
from dance_tpu_torch.transforms import generate_random_pair


def untraced_ms(history) -> float:
    return statistics.median(h["seconds"] for h in history[1:]) * 1e3


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda")
    lines = [cs.card_line()]
    counts, types = cs.annotation_counts(cs.HN_CELLS, cs.HN_GENES, cs.HN_TYPES, cs.HN_RARE,
                                         seed=13)
    names = cs.gene_names(cs.HN_GENES)

    x, _ = actinn_preprocess(counts, names)
    train = np.sort(np.random.default_rng(21).permutation(len(types))[:int(0.6 * len(types))])
    actinn = ACTINN(random_seed=0, device=cuda)

    def fit_actinn(epochs):
        actinn.fit(x[train], types[train], num_epochs=epochs)

    fit_actinn(3)
    fit_actinn(30)
    lines += ps.table("ACTINN epoch (batch 128)", ps.steady(fit_actinn),
                      untraced_ms(actinn.history))

    di = deepimpute_preprocess(counts, names, seed=0)
    imputer = DeepImpute(di.predictors, di.targets, seed=0, device=cuda)

    def fit_deepimpute(epochs):  # patience past the epochs: validation every epoch, no stop
        imputer.fit(di.x, di.x, mask=di.train_mask, n_epochs=epochs, patience=100)

    fit_deepimpute(3)
    fit_deepimpute(20)
    lines += ps.table(f"DeepImpute epoch ({len(di.targets)} subnets, batch 64, with validation)",
                      ps.steady(fit_deepimpute), untraced_ms(imputer.history))
    del imputer, di, counts

    ccounts, ctypes = cs.clustered_counts(cs.GSC_CELLS, cs.GSC_GENES, cs.GSC_TYPES, seed=0)
    cnames = cs.gene_names(cs.GSC_GENES)
    inp = scdeepcluster_preprocess(ccounts, cnames, ctypes)
    model = ScDeepCluster(inp.x.shape[1], 32, seed=0, device=cuda)

    def pretrain(epochs):
        model.pretrain(*inp.inputs, epochs=epochs)

    def dec(epochs):
        model.fit(inp.inputs, n_clusters=cs.GSC_TYPES, pt_epochs=0, epochs=epochs, tol=0.0)

    pretrain(3)
    pretrain(20)
    lines += ps.table(f"scDeepCluster pretrain epoch ({inp.x.shape[1]} genes, batch 256)",
                      ps.steady(pretrain), untraced_ms(model.pretrain_history))
    dec(3)
    dec(20)
    lines += ps.table("scDeepCluster DEC epoch (refresh + batch 256)", ps.steady(dec),
                      untraced_ms(model.history))
    del model, inp

    inp = scdcc_preprocess(ccounts, cnames, ctypes, n_top_genes=2000)
    random.seed(31)
    np.random.seed(31)
    pairs = generate_random_pair(inp.labels, range(len(inp.labels)), cs.DN_PAIRS)[:4]
    model = ScDCC(inp.x.shape[1], 32, cs.GSC_TYPES, seed=0, device=cuda)

    def dec_dcc(epochs):
        model.fit(inp.inputs, pt_epochs=0, epochs=epochs, tol=0.0, ml_ind1=pairs[0],
                  ml_ind2=pairs[1], cl_ind1=pairs[2], cl_ind2=pairs[3])

    dec_dcc(3)
    dec_dcc(20)
    lines += ps.table("scDCC DEC epoch (refresh + batch 256 + constraint step)",
                      ps.steady(dec_dcc), untraced_ms(model.history))
    print("\n".join(lines), flush=True)


if __name__ == "__main__":
    main()
