"""Steady epochs of scMoGNN v2, BABEL, CMAE, scMM, DCCA, JAE and scMVAE at
full width on the card: the untraced epoch and a torch.profiler breakdown by
kernel and by class (GEMMs, elementwise, optimizer, ...).

Run from the root of the checkout on a machine with a CUDA card; it uses
``chip_smoke.py``'s data maker and sizes (phases 37-40 and 43-45: 10,000
training cells x 2,000 genes <-> 134 proteins, each model at its JAX
benchmark case's settings):

    python3 tools/profile_multimodal.py                   # all seven
    python3 tools/profile_multimodal.py dcca jae scmvae   # some of them

A steady epoch's device time is the difference of two traced fits (1 + 10
epochs and 1 epoch; set-up cancels, v2's graph is built by an untraced fit
before them; JAE and scMVAE, 157 steps an epoch, 1 + 2 and 1), with
``tools/profile_scmogcn.py``'s helpers; the idle share is 1 - that time over
the untraced median epoch (the fit's ``EpochClock``). A DCCA "epoch" is one
epoch of each of its three phases (3 full-batch steps), its untraced time
the sum of the phases' median epochs. v2 and BABEL run without early
stopping here. ``chip_smoke.py`` phase 37 calls :func:`v2_profile`.
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
import profile_scmogcn as ps
from dance_tpu_torch.modules.multi_modality.joint_embedding import DCCA, JAEWrapper, scMVAE
from dance_tpu_torch.modules.multi_modality.joint_embedding.scmogcnv2 import ScMoGCNWrapperV2
from dance_tpu_torch.modules.multi_modality.predict_modality import CMAE, MMVAE, BabelWrapper

MODELS = ("v2", "babel", "cmae", "scmm", "dcca", "jae", "scmvae")


def untraced_ms(history, skip: int = 1) -> float:
    return statistics.median(h["seconds"] for h in history[skip:]) * 1e3


def v2_profile(x1, x2, types, device, untraced: float):
    """scMoGNN v2's steady epoch (one 5,000-cell step on sampled features and
    the full-graph validation forward) traced beside ``untraced`` ms:
    returns (the table's lines, the idle share)."""
    model = ScMoGCNWrapperV2(seed=0, early_stopping=10 ** 9, device=device)
    model.fit(x1, x2, cell_type=types, epochs=1)  # the graph, kept for the traced fits
    per_epoch = ps.steady(lambda epochs: model.fit(x1, x2, cell_type=types, epochs=epochs))
    lines = ps.table("scMoGNN v2 epoch (one 5,000-cell step + the full-graph validation "
                     "forward)", per_epoch, untraced)
    return lines, 1 - sum(ms for ms, _ in per_epoch.values()) / untraced


def steady_over(fn, n: int) -> dict:
    """Per epoch: ``fn(1 + n)`` traced less ``fn(1)`` traced, over ``n`` (for
    epochs too long to trace ten of)."""
    short, long_ = ps.traced(lambda: fn(1)), ps.traced(lambda: fn(1 + n))
    return {k: ((ms - short.get(k, (0.0, 0))[0]) / n, (c - short.get(k, (0.0, 0))[1]) / n)
            for k, (ms, c) in long_.items()}


def joint_embedding_lines(x1, x2, types, cuda, which) -> list:
    """DCCA's, JAE's and scMVAE's tables (chip_smoke phases 43-45)."""
    lines = []
    if "dcca" in which:
        dcca = DCCA(seed=0, device=cuda)

        def fit_dcca(epochs):
            dcca.fit(x1, x2, epochs=epochs)

        fit_dcca(30)
        untraced = sum(untraced_ms([h for h in dcca.history if h["phase"] == p])
                       for p in range(3))
        lines += ps.table("DCCA epoch of its three phases (3 full-batch steps on 10,000 cells)",
                          ps.steady(fit_dcca), untraced)
    if "jae" in which:
        jae = JAEWrapper(seed=0, device=cuda)

        def fit_jae(epochs):
            jae.fit(x1, x2, cell_type=types, epochs=epochs)

        fit_jae(5)
        lines += ps.table("JAE epoch (157 Adam steps of 64 cells; traced 1 + 2 epochs less 1, "
                          "over 2, not 10)", steady_over(fit_jae, 2), untraced_ms(jae.history))
    if "scmvae" in which:
        scmvae = scMVAE(seed=0, n_centroids=cs.SV_CENTROIDS, device=cuda)
        c1, c2 = np.expm1(x1), np.expm1(np.abs(x2))

        def fit_scmvae(epochs):
            scmvae.fit(c1, c2, epochs=epochs)

        fit_scmvae(5)
        lines += ps.table("scMVAE epoch (157 AdamW steps of 64 cells; traced 1 + 2 epochs less "
                          "1, over 2, not 10)", steady_over(fit_scmvae, 2),
                          untraced_ms(scmvae.history))
    return lines


def main():
    which = sys.argv[1:] or MODELS
    if set(which) - set(MODELS):
        raise SystemExit(f"models: {' '.join(MODELS)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda")
    lines = [cs.card_line()]
    x1, x2, types = cs.match_inputs()
    tr = slice(0, cs.MT_TRAIN)
    x1, x2, types, counts = x1[tr], x2[tr], types[tr].astype(str), np.expm1(x1[tr])
    lines += joint_embedding_lines(x1, x2, types, cuda, which)
    if "v2" in which:
        v2 = ScMoGCNWrapperV2(seed=0, early_stopping=10 ** 9, device=cuda)
        v2.fit(x1, x2, cell_type=types, epochs=30)
        lines += v2_profile(x1, x2, types, cuda, untraced_ms(v2.history))[0]
    if "babel" in which:
        lines += babel_lines(counts, x2, cuda)
    if "cmae" in which:
        lines += cmae_lines(x1, x2, cuda)
    if "scmm" in which:
        lines += scmm_lines(counts, x2, cuda)
    print("\n".join(lines), flush=True)


def babel_lines(counts, x2, cuda) -> list:
    babel = BabelWrapper(seed=0, device=cuda)

    def fit_babel(epochs):  # no validation: the JAX benchmark's timing setting
        babel.net = None
        babel.fit(counts, x2, val_ratio=0, epochs=epochs, batch_size=cs.AE_BATCH)

    fit_babel(10)
    return ps.table(f"BABEL epoch (batch {cs.AE_BATCH})", ps.steady(fit_babel),
                    untraced_ms(babel.history))


def cmae_lines(x1, x2, cuda) -> list:
    cmae = CMAE(seed=0, device=cuda)

    def fit_cmae(epochs):
        cmae.fit(x1, x2, epochs=epochs)

    fit_cmae(5)
    return ps.table("CMAE epoch (156 discriminator + generator steps, batch 64)",
                    ps.steady(fit_cmae), untraced_ms(cmae.history))


def scmm_lines(counts, x2, cuda) -> list:
    lines = []
    for reference in (False, True):
        scmm = MMVAE(seed=0, reference_protocol=reference, device=cuda)

        def fit_scmm(epochs):
            scmm.net = None
            scmm.fit(counts, x2, epochs=epochs, batch_size=cs.AE_BATCH)

        fit_scmm(10)
        lines += ps.table(f"scMM epoch (batch {cs.AE_BATCH}, reference_protocol={reference})",
                          ps.steady(fit_scmm), untraced_ms(scmm.history))
    return lines


if __name__ == "__main__":
    main()
