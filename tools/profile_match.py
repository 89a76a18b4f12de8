"""Steady match-modality scMoGNN epochs at full width on the card: the
untraced epoch and a torch.profiler breakdown by kernel and by layer.

Run from the root of the checkout on a machine with a CUDA card; it uses
``chip_smoke.py``'s data maker and sizes (10,000 training + 2,000 test cells
x 2,000 genes, log1p, <-> 134 proteins; ``latent_dim`` 64, batch 4,096):

    python3 tools/profile_match.py

It prints the table. An epoch is one 4,096-cell AdamW step and the
validation pass over the 4,096 held-out cells (their 4,096² logits). A
steady epoch's device time is the difference of two traced fits (1 + 10
epochs and 1 epoch, with early stopping off; the propagation of each fit
cancels); the idle share is 1 - that time over the untraced median epoch
(the fit's ``EpochClock``). ``chip_smoke.py`` phase 32 calls
:func:`match_profile`. Imports no JAX.
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
from dance_tpu_torch.modules.multi_modality.match_modality import ScMoGCNWrapper


def match_profile(x1, x2, x1_test, x2_test, device, untraced_ms: float):
    """The steady match epoch's traced breakdown beside ``untraced_ms``:
    returns (the table's lines, the idle share)."""
    model = ScMoGCNWrapper(latent_dim=cs.MT_LATENT, seed=0, device=device)
    per_epoch = ps.steady(lambda epochs: model.fit(x1, x2, x1_test, x2_test, epochs=epochs,
                                                   batch_size=cs.MT_BATCH,
                                                   early_stopping=10 ** 9))
    lines = ps.table("match-modality scMoGNN epoch (one 4,096-cell step + the 4,096² "
                     "validation pass)", per_epoch, untraced_ms)
    device_ms = sum(ms for ms, _ in per_epoch.values())
    return lines, 1 - device_ms / untraced_ms


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda")
    x1, x2, _ = cs.match_inputs()
    tr, te = slice(0, cs.MT_TRAIN), slice(cs.MT_TRAIN, None)
    model = ScMoGCNWrapper(latent_dim=cs.MT_LATENT, seed=0, device=cuda)
    model.fit(x1[tr], x2[tr], x1[te], x2[te], epochs=40, batch_size=cs.MT_BATCH,
              early_stopping=10 ** 9)
    untraced = statistics.median(h["seconds"] for h in model.history[1:]) * 1e3
    lines, _ = match_profile(x1[tr], x2[tr], x1[te], x2[te], cuda, untraced)
    print("\n".join([cs.card_line()] + lines), flush=True)


if __name__ == "__main__":
    main()
