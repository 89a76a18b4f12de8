#!/usr/bin/env python3
"""The data-parallel path on every card of one machine, one NCCL rank a card.

    python3 tools/scale_out_cards.py        # needs 2 or more cards

On chip_smoke's inputs (phase 2's scDeepSort graph, 12,000 x 2,000 at
d = 256; phase 8's graph-sc graph of ~13,000 nodes; phase 27's ACTINN
cells), fits scDeepSort (5 epochs) and graph-sc (30 epochs) with
``fit_distributed`` on N NCCL ranks (the adjacency block-row-sharded) and
holds them against the single-card CSR fits run here first (chip_smoke's
bounds: probabilities 2e-3, embeddings 8e-3); runs ``vmapped_trials`` with
the trial axis over the N ranks against one card (parameters 5e-3); then
``dryrun_multichip(N, "nccl")`` (dp N/2 x tp 2). Prints every fit's epoch
times, the edges each rank stores and every gap; exits non-zero on a gap
past its bound. Unlike chip_smoke's phases 66-70, whose ranks share one
card over gloo, the collectives here are NCCL's over NVLink.
"""

import os
import pickle
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import numpy as np
    import scipy.sparse as sp
    import torch

    from dance_tpu_torch.graph import Graph
    from dance_tpu_torch.modules.single_modality.cell_type_annotation import (
        ScDeepSort, actinn_preprocess)
    from dance_tpu_torch.modules.single_modality.clustering import GraphSC, graphsc_preprocess
    from dance_tpu_torch.parallel.dryrun import dryrun_multichip
    from dance_tpu_torch.parallel.trials import vmapped_trials
    from dance_tpu_torch.transforms import weighted_feature_pca

    n = torch.cuda.device_count()
    if n < 2:
        print(f"scale_out_cards: {n} card(s); this needs 2 or more", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, {n} cards", flush=True)
    rng = np.random.default_rng(0)
    expr = sp.random(cs.N_CELLS, cs.N_GENES, density=cs.DENSITY, random_state=0,
                     dtype=np.float32, format="csr")
    labels = rng.integers(0, cs.N_LABELS, cs.N_CELLS)
    graph = Graph.from_cell_feature_matrix(expr, *weighted_feature_pca(expr, expr, cs.DIM,
                                                                       device=cuda))
    counts, _ = cs.clustered_counts(cs.GSC_CELLS, cs.GSC_GENES, cs.GSC_TYPES, seed=0)
    gsc_graph, _ = graphsc_preprocess(counts, n_top_genes=cs.GSC_HVG, device=cuda)
    acounts, types = cs.annotation_counts(cs.HN_CELLS, cs.HN_GENES, cs.HN_TYPES, cs.HN_RARE,
                                          seed=13)
    x, _ = actinn_preprocess(acounts, cs.gene_names(cs.HN_GENES))
    train = np.sort(np.random.default_rng(21).permutation(len(types))[:int(0.6 * len(types))])
    folder = tempfile.mkdtemp(prefix="scale_out_cards_")
    with open(f"{folder}/in.pkl", "wb") as f:
        pickle.dump({"actinn": (x[train], types[train]), "scdeepsort": (graph, labels),
                     "graphsc": gsc_graph}, f)

    ref = ScDeepSort(dim_in=cs.DIM, dim_hid=cs.DIM, num_layers=2, seed=0, device=cuda)
    t0 = time.perf_counter()
    ref.fit(graph, labels, epochs=cs.EPOCHS, val_ratio=0.2, use_bsr=False)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    gref = GraphSC(n_clusters=cs.GSC_TYPES, seed=0, device=cuda)
    t0 = time.perf_counter()
    gref.fit(gsc_graph, epochs=cs.GSC_EPOCHS, use_bsr=False)
    torch.cuda.synchronize()
    t_gref = time.perf_counter() - t0
    _, init_fn, loss_fn, data = cs.trial_problem(x[train], types[train], cs.HN_TYPES, cuda)
    params, _ = vmapped_trials(init_fn, loss_fn, data, seeds=range(cs.SO_TRIALS),
                               hyperparams={"l2": cs.SO_TRIAL_L2}, lr=cs.SO_TRIAL_LRS,
                               num_steps=cs.SO_STEPS, device=cuda)

    ranks = cs.run_scale_out(folder, n, "nccl", ["scdeepsort", "graphsc", "trials"])
    sds, gs = ranks[0]["scdeepsort"], ranks[0]["graphsc"]
    p_gap = max(float(np.abs(r["scdeepsort"]["proba"] - ref.predict_proba(graph)).max())
                for r in ranks)
    z_gap = max(float(np.abs(r["graphsc"]["z"] - gref.get_latent()).max()) for r in ranks)
    t_gap = max(float(np.abs(r["trials"]["params"][k] - v.cpu().numpy()).max())
                for r in ranks for k, v in params.items())
    print(f"scDeepSort CSR on 1 card: fit {t_ref:.3f} s, {cs.epoch_line(ref.history)}; on {n} "
          f"NCCL ranks: fit {sds['seconds']:.3f} s, {cs.epoch_line(sds['history'])}; edges per "
          f"rank {[r['scdeepsort']['edges'] for r in ranks]} of {graph.num_edges}; max "
          f"probability gap {p_gap!r} (bound {cs.SO_SDS_PROB})", flush=True)
    print(f"graph-sc CSR on 1 card: fit {t_gref:.3f} s, {cs.epoch_line(gref.history)}; on {n} "
          f"NCCL ranks: fit {gs['seconds']:.3f} s, {cs.epoch_line(gs['history'])}; edges per "
          f"rank {[r['graphsc']['edges'] for r in ranks]} of {gsc_graph.num_edges}; max "
          f"embedding gap {z_gap!r} (bound {cs.SO_GSC_Z})", flush=True)
    print(f"vmapped trials over {n} NCCL ranks: {ranks[0]['trials']['seconds']:.3f} s; "
          f"parameters against one card: max gap {t_gap!r} (bound {cs.SO_TRIAL_SPLIT})",
          flush=True)
    t0 = time.perf_counter()
    line = dryrun_multichip(n, "nccl")
    print(f"{line} in {time.perf_counter() - t0:.3f} s", flush=True)
    shutil.rmtree(folder, ignore_errors=True)
    ok = p_gap <= cs.SO_SDS_PROB and z_gap <= cs.SO_GSC_Z and t_gap <= cs.SO_TRIAL_SPLIT
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
