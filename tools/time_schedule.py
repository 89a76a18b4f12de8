"""Time the tensor-core kernels at several work-item sizes on the main
paths' tilings: ``ops.bsr.ITEMS_PER_SLOT`` (work items per resident thread
block; the chunk of a split block-row shrinks as it grows) set to 2, 3 and
4, in the order 2, 3, 4, 4, 3, 2 so that a drift of the card cancels.

Run from the root of the checkout on a machine with a CUDA card:

    python3 tools/time_schedule.py

Prints, per setting, the work items and the back-to-back time per call of
``bsr_spmm`` (scDeepSort's tiling at d = 256, graph-sc's at d = 200) and
``bsr_gat_stats`` (STAGATE's RCM tiling at d = 512). Imports no JAX.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import numpy as np
import scipy.sparse as sp
import torch

import chip_smoke as cs
from dance_tpu_torch.graph import Graph
from dance_tpu_torch.modules.single_modality.clustering import graphsc_preprocess
from dance_tpu_torch.modules.spatial.spatial_domain import stagate_preprocess
from dance_tpu_torch.ops import bsr

torch.backends.cuda.matmul.allow_tf32 = False
cuda = torch.device("cuda")
print(cs.card_line(), flush=True)
gen = torch.Generator().manual_seed(0)
rng = np.random.default_rng(0)
expr = sp.random(cs.N_CELLS, cs.N_GENES, density=cs.DENSITY, random_state=0, dtype=np.float32,
                 format="csr")
scd = Graph.from_cell_feature_matrix(expr, rng.random((cs.N_CELLS, 8), dtype=np.float32),
                                     rng.random((cs.N_GENES, 8), dtype=np.float32))
a_scd = scd.to_adaptive_bsr(device=cuda).bsr
counts, _ = cs.clustered_counts(cs.GSC_CELLS, cs.GSC_GENES, cs.GSC_TYPES, seed=0)
gsc, _ = graphsc_preprocess(counts, n_top_genes=cs.GSC_HVG, device=cuda)
a_gsc = gsc.to_bsr(device=cuda)
counts, xy, _ = cs.spatial_counts(cs.N_SPOTS, cs.N_RAW_GENES, cs.N_DOMAINS, seed=0)
_, adj = stagate_preprocess(counts, xy, n_top_genes=cs.N_HVG, model_name="knn",
                            n_neighbors=cs.N_NEIGHBORS)
_, a_st = bsr.bsr_with_rcm(sp.csr_matrix(adj) + sp.eye(cs.N_SPOTS, format="csr",
                                                       dtype=np.float32))
a_st = a_st.to(cuda)
b_scd = torch.randn((a_scd.shape[1], cs.DIM), generator=gen).to(cuda)
b_gsc = torch.randn((a_gsc.shape[1], cs.GSC_HIDDEN), generator=gen).to(cuda)
er = torch.randn(a_st.shape[0], generator=gen).to(cuda)
el = torch.randn(a_st.shape[1], generator=gen).to(cuda)
h = torch.randn((a_st.shape[1], cs.STAGATE_DIMS[1]), generator=gen).to(cuda)
runs = {"bsr_spmm scDeepSort d=256": (a_scd, lambda: bsr.bsr_spmm(a_scd, b_scd)),
        "bsr_spmm graph-sc d=200": (a_gsc, lambda: bsr.bsr_spmm(a_gsc, b_gsc)),
        "bsr_gat_stats STAGATE d=512": (a_st, lambda: bsr.bsr_gat_stats(a_st, er, el, h,
                                                                       act="sigmoid"))}
default = bsr.ITEMS_PER_SLOT
times = {}
for ips in (2, 3, 4, 4, 3, 2):
    bsr.ITEMS_PER_SLOT = ips
    for name, (mat, fn) in runs.items():
        mat._schedules.clear()
        ms = cs.median_ms(fn, inner=cs.STREAM)
        items = len(next(iter(mat._schedules.values())).schedule.items)
        times.setdefault((name, ips), []).append(ms)
        print(f"ITEMS_PER_SLOT={ips} {name}: {items} work items, {ms!r} ms per call over "
              f"{cs.STREAM} back to back", flush=True)
bsr.ITEMS_PER_SLOT = default
for (name, ips), ms in sorted(times.items()):
    print(f"mean of both passes, ITEMS_PER_SLOT={ips} {name}: {sum(ms) / len(ms)!r} ms",
          flush=True)
