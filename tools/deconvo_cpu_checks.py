"""Two measurements on the CPU (no card, no times) behind PERF.md's
deconvolution notes, printed:

1. DSTG at half the chip_smoke size (1,000 reference cells x 1,000 genes,
   500 pseudo + 2,000 real spots, k_filter 30, num_cc 10), 300 epochs on
   CSR: the real spots' portion MSE on ``dstg_preprocess``'s PCA features,
   on the same features standardised per component, and the uniform
   guess's.
2. stdGCN's 3-epoch fit of tests/test_torch_stdgcn.py (the same inputs,
   graphs and weights): the port's predictions against JAX's, and JAX's
   own CSR fit against its dense fit (the spread that test holds the port
   to).

    PYTHONPATH=. JAX_PLATFORMS=cpu python3 tools/deconvo_cpu_checks.py

Needs the JAX package (the second part compares against it); the first
part imports no JAX.
"""
import sys
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))
import numpy as np
import torch

import chip_smoke as cs
from dance_tpu_torch.modules.spatial.cell_type_deconvo import DSTG, dstg_preprocess


def dstg_half_size():
    cpu = torch.device("cpu")
    x_ref, labels, x_real, portions, _ = cs.deconvo_inputs(1000, 1000, 8, 2000, seed=5)
    inp = dstg_preprocess(x_ref, labels, x_real, n_pseudo=500, k_filter=30, num_cc=10,
                          device=cpu)
    uniform = float(((portions - 1 / 8) ** 2).mean())
    for name, feats in (("PCA features", inp.x), ("standardised", inp.x / inp.x.std(0))):
        m = DSTG(seed=0, device=cpu).fit((feats, inp.adj), inp.y, use_bsr=False)
        mse = float(((m.predict()[500:] - portions) ** 2).mean())
        print(f"DSTG half size, {name}: real-spot MSE {mse!r} (uniform guess {uniform!r})",
              flush=True)


def stdgcn_spread():
    import test_torch_stdgcn as t
    from dance_tpu.modules.spatial.cell_type_deconvo import stdgcn as jstdgcn
    from dance_tpu.ops import pallas_kernels as jpk
    from dance_tpu_torch.modules.spatial.cell_type_deconvo import StdGCN
    from dance_tpu_torch.modules.spatial.cell_type_deconvo import stdgcn as tstdgcn
    from dance_tpu_torch.utils.params import stdgcn_flax_to_torch

    graphs = t._graphs(0)
    feat, coords, y = t._inputs()
    coords_all = np.concatenate([np.zeros((t.N_PSEUDO, 2), np.float32), coords])
    preds = {}
    with mock.patch.object(jstdgcn, "build_stdgcn_adjacencies", lambda *a, **k: graphs), \
            mock.patch.object(tstdgcn, "build_stdgcn_adjacencies", lambda *a, **k: graphs):
        for fmt in ("csr", "dense"):
            with mock.patch.object(jpk, "choose_adj_format", lambda *a, **k: fmt):
                jm = jstdgcn.StdGCN(hidden=(16,), dropout=0.0, seed=0)
                jm.fit((feat, coords_all), y, max_epochs=3, use_bsr="auto")
                preds[fmt] = jm.predict()
        _, init = t._jax_net(feat, y)
        tm = StdGCN(hidden=(16,), dropout=0.0, seed=0, device="cpu")
        state = stdgcn_flax_to_torch(t._np_tree(init))
        make = tm._make_net
        tm._make_net = lambda *a: _loaded(make, a, state)
        tm.fit((feat, coords_all), y, max_epochs=3, use_bsr=False)
    port = tm.predict()
    print(f"stdGCN 3 epochs: port against JAX (CSR) {float(np.abs(port - preds['csr']).max())!r};"
          f" JAX CSR against JAX dense {float(np.abs(preds['csr'] - preds['dense']).max())!r}",
          flush=True)


def _loaded(make, args, state):
    net = make(*args)
    net.load_state_dict(state)
    return net


if __name__ == "__main__":
    dstg_half_size()
    stdgcn_spread()
