"""Rank workers of the data-parallel tests (test_torch_parallel*.py).

Imports no JAX: the spawned ranks import this module to find their
function. :func:`run_ranks` writes the parent's inputs (numpy arrays and
state dicts, JAX's side computed in the parent) to a pickle under the test's
``tmp_path``, launches the ranks on gloo with the CPU as their device, each
through its own ``file://`` store in that folder and with one torch thread,
every collective bounded by a 60 s timeout and the join by 150 s, and reads
each rank's results back from its own pickle.
"""

import os
import pickle
import sys

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from dance_tpu_torch.parallel import mesh as pm

TIMEOUT, JOIN_TIMEOUT = 60.0, 150.0


def run_ranks(case: str, world: int, tmp_path, payload: dict) -> list:
    """``CASES[case](rank, payload)`` on ``world`` gloo ranks; returns
    the ranks' results in rank order."""
    folder = os.path.join(str(tmp_path), f"{case}_{world}")
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "in.pkl"), "wb") as f:
        pickle.dump(payload, f)
    pm.launch(_rank, world, "gloo", "cpu", args=(case, folder), rendezvous_dir=folder,
              timeout=TIMEOUT, join_timeout=JOIN_TIMEOUT, num_threads=1)
    out = []
    for r in range(world):
        with open(os.path.join(folder, f"out{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank(rank: int, case: str, folder: str):
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    with open(os.path.join(folder, "in.pkl"), "rb") as f:
        payload = pickle.load(f)
    result = CASES[case](rank, payload)
    with open(os.path.join(folder, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def raising_rank(rank: int, *_):
    """A rank that fails at once (the launch must raise)."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")


# ---------------------------------------------------------------------------
# shared inputs (numpy, seeded)
# ---------------------------------------------------------------------------


def spmm_inputs(n: int, d: int = 6, seed: int = 0):
    """A random square CSR (one empty row), features, an alpha index over 5
    values, the alpha values and output weights for a gradient."""
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=0.15, random_state=seed, format="lil", dtype=np.float32)
    a[3] = 0
    a = sp.csr_matrix(a)
    return {"adj": a, "h": rng.normal(size=(n, d)).astype(np.float32),
            "alpha_idx": rng.integers(0, 5, a.nnz).astype(np.int32),
            "alpha": rng.normal(size=5).astype(np.float32),
            "w": rng.normal(size=(n, d)).astype(np.float32)}


def cell_gene_graph(seed: int, n_cells: int = 56, n_genes: int = 8, dim: int = 8):
    """The port's cell-gene graph of test_parallel.py:262-321's shapes and
    labels in three types."""
    from dance_tpu_torch.graph import Graph
    rng = np.random.default_rng(seed)
    expr = sp.random(n_cells, n_genes, density=0.3, random_state=seed, dtype=np.float32,
                     format="csr")
    g = Graph.from_cell_feature_matrix(expr, rng.random((n_cells, dim), dtype=np.float32),
                                       rng.random((n_genes, dim), dtype=np.float32))
    return g, rng.integers(0, 3, n_cells)


def zoo_inputs():
    """test_parallel.py:97-138's dense inputs: 64 cells, 30 counts, 10 targets."""
    rng = np.random.default_rng(0)
    n, d1, d2 = 64, 30, 10
    x = rng.poisson(2.0, (n, d1)).astype(np.float32)
    w = np.abs(rng.normal(0, 0.2, (d1, d2))).astype(np.float32)
    y = np.maximum(x @ w, 0).astype(np.float32)
    counts = rng.poisson(3.0, (n, d1)).astype(np.float32)
    norm = ((counts - counts.mean(0)) / np.maximum(counts.std(0), 1e-6)).astype(np.float32)
    return x, y, counts, norm


# ---------------------------------------------------------------------------
# the dense zoo: each model's fit, single or as one rank of a dp fit
# ---------------------------------------------------------------------------


def _state(module) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in module.state_dict().items()}


def zoo_fit(name: str, mesh=None) -> dict:
    """One model of the dense zoo fitted from its seed on the CPU: its
    weights, losses and predictions (``fit_distributed`` on ``mesh`` when
    given)."""
    from dance_tpu_torch.modules.multi_modality.predict_modality import CMAE, MMVAE, BabelWrapper
    from dance_tpu_torch.modules.single_modality.clustering import ScDeepCluster
    from dance_tpu_torch.modules.single_modality.imputation import DeepImpute
    x, y, counts, norm = zoo_inputs()

    def fit(model, *args, **kw):
        if mesh is None:
            return model.fit(*args, **kw)
        return model.fit_distributed(*args, mesh=mesh, **kw)

    if name == "babel":
        m = BabelWrapper(dim_in=30, dim_out=10, hidden=16, seed=0, device="cpu")
        fit(m, x, y, epochs=3, batch_size=16, earlystop=1)
        return {"state": _state(m.net), "loss": [h["loss"] for h in m.history],
                "val": [h["val"] for h in m.history], "pred": m.predict(x)}
    if name == "cmae":
        m = CMAE(dim1=30, dim2=10, z_dim=8, hidden=16, seed=0, device="cpu")
        fit(m, x, y, epochs=2, batch_size=16)
        return {"state": _state(m.net), "disc": _state(m.disc), "pred": m.predict(x),
                "loss": [h["g_loss"] for h in m.history]}
    if name == "scmm":
        m = MMVAE("rna-protein", z_dim=8, seed=0, device="cpu")
        fit(m, x, y, epochs=2, batch_size=16)
        return {"state": _state(m.net), "loss": [h["loss"] for h in m.history],
                "pred": m.predict(x)}
    if name.startswith("deepimpute"):
        targets = [list(range(0, 15)), list(range(15, 30))]
        predictors = [list(range(15, 30)), list(range(0, 15))]
        m = DeepImpute(predictors, targets, "t", sub_outputdim=15, hidden_dim=16, device="cpu",
                       reference_protocol=name.endswith("reference"))
        x_log = np.log1p(x)
        fit(m, x_log, x_log, n_epochs=3, batch_size=16, patience=2)
        return {"state": _state(m.net), "loss": [h["loss"] for h in m.history],
                "val": [h["val"] for h in m.history], "pred": m.predict(x_log)}
    if name == "scdeepcluster":
        m = ScDeepCluster(input_dim=30, z_dim=4, encodeLayer=(16,), decodeLayer=(16,),
                          sigma=1.0, seed=0, device="cpu")
        fit(m, (norm, counts, counts.sum(1)), None, n_clusters=3, epochs=2, pt_epochs=3,
            batch_size=16, pt_batch_size=16, tol=0.0)
        return {"state": _state(m.model), "mu": m.mu.detach().numpy().copy(),
                "loss": [h["loss"] for h in m.history],
                "pt_loss": [h["loss"] for h in m.pretrain_history], "q": m.q}
    raise ValueError(name)


ZOO = ("babel", "cmae", "scmm", "deepimpute", "deepimpute_reference", "scdeepcluster")


# ---------------------------------------------------------------------------
# vmapped trials
# ---------------------------------------------------------------------------


def trial_problem(params_by_seed: dict):
    """``init_fn``, ``loss_fn`` and data of the trials test: a VanillaMLP(10
    -> 8 -> 1) regression with an ``l2`` penalty on every parameter, its
    initial weights looked up by seed."""
    from dance_tpu_torch.nn.mlp import VanillaMLP
    rng = np.random.default_rng(1)
    x = rng.random((64, 10), dtype=np.float32)
    y = (x @ rng.random((10, 1), dtype=np.float32)).ravel()
    model = VanillaMLP(10, 1, (8,))
    data = (torch.from_numpy(x), torch.from_numpy(y))

    def init_fn(seed):
        return {k: torch.from_numpy(np.array(v)) for k, v in params_by_seed[seed].items()}

    def loss_fn(params, batch, hyper):
        bx, by = batch
        pred = torch.func.functional_call(model, params, (bx,)).reshape(-1)
        l2 = sum((p ** 2).sum() for p in params.values())
        return ((pred - by) ** 2).mean() + hyper["l2"] * l2

    def score_fn(params):
        pred = torch.func.functional_call(model, params, (data[0],)).reshape(-1)
        return -float(((pred - data[1]) ** 2).mean())

    return init_fn, loss_fn, data, score_fn


TRIAL_LRS = [1e-2, 3e-3, 1e-3, 1e-2, 3e-3, 1e-3, 5e-3, 2e-3]
TRIAL_L2 = [0.0, 0.0, 0.0, 0.01, 0.01, 0.01, 0.001, 0.001]
TRIAL_STEPS = 60


def run_trials(params_by_seed: dict, mesh=None) -> dict:
    from dance_tpu_torch.parallel.trials import select_best_trial, vmapped_trials
    init_fn, loss_fn, data, score_fn = trial_problem(params_by_seed)
    params, losses = vmapped_trials(init_fn, loss_fn, data, seeds=list(range(8)),
                                    hyperparams={"l2": TRIAL_L2}, lr=TRIAL_LRS,
                                    num_steps=TRIAL_STEPS, mesh=mesh, device="cpu")
    scores = [score_fn({k: v[i] for k, v in params.items()}) for i in range(8)]
    _, best = select_best_trial(params, scores)
    return {"losses": losses, "params": {k: v.numpy() for k, v in params.items()},
            "scores": scores, "best": best}


# ---------------------------------------------------------------------------
# rank cases
# ---------------------------------------------------------------------------


def _spmm_case(payload, mesh):
    """sharded_spmm sum / mean / edge-scaled / unweighted on each graph, and
    the gradient of a weighted sum of the outputs through the sum."""
    from dance_tpu_torch.parallel.sharded_graph import shard_csr, sharded_spmm
    out = {}
    for n in payload["spmm_sizes"]:
        inp = spmm_inputs(n)
        s = shard_csr(inp["adj"], mesh, edge_data={"alpha_idx": inp["alpha_idx"]}, device="cpu")
        shard = pm.RowShard(n, mesh)
        h = shard.rows(inp["h"]).requires_grad_()
        scale = torch.from_numpy(inp["alpha"]).index_select(0, s.edge_data["alpha_idx"])
        res = {"sum": sharded_spmm(s, h), "mean": sharded_spmm(s, h, op="mean"),
               "scaled": sharded_spmm(s, h, edge_scale=scale),
               "unweighted": sharded_spmm(s, h, weighted=False)}
        (res["sum"] * shard.rows(inp["w"], fill=0.0)).sum().backward()
        out[n] = {k: shard.gather(v).numpy() for k, v in res.items()}
        out[n]["grad"] = shard.gather(h.grad).numpy()
        out[n]["chunk"] = {"data": s.data.numpy(), "indices": s.indices.numpy(),
                           "local_rows": s.local_rows.numpy(),
                           "alpha_idx": s.edge_data["alpha_idx"].numpy(),
                           "rows_per_shard": s.rows_per_shard, "n_edges": s.n_edges,
                           "degrees": s.degrees.numpy()}
    return out


def _graph_fits(payload, mesh, with_jax: bool):
    """scDeepSort and graph-sc ``fit_distributed``: from the seeds' own
    weights (graph-sc with its default dropout 0.1), and, with ``with_jax``,
    from JAX's initial weights with dropout off."""
    from dance_tpu_torch.modules.single_modality.cell_type_annotation import ScDeepSort
    from dance_tpu_torch.modules.single_modality.cell_type_annotation import scdeepsort as tsds
    from dance_tpu_torch.modules.single_modality.clustering import GraphSC
    out = {}
    g, labels = cell_gene_graph(1)
    m = ScDeepSort(8, 16, 2, seed=0, device="cpu")
    m.fit_distributed(g, labels, mesh=mesh, epochs=5)
    out["scdeepsort"] = {"proba": m.predict_proba(g), "loss": [h["loss"] for h in m.history],
                         "edges": m._train_state[0].n_edges}
    g2, _ = cell_gene_graph(2)
    gs = GraphSC(n_clusters=3, seed=0, device="cpu")
    gs.fit_distributed(g2, mesh=mesh, epochs=5)
    out["graphsc"] = {"z": gs.get_latent(), "loss": [h["loss"] for h in gs.history]}
    if with_jax:
        state = {k: torch.from_numpy(v) for k, v in payload["scdeepsort_init"].items()}
        reset = tsds.GNN.reset_parameters

        def from_jax(self, generator=None):
            reset(self, generator)
            self.load_state_dict(state)

        tsds.GNN.reset_parameters = from_jax
        try:
            m = ScDeepSort(8, 16, 2, seed=0, device="cpu")
            m.fit_distributed(g, labels, mesh=mesh, epochs=5)
        finally:
            tsds.GNN.reset_parameters = reset
        out["scdeepsort_jax"] = {"proba": m.predict_proba(g)}
        gs = GraphSC(n_clusters=3, seed=0, dropout=0.0, device="cpu")
        gs.fit(g2, epochs=0, use_bsr=False)
        gs.model.load_state_dict({k: torch.from_numpy(v)
                                  for k, v in payload["graphsc_init"].items()})
        gs.fit_distributed(g2, mesh=mesh, epochs=5)
        out["graphsc_jax"] = {"z": gs.get_latent()}
    return out


def _actinn_case(payload, mesh):
    from dance_tpu_torch.modules.single_modality.cell_type_annotation import ACTINN
    state = {k: torch.from_numpy(v) for k, v in payload["actinn_init"].items()}
    make = ACTINN._make_net

    def from_jax(self, *args):
        net = make(self, *args)
        net.load_state_dict(state)
        return net

    ACTINN._make_net = from_jax
    try:
        m = ACTINN(hidden_dims=(12, 8, 6), device="cpu")
        m.fit_distributed(payload["actinn_x"], payload["actinn_y"], mesh=mesh, batch_size=32,
                          lr=0.01, num_epochs=3, seed=7)
    finally:
        ACTINN._make_net = make
    return {"loss": [h["loss"] for h in m.history], "state": _state(m.model),
            "proba": m.predict_proba(payload["actinn_x"])}


def _placement_case(payload, mesh):
    """to_device inside and outside dp_context, shard_batch, replicate and a
    checkpoint round trip under the mesh."""
    from dance_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    x = np.arange(15, dtype=np.float32).reshape(5, 3)
    out = {"outside": pm.to_device(x, device="cpu").numpy()}
    with pm.dp_context(mesh):
        out["pad"] = pm.to_device(x, device="cpu").numpy()
        out["nopad"] = pm.to_device(x, pad=False, device="cpu").numpy()
        out["even"] = pm.to_device(x[:4], pad=False, device="cpu").numpy()
        out["scalar"] = pm.to_device(np.float32(2.5), device="cpu").numpy()
    out["batch"] = [t.numpy() for t in pm.shard_batch((x, np.arange(5)), mesh)]
    t = torch.full((3,), float(mesh.rank))
    out["replicated"] = pm.replicate({"t": t}, mesh)["t"].numpy()
    net = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(net.weight, float(mesh.rank))
    pm.replicate(net, mesh)
    out["replicated_module"] = net.weight.detach().numpy()
    path = os.path.join(payload["folder"], "ckpt.pt")
    state = {"w": torch.arange(6.0).reshape(2, 3) * (mesh.rank + 1), "step": 7}
    save_checkpoint(path, state, mesh=mesh)
    out["ckpt"] = load_checkpoint(path)
    return out


def _train_step_case(payload, mesh):
    """Five dp x tp steps of a VanillaMLP(128 -> 64 -> 32 -> 4) from JAX's
    weights, the hidden layers column-sharded (min_size 1024)."""
    from dance_tpu_torch.nn.mlp import VanillaMLP
    from dance_tpu_torch.parallel.train import init_sharded, make_sharded_train_step
    state = {k: torch.from_numpy(v) for k, v in payload["mlp_init"].items()}

    def factory():
        net = VanillaMLP(128, 4, (64, 32))
        net.load_state_dict(state)
        return net

    x, y = payload["mlp_x"], payload["mlp_y"].astype(np.int64)
    net, opt = init_sharded(factory, lambda p: torch.optim.Adam(p, lr=1e-2), (x, y), mesh,
                            tp_min_size=1024, device="cpu")

    def loss_fn(module, batch):
        bx, by = batch
        return F.cross_entropy(module(bx), by)

    step = make_sharded_train_step(loss_fn, opt, mesh)
    batch = pm.shard_batch((x, y), mesh, device="cpu")
    losses = [float(step(net, batch)) for _ in range(5)]
    sharded = [type(layer).__name__ for layer in net.layers]
    return {"losses": losses, "state": {k: v.numpy() for k, v in pm.full_state_dict(net).items()},
            "layers": sharded}


def two_rank_case(rank: int, payload: dict) -> dict:
    mesh = pm.get_mesh((2, 1))
    out = {"spmm": _spmm_case(payload, mesh), "placement": _placement_case(payload, mesh)}
    out.update(_graph_fits(payload, mesh, with_jax=True))
    out["actinn"] = _actinn_case(payload, mesh)
    out["zoo"] = {name: zoo_fit(name, mesh) for name in ZOO}
    out["trials"] = run_trials(payload["trial_params"], mesh)
    return out


def four_rank_case(rank: int, payload: dict) -> dict:
    from dance_tpu_torch.modules.single_modality.clustering import GraphSC
    out = {"spmm": _spmm_case(payload, pm.get_mesh((4, 1)))}
    out.update(_graph_fits(payload, pm.current_mesh(), with_jax=False))
    g2, _ = cell_gene_graph(2)
    gs = GraphSC(n_clusters=3, agg="mean", seed=0, device="cpu")
    gs.fit_distributed(g2, mesh=pm.current_mesh(), epochs=5)
    out["graphsc_mean"] = {"z": gs.get_latent()}
    out["train_step"] = _train_step_case(payload, pm.get_mesh((2, 2)))
    return out


CASES = {"two": two_rank_case, "four": four_rank_case}
