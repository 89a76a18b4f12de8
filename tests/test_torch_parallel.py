"""The port's scale-out layer (dance_tpu_torch.parallel) against the JAX
package's, on the CPU with spawned gloo ranks.

One launch of two ranks (``tests/torch_dist_cases.py``, a module-scoped
fixture) serves most tests: the fixture hands the ranks JAX's initial
weights and computes JAX's fits while they run (on its 8-device CPU mesh,
meshes built directly so that JAX's current mesh is left alone). Each sharded fit is held
against the port's single fit on the CPU, and where the two packages start
from the same weights against JAX's ``fit_distributed``. The four-rank
cases and the dry run are in ``test_torch_parallel_four.py``.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import Mesh as JMesh

import torch_dist_cases as dc
from dance_tpu.graph import Graph as JGraph
from dance_tpu.modules.single_modality.cell_type_annotation.actinn import ACTINN as JACTINN
from dance_tpu.modules.single_modality.cell_type_annotation.scdeepsort import \
    ScDeepSort as JScDeepSort
from dance_tpu.modules.single_modality.clustering.graphsc import GraphSC as JGraphSC
from dance_tpu.nn.mlp import VanillaMLP as JVanillaMLP
from dance_tpu.ops.segment import spmm as jspmm
from dance_tpu.ops.sparse import csr_from_scipy as jcsr_from_scipy
from dance_tpu.parallel.sharded_graph import shard_csr as jshard_csr
from dance_tpu.parallel.trials import vmapped_trials as jvmapped_trials
from dance_tpu_torch.modules.single_modality.cell_type_annotation import (ACTINN, ScDeepSort,
                                                                          actinn_preprocess)
from dance_tpu_torch.modules.single_modality.clustering import GraphSC
from dance_tpu_torch.ops.segment import spmm
from dance_tpu_torch.ops.sparse import csr_from_scipy
from dance_tpu_torch.parallel import mesh as pm
from dance_tpu_torch.parallel.sharded_graph import ShardedCSR, csr_chunks, shard_csr
from dance_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from dance_tpu_torch.utils.params import actinn_flax_to_torch, flax_to_torch, \
    graphsc_flax_to_torch
from dance_tpu_torch.utils.profile import StageTimer, block_timed, trace
from torch_cases import assert_weights, typed_counts

SPMM_SIZES = (37, 40)  # one row count that the ranks do not divide, one that they do


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _np_state(state) -> dict:
    return {k: v.numpy() for k, v in state.items()}


def jax_mesh(dp: int, tp: int = 1) -> JMesh:
    return JMesh(np.asarray(jax.devices()[:dp * tp]).reshape(dp, tp), ("dp", "tp"))


def jax_graph(seed: int, n_cells: int = 56, n_genes: int = 8, dim: int = 8):
    """JAX's twin of ``torch_dist_cases.cell_gene_graph``."""
    rng = np.random.default_rng(seed)
    expr = sp.random(n_cells, n_genes, density=0.3, random_state=seed, dtype=np.float32,
                     format="csr")
    return JGraph.from_cell_feature_matrix(expr, rng.random((n_cells, dim), dtype=np.float32),
                                           rng.random((n_genes, dim), dtype=np.float32))


def actinn_inputs():
    counts, types, names = typed_counts(160, 48, seed=5)
    x, _ = actinn_preprocess(counts, names)
    return x, np.eye(3, dtype=np.float32)[types]


def jax_actinn():
    """JAX's ``fit_distributed`` on a dp = 2 mesh (batch 32, 3 epochs, seed 7),
    its initial weights, and its losses: the function discards them, so the
    test replays its epochs (same permutations, same ``_loss_fn`` and Adam)
    and checks that the replay ends on its weights."""
    x, onehot = actinn_inputs()
    jm = JACTINN(hidden_dims=(12, 8, 6))
    jm.fit_distributed(x, onehot, mesh=jax_mesh(2), batch_size=32, lr=0.01, num_epochs=3,
                       seed=7)
    init = jm.model.init(jax.random.key(7), jnp.asarray(x[:1]))["params"]
    tx = optax.adam(optax.exponential_decay(0.01, 1000, 0.95, staircase=True))
    y = onehot.argmax(1).astype(np.int32)

    @jax.jit
    def step(params, opt_state, bx, by):
        loss, grads = jax.value_and_grad(jm._loss_fn)(params, bx, by, jnp.ones(by.shape))
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    rng, params, opt_state, losses = np.random.default_rng(7), init, tx.init(init), []
    bs, n = 32, x.shape[0]
    nb = max(n // bs, 1)
    for _ in range(3):
        perm = rng.permutation(n)[:nb * bs].reshape(nb, bs)
        epoch = []
        for idx in perm:
            params, opt_state, loss = step(params, opt_state, x[idx], y[idx])
            epoch.append(float(loss))
        losses.append(np.mean(epoch))
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(jm.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7)
    return jm, init, losses


def jax_trial_params():
    """JAX's initial parameters of the 8 trials, as its ``vmapped_trials``
    draws them (``vmap`` of the init over ``key(seed)``)."""
    model = JVanillaMLP(output_dim=1, hidden_dims=(8,))
    keys = jnp.stack([jax.random.key(s) for s in range(8)])
    stacked = jax.vmap(lambda k: model.init(k, jnp.zeros((1, 10)))["params"])(keys)
    return model, {s: _np_state(actinn_flax_to_torch(_np_tree(
        jax.tree_util.tree_map(lambda a: a[s], stacked)))) for s in range(8)}


def jax_trials():
    model, _ = jax_trial_params()
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.random((64, 10), dtype=np.float32))
    y = jnp.asarray((np.asarray(x) @ rng.random((10, 1), dtype=np.float32)).ravel())

    def init_fn(key):
        return model.init(key, jnp.zeros((1, 10)))["params"]

    def loss_fn(params, data, hyper):
        bx, by = data
        pred = model.apply({"params": params}, bx).ravel()
        l2 = sum(jnp.sum(p ** 2) for p in jax.tree_util.tree_leaves(params))
        return jnp.mean((pred - by) ** 2) + hyper["l2"] * l2

    params, losses = jvmapped_trials(init_fn, loss_fn, (x, y), seeds=list(range(8)),
                                     hyperparams={"l2": dc.TRIAL_L2}, lr=dc.TRIAL_LRS,
                                     num_steps=dc.TRIAL_STEPS)
    scores = [-float(jnp.mean((model.apply({"params": jax.tree_util.tree_map(
        lambda a: a[i], params)}, x).ravel() - y) ** 2)) for i in range(8)]
    return np.asarray(losses), scores


def in_background(fn, *args):
    """Run ``fn(*args)`` in a thread; returns a function that waits for and
    returns its result (raising its error)."""
    box = {}

    def target():
        try:
            box["out"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 - re-raised in the caller
            box["err"] = e

    th = threading.Thread(target=target, daemon=True)
    th.start()

    def wait():
        th.join(dc.JOIN_TIMEOUT + 60)
        assert not th.is_alive(), "the ranks' launch did not return"
        if "err" in box:
            raise box["err"]
        return box["out"]

    return wait


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """One launch of two gloo ranks running every two-rank case, from JAX's
    initial weights; JAX's fits run in this process meanwhile."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    x, onehot = actinn_inputs()
    actinn_init = JVanillaMLP(output_dim=3, hidden_dims=(12, 8, 6)).init(
        jax.random.key(7), jnp.asarray(x[:1]))["params"]
    _, labels = dc.cell_gene_graph(1)
    jds = JScDeepSort(dim_in=8, dim_hid=16, num_layers=2, species="s", tissue="t", seed=0)
    jds.fit(jax_graph(1), labels, epochs=0, use_bsr=False)  # the init fit_distributed draws
    jg2 = jax_graph(2)
    jgs = JGraphSC(n_clusters=3, seed=0, dropout=0.0)
    dg = jg2.to_device()
    key = jax.random.key(0)
    jgs.params = jgs.model.init({"params": key, "dropout": key}, dg.adj,
                                dg.ndata["features"])["params"]
    _, trial_params = jax_trial_params()
    payload = {"spmm_sizes": SPMM_SIZES, "folder": str(tmp),
               "actinn_init": _np_state(actinn_flax_to_torch(_np_tree(actinn_init))),
               "actinn_x": x, "actinn_y": onehot,
               "scdeepsort_init": _np_state(flax_to_torch(_np_tree(jds.params))),
               "graphsc_init": _np_state(graphsc_flax_to_torch(_np_tree(jgs.params))),
               "trial_params": trial_params}
    ranks = in_background(dc.run_ranks, "two", 2, tmp, payload)
    jm, init, actinn_losses = jax_actinn()
    for a, b in zip(jax.tree_util.tree_leaves(init), jax.tree_util.tree_leaves(actinn_init)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jds = JScDeepSort(dim_in=8, dim_hid=16, num_layers=2, species="s", tissue="t", seed=0)
    jds.fit_distributed(jax_graph(1), labels, mesh=jax_mesh(2), epochs=5)
    jgs.fit_distributed(jg2, mesh=jax_mesh(2), epochs=5)
    jax_side = {"actinn": jm, "actinn_losses": actinn_losses,
                "scdeepsort_proba": jds.predict_proba(jax_graph(1)),
                "graphsc_z": np.asarray(jgs.get_latent()), "trial_params": trial_params}
    return ranks(), jax_side


# ---------------------------------------------------------------------------
# the block-row partition and the sharded SpMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dp", [2, 4])
def test_csr_chunks_match_jax_shard_csr(dp):
    """The host partition equals JAX's ``shard_csr`` on a (dp, 1) mesh:
    chunks, edge data, rows per shard and degrees (an n that dp does not
    divide, an empty row)."""
    inp = dc.spmm_inputs(37)
    want = jshard_csr(inp["adj"], jax_mesh(dp), edge_data={"alpha_idx": inp["alpha_idx"]})
    got = csr_chunks(inp["adj"], dp, {"alpha_idx": inp["alpha_idx"]})
    for k in ("data", "indices", "local_rows"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(want, k)), err_msg=k)
    np.testing.assert_array_equal(got["alpha_idx"], np.asarray(want.edge_data["alpha_idx"]))
    assert got["rows_per_shard"] == want.rows_per_shard
    np.testing.assert_array_equal(got["degrees"], np.asarray(want.degrees))
    assert got["n_edges"].sum() == inp["adj"].nnz


def test_shard_csr_gives_each_rank_its_chunk(two):
    ranks, _ = two
    for n in SPMM_SIZES:
        inp = dc.spmm_inputs(n)
        want = csr_chunks(inp["adj"], 2, {"alpha_idx": inp["alpha_idx"]})
        for r, res in enumerate(ranks):
            chunk = res["spmm"][n]["chunk"]
            for k in ("data", "indices", "local_rows", "alpha_idx"):
                np.testing.assert_array_equal(chunk[k], want[k][r], err_msg=f"{n} {r} {k}")
            assert chunk["n_edges"] == want["n_edges"][r]
            assert chunk["rows_per_shard"] == want["rows_per_shard"]
            np.testing.assert_array_equal(chunk["degrees"], want["degrees"])


def spmm_references(n):
    """JAX's ``spmm`` for each mode, and the port's one-rank autograd
    gradient of ``sum(w * (A @ h))``."""
    inp = dc.spmm_inputs(n)
    a, h = inp["adj"], jnp.asarray(inp["h"])
    scaled = a.copy()
    scaled.data = a.data * inp["alpha"][inp["alpha_idx"]]
    want = {"sum": jspmm(jcsr_from_scipy(a), h), "mean": jspmm(jcsr_from_scipy(a), h, op="mean"),
            "scaled": jspmm(jcsr_from_scipy(scaled), h),
            "unweighted": jspmm(jcsr_from_scipy(a), h, weighted=False)}
    th = torch.from_numpy(inp["h"]).requires_grad_()
    (spmm(csr_from_scipy(a), th) * torch.from_numpy(inp["w"])).sum().backward()
    return {k: np.asarray(v) for k, v in want.items()}, th.grad.numpy()


def check_sharded_spmm(ranks):
    for n in SPMM_SIZES:
        want, grad = spmm_references(n)
        for res in ranks:
            got = res["spmm"][n]
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5, err_msg=f"{n} {k}")
            np.testing.assert_allclose(got["grad"], grad, rtol=1e-5, atol=1e-5)


def test_sharded_spmm_matches_jax_on_two_ranks(two):
    """Sum, mean over the true in-degrees, the alpha-scaled sum and the
    unweighted sum against JAX's ``spmm`` at 1e-5, the feature gradient
    (summed back over the ranks) against the one-rank autograd."""
    check_sharded_spmm(two[0])


def test_spmm_dispatches_a_sharded_csr_on_one_rank():
    """Without a process group the mesh is this process alone: ``spmm`` on a
    one-shard ``ShardedCSR`` equals the CSR path."""
    inp = dc.spmm_inputs(20)
    mesh = pm.get_mesh(device="cpu")
    assert mesh.shape == {"dp": 1, "tp": 1} and mesh.world_size == 1
    s = shard_csr(inp["adj"], mesh)
    assert isinstance(s, ShardedCSR) and s.n_shards == 1 and s.rows_per_shard == 20
    h = torch.from_numpy(inp["h"])
    for op in ("sum", "mean"):
        torch.testing.assert_close(spmm(s, h, op=op), spmm(csr_from_scipy(inp["adj"]), h, op=op))
    with pytest.raises(ValueError, match="unsupported sharded aggregation"):
        spmm(s, h, op="max")


# ---------------------------------------------------------------------------
# fits
# ---------------------------------------------------------------------------


def test_actinn_fit_distributed_matches_jax(two):
    """Two ranks against JAX's ``fit_distributed`` on a dp = 2 mesh from
    JAX's weights: the epochs' losses at rtol 1e-4, the weights under
    ``assert_weights`` (lr 0.01, 15 steps), the probabilities at rtol 1e-4 /
    atol 1e-5; both ranks end with the same weights."""
    ranks, jax_side = two
    jm = jax_side["actinn"]
    x, _ = actinn_inputs()
    r0, r1 = ranks[0]["actinn"], ranks[1]["actinn"]
    np.testing.assert_allclose(r0["loss"], jax_side["actinn_losses"], rtol=1e-4)
    want = _np_state(actinn_flax_to_torch(_np_tree(jm.params)))
    assert_weights(r0["state"], want, 0.01, 15)
    np.testing.assert_allclose(r0["proba"], jm.predict_proba(x), rtol=1e-4, atol=1e-5)
    for k in r0["state"]:
        np.testing.assert_array_equal(r0["state"][k], r1["state"][k])


def test_actinn_fit_distributed_on_one_rank_is_the_protocol():
    """Without a process group ``fit_distributed`` runs JAX's protocol on
    one rank: the batches of ``max(n // bs, 1)`` from ``default_rng(seed)``."""
    x, onehot = actinn_inputs()
    m = ACTINN(hidden_dims=(12, 8, 6), device="cpu")
    m.fit_distributed(x, onehot, batch_size=32, num_epochs=2, seed=7)
    assert len(m.history) == 2 and all(np.isfinite(h["loss"]) for h in m.history)
    assert m.predict(x).shape == (x.shape[0],)


def test_scdeepsort_fit_distributed_matches_single_and_jax(two):
    """Two ranks on the sharded adjacency: the probabilities and losses
    against the port's single CSR fit at 1e-5, each rank storing its chunk
    of the edges; from JAX's weights, against JAX's ``fit_distributed`` at
    JAX's own bound (test_parallel.py:289, atol 2e-3)."""
    ranks, jax_side = two
    g, labels = dc.cell_gene_graph(1)
    ref = ScDeepSort(8, 16, 2, seed=0, device="cpu").fit(g, labels, epochs=5, use_bsr=False)
    want = ref.predict_proba(g)
    for res in ranks:
        np.testing.assert_allclose(res["scdeepsort"]["proba"], want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["scdeepsort"]["loss"], [h["loss"] for h in ref.history],
                                   rtol=1e-5)
        np.testing.assert_allclose(res["scdeepsort_jax"]["proba"],
                                   jax_side["scdeepsort_proba"], atol=2e-3)
    assert sum(res["scdeepsort"]["edges"] for res in ranks) == g.adj.nnz


def test_graphsc_fit_distributed_matches_single_and_jax(two):
    """Two ranks on the sharded adjacency with the default dropout (0.1, its
    masks drawn whole and cut to the ranks' rows): embeddings and losses
    against the port's single fit at 1e-5; from JAX's weights with dropout
    off, against JAX's ``fit_distributed`` at JAX's bound (8e-3)."""
    ranks, jax_side = two
    g, _ = dc.cell_gene_graph(2)
    ref = GraphSC(n_clusters=3, seed=0, device="cpu").fit(g, epochs=5, use_bsr=False)
    for res in ranks:
        np.testing.assert_allclose(res["graphsc"]["z"], ref.get_latent(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["graphsc"]["loss"], [h["loss"] for h in ref.history],
                                   rtol=1e-5)
        np.testing.assert_allclose(res["graphsc_jax"]["z"], jax_side["graphsc_z"], atol=8e-3)


@pytest.mark.parametrize("name", dc.ZOO)
def test_dense_zoo_fit_distributed_equals_single_fit(two, name):
    """Each dense model's ``fit_distributed`` on two ranks against its
    single fit on the CPU from the same seed (test_parallel.py:97-138's
    shapes, batches of 16): weights, losses and predictions at rtol 1e-4 /
    atol 1e-5, both ranks alike."""
    ranks, _ = two
    want = dc.zoo_fit(name)
    for res in ranks:
        got = res["zoo"][name]
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, dict):
                for p in v:
                    np.testing.assert_allclose(got[k][p], v[p], rtol=1e-4, atol=1e-5,
                                               err_msg=f"{k}.{p}")
            else:
                np.testing.assert_allclose(np.asarray(got[k], float), np.asarray(v, float),
                                           rtol=1e-4, atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# vmapped trials
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_trial_run():
    return jax_trials()


def test_vmapped_trials_match_jax(jax_trial_run):
    """8 trials with per-trial rates and an ``l2`` hyperparameter from JAX's
    initial parameters: the (steps, 8) losses at rtol 1e-4, the same winner."""
    losses, scores = jax_trial_run
    _, params = jax_trial_params()
    got = dc.run_trials(params)
    assert got["losses"].shape == (dc.TRIAL_STEPS, 8)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    assert got["best"] == int(np.argmax(scores))


def test_vmapped_trials_over_two_ranks_match_jax(two, jax_trial_run):
    """The trial axis split over two ranks: the same losses and winner on
    each rank, and the same parameters as one rank."""
    losses, scores = jax_trial_run
    one = dc.run_trials(two[1]["trial_params"])
    for res in two[0]:
        np.testing.assert_allclose(res["trials"]["losses"], losses, rtol=1e-4)
        assert res["trials"]["best"] == int(np.argmax(scores))
        for k, v in one["params"].items():
            np.testing.assert_allclose(res["trials"]["params"][k], v, rtol=1e-6, atol=1e-7)


def test_vmapped_trials_rejects_wrong_lengths():
    from dance_tpu_torch.parallel.trials import vmapped_trials
    init_fn, loss_fn, data, _ = dc.trial_problem(jax_trial_params()[1])
    with pytest.raises(ValueError, match="need 8"):
        vmapped_trials(init_fn, loss_fn, data, seeds=range(8), hyperparams={"l2": [0.0] * 3},
                       device="cpu")
    with pytest.raises(ValueError, match="need 8"):
        vmapped_trials(init_fn, loss_fn, data, seeds=range(8), hyperparams={"l2": [0.0] * 8},
                       lr=[1e-3] * 2, device="cpu")


# ---------------------------------------------------------------------------
# placement, checkpoints, profiling
# ---------------------------------------------------------------------------


def test_placement_and_checkpoint_under_a_mesh(two):
    """``to_device`` wrap-pads and gives each rank its rows inside
    ``dp_context`` (replicates with ``pad=False`` when the rows do not
    divide), ``shard_batch`` likewise, ``replicate`` takes rank 0's values,
    and a checkpoint saved under the mesh is rank 0's on every rank."""
    ranks, _ = two
    x = np.arange(15, dtype=np.float32).reshape(5, 3)
    padded = np.concatenate([x, x[-1:]])
    for r, res in enumerate(ranks):
        p = res["placement"]
        np.testing.assert_array_equal(p["outside"], x)
        np.testing.assert_array_equal(p["pad"], padded[3 * r:3 * r + 3])
        np.testing.assert_array_equal(p["nopad"], x)
        np.testing.assert_array_equal(p["even"], x[2 * r:2 * r + 2])
        assert p["scalar"].item() == 2.5
        np.testing.assert_array_equal(p["batch"][0], padded[3 * r:3 * r + 3])
        np.testing.assert_array_equal(p["batch"][1], np.array([0, 1, 2, 3, 4, 4])[3 * r:3 * r + 3])
        np.testing.assert_array_equal(p["replicated"], np.zeros(3))
        np.testing.assert_array_equal(p["replicated_module"], np.zeros((2, 3)))
        assert p["ckpt"]["step"] == 7
        np.testing.assert_array_equal(p["ckpt"]["w"].numpy(), np.arange(6.0).reshape(2, 3))


def test_checkpoint_round_trip(tmp_path):
    """Weights and an optimizer state through ``save_checkpoint`` /
    ``load_checkpoint``; ``target`` loads them back into a module."""
    net = torch.nn.Linear(4, 3)
    opt = torch.optim.Adam(net.parameters(), lr=1e-2)
    net(torch.ones(2, 4)).sum().backward()
    opt.step()
    path = save_checkpoint(str(tmp_path / "sub" / "state.pt"),
                           {"model": net.state_dict(), "opt": opt.state_dict(), "step": 1})
    assert os.path.isfile(path)
    state = load_checkpoint(path)
    assert state["step"] == 1
    for k, v in net.state_dict().items():
        torch.testing.assert_close(state["model"][k], v)
    other = torch.nn.Linear(4, 3)
    save_checkpoint(str(tmp_path / "w.pt"), net.state_dict())
    load_checkpoint(str(tmp_path / "w.pt"), target=other)
    torch.testing.assert_close(other.weight, net.weight)


def test_stage_timer_block_timed_and_trace(tmp_path):
    timer = StageTimer()
    for _ in range(2):
        with timer.stage("a"):
            pass
    with timer.stage("b"):
        torch.ones(3).sum()
    assert set(timer.summary()) == {"a", "b"} and "(n=2)" in timer.report()
    out, seconds = block_timed(lambda v: {"x": v * 2}, torch.ones(4))
    assert seconds >= 0 and torch.equal(out["x"], torch.full((4,), 2.0))
    with trace(str(tmp_path / "tr")) as log_dir:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    path = os.path.join(log_dir, "trace.json")
    assert os.path.getsize(path) > 0 and "traceEvents" in open(path).read()


# ---------------------------------------------------------------------------
# no fallback
# ---------------------------------------------------------------------------


def test_launch_never_switches_backend_or_device(monkeypatch, tmp_path):
    """NCCL without a card raises, as does NCCL with ``device="cpu"``; without
    a card the default device (the card) raises instead of falling back to
    the CPU; so does a model's ``device="auto"`` before ``fit_distributed``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="nccl"):
        pm.launch(dc.raising_rank, 2, "nccl", rendezvous_dir=str(tmp_path))
    with pytest.raises(ValueError, match="gloo"):
        pm.launch(dc.raising_rank, 2, "nccl", "cpu", rendezvous_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pm.launch(dc.raising_rank, 2, "gloo", rendezvous_dir=str(tmp_path))
    with pytest.raises(ValueError, match="backend"):
        pm.launch(dc.raising_rank, 2, "mpi", "cpu", rendezvous_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ACTINN().fit_distributed(*actinn_inputs())


def test_no_default_placement_falls_back_to_the_cpu(monkeypatch):
    """Without a card, and with no device named, the mesh, the trials,
    ``shard_csr``, ``init_sharded`` and ``to_device`` raise: their device
    defaults to the card, never to the CPU."""
    from dance_tpu_torch.parallel.train import init_sharded
    from dance_tpu_torch.parallel.trials import vmapped_trials
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pm, "_CURRENT_MESH", None)
    bare = pm.Mesh({"dp": 1, "tp": 1}, {"dp": 0, "tp": 0}, {"dp": None, "tp": None}, 0, 1,
                   None, "none")
    init_fn, loss_fn, data, _ = dc.trial_problem(jax_trial_params()[1])
    adj = dc.spmm_inputs(20)["adj"]
    calls = [lambda: pm.get_mesh(),
             lambda: vmapped_trials(init_fn, loss_fn, data, seeds=range(8), num_steps=1),
             lambda: vmapped_trials(init_fn, loss_fn, data, seeds=range(8), num_steps=1,
                                    mesh=bare),
             lambda: shard_csr(adj),
             lambda: shard_csr(adj, bare),
             lambda: init_sharded(lambda: torch.nn.Linear(3, 2), torch.optim.SGD, None, bare),
             lambda: pm.to_device(np.ones(3))]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert pm.get_mesh(device="cpu").device == torch.device("cpu")


def test_a_rank_that_raises_makes_the_launch_raise(tmp_path):
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        pm.launch(dc.raising_rank, 2, "gloo", "cpu", rendezvous_dir=str(tmp_path), timeout=30,
                  join_timeout=90, num_threads=1)


def test_port_parallel_imports_no_jax():
    import ast
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "dance_tpu_torch")
    files = [os.path.join(root, "parallel", f) for f in os.listdir(os.path.join(root, "parallel"))
             if f.endswith(".py")]
    files += [os.path.join(root, "utils", f) for f in ("checkpoint.py", "profile.py")]
    files.append(os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dist_cases.py"))
    for path in files:
        for node in ast.walk(ast.parse(open(path).read())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "flax", "optax", "dance_tpu"), (path, name)
