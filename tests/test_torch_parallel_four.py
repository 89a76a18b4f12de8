"""The port's scale-out layer on four spawned gloo ranks, and the dry run
(see ``test_torch_parallel.py``, whose JAX references this file reuses).

One launch of four ranks serves the SpMM, the sharded scDeepSort and
graph-sc fits and the dp x tp step on a 2 x 2 mesh; JAX's step on the
(4, 2) layout of its 8-device CPU mesh runs in this process meanwhile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_dist_cases as dc
from dance_tpu.nn.mlp import VanillaMLP as JVanillaMLP
from dance_tpu.parallel.mesh import shard_batch as jshard_batch
from dance_tpu.parallel.mesh import shard_params_for_tp as jshard_params_for_tp
from dance_tpu.parallel.train import make_sharded_train_step as jmake_sharded_train_step
from dance_tpu_torch.modules.single_modality.cell_type_annotation import ScDeepSort
from dance_tpu_torch.modules.single_modality.clustering import GraphSC
from dance_tpu_torch.parallel.dryrun import dryrun_multichip
from dance_tpu_torch.utils.params import actinn_flax_to_torch
from test_torch_parallel import (SPMM_SIZES, _np_state, _np_tree, check_sharded_spmm,
                                 in_background, jax_mesh)


def mlp_inputs():
    rng = np.random.default_rng(0)
    return rng.random((32, 128), dtype=np.float32), rng.integers(0, 4, 32)


def jax_train_steps(init):
    """test_parallel.py:13-44's five steps on the (4, 2) mesh: the losses and
    the final weights."""
    model = JVanillaMLP(output_dim=4, hidden_dims=(64, 32))
    tx = optax.adam(1e-2)
    x, y = mlp_inputs()
    mesh = jax_mesh(4, 2)

    def loss_fn(params, batch):
        bx, by = batch
        return optax.softmax_cross_entropy_with_integer_labels(
            model.apply({"params": params}, bx), by).mean()

    with mesh:
        params = jshard_params_for_tp(init, mesh, min_size=1024)
        opt_state = tx.init(params)
        batch = jshard_batch((x, y), mesh)
        step = jmake_sharded_train_step(loss_fn, tx, mesh)
        losses = []
        for _ in range(5):
            params, opt_state, loss = step(params, opt_state, batch)
            losses.append(float(loss))
    return losses, _np_state(actinn_flax_to_torch(_np_tree(params)))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("four_ranks")
    x, y = mlp_inputs()
    init = JVanillaMLP(output_dim=4, hidden_dims=(64, 32)).init(
        jax.random.key(0), jnp.asarray(x[:1]))["params"]
    payload = {"spmm_sizes": SPMM_SIZES, "folder": str(tmp), "mlp_x": x, "mlp_y": y,
               "mlp_init": _np_state(actinn_flax_to_torch(_np_tree(init)))}
    ranks = in_background(dc.run_ranks, "four", 4, tmp, payload)
    jax_side = jax_train_steps(init)
    return ranks(), jax_side


def test_sharded_spmm_matches_jax_on_four_ranks(four):
    """As on two ranks; at 37 rows the fourth rank holds 7 of 10."""
    check_sharded_spmm(four[0])


def test_scdeepsort_fit_distributed_on_four_ranks_equals_single(four):
    g, labels = dc.cell_gene_graph(1)
    ref = ScDeepSort(8, 16, 2, seed=0, device="cpu").fit(g, labels, epochs=5, use_bsr=False)
    for res in four[0]:
        np.testing.assert_allclose(res["scdeepsort"]["proba"], ref.predict_proba(g), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(res["scdeepsort"]["loss"], [h["loss"] for h in ref.history],
                                   rtol=1e-5)
    assert sum(res["scdeepsort"]["edges"] for res in four[0]) == g.adj.nnz


@pytest.mark.parametrize("agg", ["sum", "mean"])
def test_graphsc_fit_distributed_on_four_ranks_equals_single(four, agg):
    """Sum and mean aggregation (the mean over the true in-degrees, which
    the shards carry) on the sharded adjacency, against the single fit."""
    g, _ = dc.cell_gene_graph(2)
    ref = GraphSC(n_clusters=3, agg=agg, seed=0, device="cpu").fit(g, epochs=5, use_bsr=False)
    key = "graphsc" if agg == "sum" else "graphsc_mean"
    for res in four[0]:
        np.testing.assert_allclose(res[key]["z"], ref.get_latent(), rtol=1e-5, atol=1e-5)


def test_sharded_train_step_matches_jax(four):
    """Five steps of ``make_sharded_train_step`` on a 2 x 2 dp x tp mesh
    from JAX's weights (both hidden layers column-sharded, the head
    replicated) against JAX's step on its (4, 2) mesh: losses and weights at
    1e-5, every rank alike."""
    losses, want = four[1]
    for res in four[0]:
        step = res["train_step"]
        assert step["layers"] == ["ColumnParallelLinear", "ColumnParallelLinear", "Linear"]
        np.testing.assert_allclose(step["losses"], losses, rtol=1e-5, atol=1e-5)
        assert set(step["state"]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(step["state"][k], v, rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_dryrun_multichip_on_gloo(n_ranks, tmp_path):
    """ACTINN's distributed fit on a pure-dp mesh and one dp x tp step with
    tp = 2, on spawned CPU ranks."""
    line = dryrun_multichip(n_ranks, "gloo", "cpu")
    assert f"dryrun_multichip({n_ranks})" in line and "'tp': 2" in line
