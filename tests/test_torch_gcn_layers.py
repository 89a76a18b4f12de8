"""Port parity for dance_tpu_torch.nn.gnn's GCNConv and SAGEConv
(counterparts: dance_tpu/nn/gnn.py:20-32, 64-72) and their flax -> torch
transfers.

Inputs are made with numpy from a seed; the flax weights are copied into
the torch modules with ``gcnconv_flax_to_torch`` / ``sageconv_flax_to_torch``.
Each layer runs forward, backward (against a fixed cotangent) and one Adam
step on a CSR, a dense and a BSR adjacency. JAX's BSR runs its Pallas
kernel #1 in interpret mode; the port's BSR runs #1's plain version on the
CPU. Tolerances: outputs and gradients at rtol 1e-5, atol 1e-5 (float32 sums
in other orders); the weights after Adam at rtol 1e-5, atol 1e-6 (a fresh
Adam step moves each weight by ~lr, whatever the gradient's size, so its
sign is what must agree).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch

from dance_tpu.nn.gnn import GCNConv as JGCNConv, SAGEConv as JSAGEConv
from dance_tpu.ops import pallas_kernels as jpk
from dance_tpu.ops.sparse import csr_from_scipy as jcsr, dense_adj_from_scipy as jdense
from dance_tpu_torch.nn.gnn import GCNConv, SAGEConv
from dance_tpu_torch.ops import bsr as tbsr
from dance_tpu_torch.ops.sparse import csr_from_scipy, dense_adj_from_scipy
from dance_tpu_torch.utils.params import gcnconv_flax_to_torch, sageconv_flax_to_torch

LR = 1e-2
FORMATS = ("csr", "dense", "bsr")


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _graph(n=150, seed=0):
    adj = sp.random(n, n, density=0.05, random_state=seed, format="csr", dtype=np.float32)
    adj = (adj + adj.T).tocsr()
    deg = np.asarray(adj.sum(1)).ravel()
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    return sp.csr_matrix(sp.diags(dinv) @ adj @ sp.diags(dinv), dtype=np.float32)


def _adjs(adj, fmt):
    if fmt == "csr":
        return jcsr(adj), csr_from_scipy(adj)
    if fmt == "dense":
        return jdense(adj), dense_adj_from_scipy(adj)
    return jpk.bsr_from_scipy(adj), tbsr.bsr_from_scipy(adj)


def _step(jlayer, layer, to_torch, jadj, tadj, seed):
    """Forward, gradients and one Adam step of both layers from the same
    weights; the JAX results converted to the torch names."""
    rng = np.random.default_rng(seed)
    n, d_in = jadj.shape[0], layer_in(layer)
    h = rng.normal(0, 1, (n, d_in)).astype(np.float32)
    params = jlayer.init(jax.random.key(seed), jadj, jnp.asarray(h))
    out = np.asarray(jlayer.apply(params, jadj, jnp.asarray(h)))
    gout = rng.normal(0, 1, out.shape).astype(np.float32)

    def loss(p, x):
        return jnp.sum(jlayer.apply(p, jadj, x) * gout)

    gp, gh = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(h))
    tx = optax.adam(LR)
    updates, _ = tx.update(gp, tx.init(params), params)
    stepped = optax.apply_updates(params, updates)

    layer.load_state_dict(to_torch(_np_tree(params["params"])))
    th = torch.from_numpy(h).requires_grad_(True)
    got = layer(tadj, th)
    (got * torch.from_numpy(gout)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), out, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), rtol=1e-5, atol=1e-5)
    want_grads = to_torch(_np_tree(gp["params"]))
    for name, p in layer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    opt = torch.optim.Adam(layer.parameters(), lr=LR)
    opt.step()
    want = to_torch(_np_tree(stepped["params"]))
    for name, p in layer.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def layer_in(layer) -> int:
    return layer.linear.in_features if isinstance(layer, GCNConv) else layer.fc_self.in_features


@pytest.mark.parametrize("fmt", FORMATS)
def test_gcnconv_step_matches_jax(fmt):
    jadj, tadj = _adjs(_graph(seed=1), fmt)
    _step(JGCNConv(6), GCNConv(9, 6), gcnconv_flax_to_torch, jadj, tadj, seed=1)


def test_gcnconv_activation_and_no_bias():
    jadj, tadj = _adjs(_graph(seed=2), "csr")
    _step(JGCNConv(5, use_bias=False, activation=jax.nn.relu),
          GCNConv(9, 5, use_bias=False, activation=torch.relu), gcnconv_flax_to_torch, jadj,
          tadj, seed=2)


@pytest.mark.parametrize("fmt", ("csr", "dense"))
def test_sageconv_step_matches_jax(fmt):
    jadj, tadj = _adjs(_graph(seed=3), fmt)
    _step(JSAGEConv(7), SAGEConv(9, 7), sageconv_flax_to_torch, jadj, tadj, seed=3)


def test_sageconv_raises_on_bsr_as_jax_does():
    adj = _graph(seed=4)
    jadj, tadj = _adjs(adj, "bsr")
    h = np.ones((adj.shape[0], 9), np.float32)
    with pytest.raises(ValueError, match="degrees"):
        JSAGEConv(7).init(jax.random.key(0), jadj, jnp.asarray(h))
    with pytest.raises(ValueError, match="degrees"):
        SAGEConv(9, 7)(tadj, torch.from_numpy(h))


def test_gcnconv_bsr_counts_spmm_launches_only_on_the_card():
    adj = _graph(seed=5)
    _, tadj = _adjs(adj, "bsr")
    layer = GCNConv(9, 6)
    before = tbsr.bsr_spmm.launches
    layer(tadj, torch.ones(adj.shape[0], 9)).sum().backward()
    assert tbsr.bsr_spmm.launches == before  # the CPU runs the plain version


def test_inits_follow_flax():
    torch.manual_seed(0)
    gcn = GCNConv(300, 200)
    bound = np.sqrt(6.0 / (300 + 200))  # glorot uniform
    w = gcn.linear.weight.detach().numpy()
    assert np.abs(w).max() <= bound and np.abs(w).max() > 0.95 * bound
    assert not gcn.linear.bias.detach().numpy().any()
    sage = SAGEConv(400, 300)
    for lin in (sage.fc_self, sage.fc_neigh):  # lecun normal: variance 1 / fan-in
        std = lin.weight.detach().numpy().std()
        assert std == pytest.approx(np.sqrt(1 / 400), rel=0.05)
    assert sage.fc_neigh.bias is None and not sage.fc_self.bias.detach().numpy().any()


def test_transfers_reject_unknown_names():
    with pytest.raises(KeyError, match="unexpected"):
        gcnconv_flax_to_torch({"Dense_1": {}})
    with pytest.raises(KeyError, match="unexpected"):
        sageconv_flax_to_torch({"Dense_0": {"kernel": np.zeros((2, 2)), "bias": np.zeros(2)}})
