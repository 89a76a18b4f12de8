"""Port parity for the fused GAT ops, edge softmax, GATConv and the RCM
reordering (dance_tpu_torch.ops.bsr, ops.segment, nn.gnn).

The JAX side runs its Pallas kernels as tests/test_gnn.py does on the CPU (in
interpret mode); the port's wrappers run their plain PyTorch versions here,
and the CUDA kernels are held against those on the card in
test_torch_cuda.py. Inputs are made with numpy from a seed and handed to
both packages; GATConv's flax weights are copied into the torch module.

Tolerances: forward outputs and stats at rtol 1e-4, atol 1e-5, as
tests/test_gnn.py:372 holds the Pallas GAT to a dense reference; gradients at
rtol 1e-3, atol 1e-4, as tests/test_gnn.py:401. Permutations and index
arrays are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dance_tpu.nn.gnn import GATConv as JGATConv
from dance_tpu.ops import pallas_kernels as jpk
from dance_tpu.ops import segment as jseg
from dance_tpu.ops.sparse import csr_from_scipy as jcsr_from_scipy
from dance_tpu_torch.nn.gnn import GATConv
from dance_tpu_torch.ops import bsr as tbsr
from dance_tpu_torch.ops import segment as tseg
from dance_tpu_torch.ops.sparse import csr_from_scipy
from dance_tpu_torch.utils.params import gatconv_flax_to_torch
from torch_cases import CASES, gat_inputs, no_pad

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-4)
ACTS = ["leaky_relu", "sigmoid"]


def _j(*tensors):
    return [jnp.asarray(t.numpy()) for t in tensors]


def _graph(seed=4, n=300, density=0.03):
    """A square graph with self-loops, as the GAT layers see it."""
    adj = sp.random(n, n, density=density, random_state=seed, dtype=np.float32, format="lil")
    adj.setdiag(1.0)
    return sp.csr_matrix(adj)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("d", [10, 130])
def test_bsr_gat_and_stats_match_jax(act, d):
    # block-row 1 of this graph has no edge: out 0, m -1e30, l 0
    adj = CASES["square_with_empty_block_rows"]()
    bsr, jb = tbsr.bsr_from_scipy(adj), jpk.bsr_from_scipy(adj)
    er, el, h, _ = gat_inputs(bsr, d, seed=d)
    jout, jm, jl = jpk.bsr_gat_stats(jb, *_j(er, el, h), act=act)
    out, m, l = tbsr.bsr_gat_stats(bsr, er, el, h, act=act)
    for got, want in ((out, jout), (m, jm), (l, jl)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    np.testing.assert_allclose(tbsr.bsr_gat(bsr, er, el, h, act=act).numpy(),
                               np.asarray(jpk.bsr_gat(jb, *_j(er, el, h), act=act)), **FWD)
    assert (m[128:256] == -1e30).all() and (l[128:256] == 0).all()
    assert (out[128:256] == 0).all()
    # the plain version needs no pad tiles
    np.testing.assert_allclose(tbsr.bsr_gat(no_pad(bsr), er, el, h, act=act).numpy(),
                               np.asarray(jout), **FWD)


@pytest.mark.parametrize("act", ACTS)
def test_bsr_gat_grads_match_jax(act):
    adj = CASES["square_with_empty_block_rows"]()
    bsr, jb = tbsr.bsr_from_scipy(adj), jpk.bsr_from_scipy(adj)
    er, el, h, g = gat_inputs(bsr, 24, seed=11)
    jout, jm, jl = jpk.bsr_gat_stats(jb, *_j(er, el, h), act=act)
    jgrads = jpk.bsr_gat_grads(jb, *_j(er, el, h, g), jout[:g.shape[0]], jm, jl, act=act)
    out, m, l = tbsr.bsr_gat_stats(bsr, er, el, h, act=act)
    grads = tbsr.bsr_gat_grads(bsr, er, el, h, g, out[:g.shape[0]], m, l, act=act)
    # and against autodiff through the pure-XLA scan reference
    n = g.shape[0]

    def loss(er_, el_, h_):
        return jnp.sum(jpk.bsr_gat_scan(jb, er_, el_, h_, act=act)[:n] * jnp.asarray(g.numpy()))

    jscan = jax.grad(loss, argnums=(0, 1, 2))(*_j(er, el, h))
    for got, want, want_scan in zip(grads, jgrads, jscan):
        assert got.shape == want.shape == want_scan.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_scan), **GRAD)


@pytest.mark.parametrize("act", ACTS)
def test_bsr_gat_ad_grads_match_jax(act):
    adj = _graph(seed=5, n=200, density=0.05)
    bsr, jb = tbsr.bsr_from_scipy(adj), jpk.bsr_from_scipy(adj)
    rng = np.random.default_rng(5)
    er, el = (rng.normal(0, 1, 200).astype(np.float32) for _ in range(2))
    h = rng.random((200, 6), dtype=np.float32)

    def jloss(er_, el_, h_):
        return jnp.sum(jpk.bsr_gat_ad(jb, er_, el_, h_, act=act)[:200] ** 2)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(er), jnp.asarray(el), jnp.asarray(h))
    tensors = [torch.from_numpy(a).requires_grad_(True) for a in (er, el, h)]
    (tbsr.bsr_gat_ad(bsr, *tensors, act=act)[:200] ** 2).sum().backward()
    for t, want in zip(tensors, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), **GRAD)


def test_bsr_gat_ad_takes_primal_without_grad(monkeypatch):
    """Outside autograd the primal forward runs; with it, the stats forward
    and the flash backward (as JAX's custom_vjp, pallas_kernels.py:615-640)."""
    calls = []
    for name in ("bsr_gat", "bsr_gat_stats", "bsr_gat_grads"):
        fn = getattr(tbsr, name)
        monkeypatch.setattr(tbsr, name, lambda *a, _n=name, _f=fn, **k: (calls.append(_n),
                                                                          _f(*a, **k))[1])
    bsr = tbsr.bsr_from_scipy(_graph())
    er, el, h, _ = gat_inputs(bsr, 8, seed=0)
    with torch.no_grad():
        tbsr.bsr_gat_ad(bsr, er, el, h.requires_grad_(True))
    assert calls == ["bsr_gat"]
    tbsr.bsr_gat_ad(bsr, er, el, h).sum().backward()
    assert calls == ["bsr_gat", "bsr_gat_stats", "bsr_gat_grads"]
    assert bsr.tiles.grad is None and h.grad is not None


def test_gat_cpu_wrappers_count_nothing_and_reject_bad_inputs():
    bsr = tbsr.bsr_from_scipy(CASES["rectangular"]())
    er, el, h, g = gat_inputs(bsr, 8, seed=1)
    counts = [f.launches for f in (tbsr.bsr_gat, tbsr.bsr_gat_stats, tbsr.bsr_gat_grads)]
    out, m, l = tbsr.bsr_gat_stats(bsr, er, el, h)
    torch.testing.assert_close(tbsr.bsr_gat(bsr, er, el, h), out, rtol=0, atol=0)
    tbsr.bsr_gat_grads(bsr, er, el, h, g, out[:g.shape[0]], m, l)
    assert [f.launches for f in (tbsr.bsr_gat, tbsr.bsr_gat_stats,
                                 tbsr.bsr_gat_grads)] == counts
    with pytest.raises(ValueError, match="act must be"):
        tbsr.bsr_gat(bsr, er, el, h, act="relu")
    with pytest.raises(ValueError, match="need er"):
        tbsr.bsr_gat(bsr, el, er, h[:, :0])
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        tbsr.bsr_gat(bsr, er, el, h.to("meta"))


@pytest.mark.parametrize("seed", [0, 1])
def test_rcm_reorder_matches_jax(seed):
    adj = _graph(seed=seed, n=500, density=0.01)
    adj = adj + adj.T
    perm, adj_p = tbsr.rcm_reorder(adj)
    jperm, jadj_p = jpk.rcm_reorder(adj)
    np.testing.assert_array_equal(perm, jperm)
    assert (adj_p != jadj_p).nnz == 0
    tperm, bsr = tbsr.bsr_with_rcm(adj)
    jperm2, jb = jpk.bsr_with_rcm(adj)
    np.testing.assert_array_equal(tperm, jperm2)
    np.testing.assert_array_equal(bsr.tiles.numpy(), np.asarray(jb.blocks))
    np.testing.assert_array_equal(bsr.block_cols.numpy(), np.asarray(jb.block_cols))


@pytest.mark.parametrize("heads", [1, 3])
def test_edge_softmax_matches_jax(heads):
    adj = sp.random(60, 60, density=0.08, random_state=2, dtype=np.float32, format="lil")
    adj[7] = 0  # a destination with no incoming edge
    adj = sp.csr_matrix(adj)
    logits = np.random.default_rng(2).normal(0, 3, (adj.nnz, heads)).astype(np.float32)
    logits = logits[:, 0] if heads == 1 else logits
    want = jseg.edge_softmax(jcsr_from_scipy(adj), jnp.asarray(logits))
    got = tseg.edge_softmax(csr_from_scipy(adj), torch.from_numpy(logits))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("branch", ["csr", "bsr"])
def test_gatconv_matches_jax(branch):
    adj = _graph(seed=3, n=150, density=0.05)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((150, 12)).astype(np.float32)
    w = rng.standard_normal((150, 2 * 6)).astype(np.float32)
    jlayer = JGATConv(6, num_heads=2)
    jparams = jlayer.init(jax.random.key(0), jcsr_from_scipy(adj), jnp.asarray(x))
    jadj = jcsr_from_scipy(adj) if branch == "csr" else jpk.bsr_from_scipy(adj)

    def jloss(params, xx):
        return jnp.sum(jlayer.apply(params, jadj, xx) * w)

    jout = jlayer.apply(jparams, jadj, jnp.asarray(x))
    jg_params, jg_x = jax.grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(x))

    layer = GATConv(12, 6, num_heads=2)
    layer.load_state_dict(gatconv_flax_to_torch(jparams["params"]))
    tadj = csr_from_scipy(adj) if branch == "csr" else tbsr.bsr_from_scipy(adj)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = layer(tadj, xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FWD)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x), **GRAD)
    want = gatconv_flax_to_torch(jg_params["params"])
    for name, p in layer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), **GRAD)
    if branch == "csr":
        _, att = layer(tadj, xt, return_attention=True)
        assert att.shape == (adj.nnz, 2)
    else:
        with pytest.raises(ValueError, match="CSR"):
            layer(tadj, xt, return_attention=True)
