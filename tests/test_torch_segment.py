"""Port parity for the ``spmm`` dispatch and the segment ops under it
(dance_tpu_torch.ops.segment, ops.sparse.DenseAdj, ops.bsr's max aggregation).

Inputs are made with numpy from a seed and handed to both packages. The JAX
BSR paths run their Pallas kernels in interpret mode on the CPU, as
tests/test_gnn.py does. Tolerances: sums and means in float32 at rtol 1e-5
(the two sum the same products in another order); max aggregation and
degrees exactly (the max of the same float32 products; -inf where a row has
no edge, NaN where a message is NaN).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dance_tpu.ops import pallas_kernels as jpk
from dance_tpu.ops import segment as jseg
from dance_tpu.ops.sparse import csr_from_scipy as jcsr_from_scipy
from dance_tpu.ops.sparse import dense_adj_from_scipy as jdense_adj_from_scipy
from dance_tpu_torch.ops import bsr as tbsr
from dance_tpu_torch.ops import segment as tseg
from dance_tpu_torch.ops.sparse import CSRMatrix as CSRMatrixT
from dance_tpu_torch.ops.sparse import csr_from_scipy, dense_adj_from_scipy
from dance_tpu_torch.ops.sparse import csr_to_dense as csr_to_dense_t
from torch_cases import max_edge_case, signed

RTOL, ATOL = 1e-5, 1e-6
D = 40


def _graph(n=300, m=300, seed=3):
    """A 300-node graph with signed weights, multi-block rows and empty rows
    (rows 100-139 and a whole empty block-row 256-299 of the padded tiling)."""
    adj = sp.lil_matrix(sp.random(n, m, density=0.04, random_state=seed, dtype=np.float32))
    adj[100:140] = 0
    adj[256:] = 0
    adj = signed(sp.csr_matrix(adj))
    h = (np.random.default_rng(seed).random((m, D), dtype=np.float32) - 0.5)
    return adj, h


def _both(adj, fmt):
    if fmt == "csr":
        return jcsr_from_scipy(adj), csr_from_scipy(adj)
    if fmt == "dense":
        return jdense_adj_from_scipy(adj), dense_adj_from_scipy(adj)
    return jpk.bsr_from_scipy(adj), tbsr.bsr_from_scipy(adj)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_spmm_csr_matches_jax(op, weighted):
    adj, h = _graph()
    jadj, tadj = _both(adj, "csr")
    want = np.asarray(jseg.spmm(jadj, jnp.asarray(h), weighted=weighted, op=op))
    got = tseg.spmm(tadj, torch.from_numpy(h), weighted=weighted, op=op).numpy()
    if op == "max":
        assert np.isneginf(got[100:140]).all()
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("op", ["sum", "mean"])
def test_spmm_dense_adj_matches_jax(op, weighted):
    adj, h = _graph(seed=4)
    jadj, tadj = _both(adj, "dense")
    want = np.asarray(jseg.spmm(jadj, jnp.asarray(h), weighted=weighted, op=op))
    got = tseg.spmm(tadj, torch.from_numpy(h), weighted=weighted, op=op).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # and the dense product is the CSR aggregation
    csr = tseg.spmm(csr_from_scipy(adj), torch.from_numpy(h), weighted=weighted, op=op)
    np.testing.assert_allclose(got, csr.numpy(), rtol=RTOL, atol=ATOL)


def test_spmm_dense_adj_max_raises_as_jax():
    adj, h = _graph(seed=5)
    jadj, tadj = _both(adj, "dense")
    with pytest.raises(ValueError):
        jseg.spmm(jadj, jnp.asarray(h), op="max")
    with pytest.raises(ValueError, match="DenseAdj supports sum/mean"):
        tseg.spmm(tadj, torch.from_numpy(h), op="max")


@pytest.mark.parametrize("op,weighted", [("sum", True), ("mean", True), ("max", True),
                                         ("max", False)])
def test_spmm_bsr_matches_jax(op, weighted):
    adj, h = _graph(seed=6)
    jadj, tadj = _both(adj, "bsr")
    deg = np.diff(adj.indptr).astype(np.float32)
    kw = {"degrees": deg} if op == "mean" else {}
    want = np.asarray(jseg.spmm(jadj, jnp.asarray(h), weighted=weighted, op=op,
                                **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = tseg.spmm(tadj, torch.from_numpy(h), weighted=weighted, op=op,
                    **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
    assert got.shape == want.shape == (300, D)
    if op == "max":
        np.testing.assert_array_equal(got, want)
        csr = tseg.spmm(csr_from_scipy(adj), torch.from_numpy(h), weighted=weighted, op="max")
        np.testing.assert_array_equal(got, csr.numpy())
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("weighted", [True, False])
def test_spmm_bsr_max_rectangular_n_out_matches_jax(weighted):
    adj, h = _graph(n=300, m=200, seed=3)
    jadj, tadj = _both(adj, "bsr")
    want = np.asarray(jseg.spmm(jadj, jnp.asarray(h), weighted=weighted, op="max", n_out=300))
    got = tseg.spmm(tadj, torch.from_numpy(h), weighted=weighted, op="max", n_out=300).numpy()
    assert got.shape == (300, D)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kwargs,match", [
    ({"op": "sum", "weighted": False}, "unweighted sum/mean"),
    ({"op": "mean", "weighted": False}, "unweighted sum/mean"),
    ({"op": "mean"}, "degrees"),
    ({"op": "min"}, "Unknown aggregation"),
])
def test_spmm_bsr_value_errors_match_jax(kwargs, match):
    adj, h = _graph(seed=7)
    jadj, tadj = _both(adj, "bsr")
    with pytest.raises(ValueError):
        jseg.spmm(jadj, jnp.asarray(h), **kwargs)
    with pytest.raises(ValueError, match=match):
        tseg.spmm(tadj, torch.from_numpy(h), **kwargs)


def test_spmm_rejects_other_adjacency_types():
    with pytest.raises(TypeError, match="ShardedCSR"):
        tseg.spmm(object(), torch.zeros((3, 2)))


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("case", ["graph", "edge_case"])
def test_bsr_spmm_max_reference_matches_jax_interpret(case, weighted):
    """The plain version against the Pallas kernel run directly in interpret
    mode: -inf rows, pad tiles, and with the edge case a NaN weight and NaN
    and infinities in h."""
    if case == "graph":
        adj, h = _graph(seed=8)
        tadj = tbsr.bsr_from_scipy(adj)
        h = np.pad(h, ((0, tadj.shape[1] - h.shape[0]), (0, 0)))
    else:
        tadj, ht = max_edge_case()
        h = ht.numpy()
    jadj = jpk.BSRMatrix(jnp.asarray(tadj.tiles.numpy()), jnp.asarray(tadj.block_rows.numpy()),
                         jnp.asarray(tadj.block_cols.numpy()), tadj.shape)
    want = np.asarray(jpk.bsr_spmm_max(jadj, jnp.asarray(h), weighted=weighted, interpret=True))
    got = tbsr.bsr_spmm_max_reference(tadj, torch.from_numpy(h), weighted=weighted).numpy()
    assert np.isneginf(got).any()
    np.testing.assert_array_equal(got, want)


def test_bsr_spmm_max_cpu_wrapper_runs_plain_version_and_counts_nothing():
    tadj, h = max_edge_case()
    n = tbsr.bsr_spmm_max.launches
    for weighted in (True, False):
        np.testing.assert_array_equal(
            tbsr.bsr_spmm_max(tadj, h, weighted=weighted).numpy(),
            tbsr.bsr_spmm_max_reference(tadj, h, weighted=weighted).numpy())
    assert tbsr.bsr_spmm_max.launches == n
    with pytest.raises(ValueError, match="must be"):
        tbsr.bsr_spmm_max(tadj, h[:-1])


def test_bsr_spmm_max_plain_version_keeps_messages_bounded(monkeypatch):
    """Chunks of tiles and tile columns give the same result as one chunk."""
    adj, h = _graph(seed=9)
    tadj = tbsr.bsr_from_scipy(adj)
    ht = torch.from_numpy(np.pad(h, ((0, tadj.shape[1] - h.shape[0]), (0, 0))))
    whole = tbsr.bsr_spmm_max_reference(tadj, ht)
    monkeypatch.setattr(tbsr, "_MAX_MSG_ELEMS", tbsr.BLOCK * tbsr._MAX_CHUNK * D)  # one tile
    torch.testing.assert_close(tbsr.bsr_spmm_max_reference(tadj, ht), whole, rtol=0, atol=0)


@pytest.mark.parametrize("tiles_grad", [False, True])
def test_spmm_max_backward_raises_on_cpu(tiles_grad):
    adj, h = _graph(seed=10)
    tadj = tbsr.bsr_from_scipy(adj)
    tadj.tiles.requires_grad_(tiles_grad)
    ht = torch.from_numpy(h).requires_grad_(not tiles_grad)
    out = tseg.spmm(tadj, ht, op="max")
    assert out.requires_grad
    with pytest.raises(RuntimeError, match="forward-only"):
        out[torch.isfinite(out)].sum().backward()


def test_aggregate_max_matches_jax_segment_max():
    adj, h = _graph(seed=11)
    jadj, tadj = _both(adj, "csr")
    msgs = np.random.default_rng(11).standard_normal((adj.nnz, 3)).astype(np.float32)
    want = np.asarray(jseg.aggregate(jadj, jnp.asarray(msgs), op="max"))
    got = tseg.aggregate(tadj, torch.from_numpy(msgs), op="max").numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="Unknown aggregation"):
        tseg.aggregate(tadj, torch.from_numpy(msgs), op="min")


def test_sddmm_dot_and_degrees_match_jax():
    adj, h = _graph(n=300, m=200, seed=12)
    jadj, tadj = _both(adj, "csr")
    a = np.random.default_rng(12).standard_normal((300, D)).astype(np.float32)
    np.testing.assert_allclose(
        tseg.sddmm_dot(tadj, torch.from_numpy(a), torch.from_numpy(h)).numpy(),
        np.asarray(jseg.sddmm_dot(jadj, jnp.asarray(a), jnp.asarray(h))), rtol=RTOL, atol=ATOL)
    for fn in ("in_degrees", "out_degrees"):
        got, want = getattr(tseg, fn)(tadj), getattr(jseg, fn)(jadj)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# The fixed-order CSR sums (segment_sum_csr, csr_spmm, the gathers' backward)
# --------------------------------------------------------------------------

SUM_RTOL = 1e-6


@pytest.mark.parametrize("op", ["sum", "mean"])
@pytest.mark.parametrize("shape", [(300, 300), (300, 200)], ids=["square", "rectangular"])
def test_fixed_order_sum_matches_jax_segment_sum(op, shape):
    """The sum over ``indptr``'s segments against ``jax.ops.segment_sum`` of
    the same messages, empty rows included (rows 100-139 and 256-299)."""
    import jax

    adj, _ = _graph(*shape, seed=21)
    tadj = csr_from_scipy(adj)
    msgs = np.random.default_rng(21).standard_normal((adj.nnz, 5)).astype(np.float32)
    rows = np.repeat(np.arange(shape[0]), np.diff(adj.indptr))
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(msgs), jnp.asarray(rows),
                                          num_segments=shape[0]))
    if op == "mean":
        want = want / np.maximum(np.diff(adj.indptr), 1)[:, None]
    got = tseg.aggregate(tadj, torch.from_numpy(msgs), op=op).numpy()
    assert (got[100:140] == 0).all() and (got[256:] == 0).all()
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=1e-7)
    np.testing.assert_allclose(tseg.segment_sum_csr(torch.from_numpy(msgs), tadj.indptr).numpy(),
                               np.asarray(jax.ops.segment_sum(jnp.asarray(msgs),
                                                              jnp.asarray(rows),
                                                              num_segments=shape[0])),
                               rtol=SUM_RTOL, atol=1e-7)


def test_csr_sums_match_jax():
    """The CSR helpers of ops/sparse.py on the fixed-order sums."""
    from dance_tpu.ops import sparse as jsp
    from dance_tpu_torch.ops import sparse as tsp

    adj, h = _graph(300, 200, seed=22)
    jadj, tadj = jcsr_from_scipy(adj), csr_from_scipy(adj)
    v = np.random.default_rng(22).standard_normal(200).astype(np.float32)
    pairs = [(tsp.csr_row_sums(tadj), jsp.csr_row_sums(jadj)),
             (tsp.csr_col_sums(tadj), jsp.csr_col_sums(jadj)),
             (tsp.csr_matvec(tadj, torch.from_numpy(v)), jsp.csr_matvec(jadj, jnp.asarray(v))),
             (tsp.csr_to_dense(tadj), jsp.csr_to_dense(jadj))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SUM_RTOL, atol=1e-7)


def test_csr_to_dense_sums_duplicate_entries():
    dup = CSRMatrixT(torch.tensor([1.0, 2.0, 4.0, 8.0]), torch.tensor([1, 1, 0, 1]),
                     torch.tensor([0, 3, 3, 4]), (3, 2))
    np.testing.assert_array_equal(csr_to_dense_t(dup).numpy(), [[4.0, 3.0], [0, 0], [0, 8.0]])


def _small_csr(n=9, m=7, seed=23):
    adj = sp.random(n, m, density=0.3, random_state=seed, dtype=np.float64).tolil()
    adj[3] = 0
    adj = sp.csr_matrix(adj)
    adj.eliminate_zeros()
    t = CSRMatrixT(torch.from_numpy(adj.data), torch.from_numpy(adj.indices.astype(np.int64)),
                   torch.from_numpy(adj.indptr.astype(np.int64)), adj.shape)
    return adj, t


@pytest.mark.parametrize("weighted", [True, False])
def test_csr_spmm_gradcheck_float64(weighted):
    """``dh`` (the sum on ``Aᵀ``) and ``dw`` (one dot per edge) against finite
    differences, and the gathers' fixed-order backward."""
    _, t = _small_csr()
    gen = torch.Generator().manual_seed(23)
    h = torch.randn(t.shape[1], 4, dtype=torch.float64, generator=gen, requires_grad=True)
    w = t.data.clone().requires_grad_(weighted)
    fn = (lambda h, w: tseg.csr_spmm(t, h, w)) if weighted else (lambda h, w: tseg.csr_spmm(t, h))
    assert torch.autograd.gradcheck(fn, (h, w))
    x = torch.randn(t.shape[0], 3, dtype=torch.float64, generator=gen, requires_grad=True)
    assert torch.autograd.gradcheck(lambda h: tseg.gather_src(t, h), (h,))
    assert torch.autograd.gradcheck(lambda x: tseg.gather_dst(t, x), (x,))
    assert torch.autograd.gradcheck(lambda x, h: tseg.sddmm_dot(t, x, h[:, :3]), (x, h))
    logits = torch.randn(t.indices.shape[0], dtype=torch.float64, generator=gen,
                         requires_grad=True)
    assert torch.autograd.gradcheck(lambda z: tseg.edge_softmax(t, z), (logits,))


def test_csr_spmm_grads_match_jax():
    import jax

    adj, h = _graph(300, 200, seed=24)
    jadj, tadj = jcsr_from_scipy(adj), csr_from_scipy(adj)
    g = np.random.default_rng(24).standard_normal((300, D)).astype(np.float32)

    def jloss(h, data):
        a = jadj.__class__(data, jadj.indices, jadj.indptr, jadj.shape)
        return (jseg.spmm(a, h) * g).sum()

    jdh, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h), jadj.data)
    th = torch.from_numpy(h).requires_grad_(True)
    tw = tadj.data.clone().requires_grad_(True)
    (tseg.csr_spmm(tadj, th, tw) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("edit", ["in_place", "replaced"])
def test_csr_kept_orders_follow_an_edit(edit):
    """The transposed order and the row ids kept on a ``CSRMatrix`` are
    rebuilt after an in-place edit or a replaced tensor, as the BSR caches
    are (tests/test_torch_bsr_cache.py)."""
    adj, t = _small_csr(seed=25)
    h = torch.randn(t.shape[1], 2, dtype=torch.float64, requires_grad=True)
    tseg.csr_spmm(t, h, t.data).sum().backward()
    first = t.col_order()
    assert t.col_order() is first  # kept
    new_idx = (t.indices + 1) % t.shape[1]
    if edit == "in_place":
        t.indices.copy_(new_idx)
    else:
        t.indices = new_idx.clone()
    perm, ptr = t.col_order()
    assert perm is not first[0]
    want = sp.csr_matrix((adj.data, new_idx.numpy(), adj.indptr), shape=adj.shape)
    np.testing.assert_array_equal(np.diff(ptr.numpy()), np.bincount(new_idx.numpy(),
                                                                      minlength=t.shape[1]))
    h.grad = None
    tseg.csr_spmm(t, h, t.data).sum().backward()
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(want.sum(0)).T.repeat(2, 1))
    new_ptr = torch.zeros_like(t.indptr)
    new_ptr[-1] = t.indices.shape[0]  # every entry in the last row
    if edit == "in_place":
        t.indptr.copy_(new_ptr)
    else:
        t.indptr = new_ptr
    np.testing.assert_array_equal(t.row_ids().numpy(),
                                  np.repeat(np.arange(t.shape[0]), np.diff(new_ptr.numpy())))
    assert t.with_data(t.data * 2)._kept is t._kept
