"""The edge lists of a BSR matrix, and numpy emulations of the two kernels that
walk the edges instead of the tiles' slots (dance_tpu_torch.ops.bsr
``bsr_edges``; csrc/bsr_gat_bwd.cu for ``bsr_gat_grads``, csrc/bsr_spmm_max.cu
for ``bsr_spmm_max``).

The CUDA kernels cannot run here, so their passes are emulated in numpy
float32, in their order of edges, and held against the plain versions (and
the GAT backward also against the JAX package's Pallas kernel in interpret
mode): at the GRAD tolerances of test_torch_gat.py (rtol 1e-3, atol 1e-4) for
the GAT backward, whose sums run in another order, and exactly for the max,
which takes the max of the same float32 products. With non-finite inputs the
emulated GAT backward, repair pass included, must put NaN and ±inf where the
plain version does; without the repair pass it does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dance_tpu.ops import pallas_kernels as jpk
from dance_tpu_torch.ops import bsr as tbsr
from torch_cases import (CASES, NONFINITE_WIDTHS, gat_inputs, gat_nonfinite_case, knn_bsr,
                         max_edge_case, no_pad, signed, skewed_bsr)

GRAD = dict(rtol=1e-3, atol=1e-4)
ACTS = ["leaky_relu", "sigmoid"]
SLOPE = np.float32(0.2)
# csrc/bsr_gat_bwd.cu: |g|, |h| at or past 2^40 and |r| at or past 2^126 mark a row or column
HUGE, HUGE_R = np.float32(2.0 ** 40), np.float32(2.0 ** 126)


def _tilings():
    out = {"skewed": skewed_bsr(seed=3), "knn": knn_bsr(n=640, k=8)}
    for case, make in CASES.items():
        out[case] = tbsr.bsr_from_scipy(make())
    return out


TILINGS = _tilings()


def _expected_edges(bsr):
    """(row, col) of every slot != 0, tile by tile in order, each tile by row
    then slot, then sorted by row (stably): the order bsr_edges promises."""
    rows, cols = [], []
    blk = bsr.block
    for t in range(bsr.nb):
        ii, jj = np.nonzero(bsr.tiles[t].numpy() != 0)
        rows.append(int(bsr.block_rows[t]) * blk + ii)
        cols.append(int(bsr.block_cols[t]) * blk + jj)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    order = np.argsort(rows, kind="stable")
    return rows[order], cols[order]


@pytest.mark.parametrize("name", sorted(TILINGS))
def test_bsr_edges_are_the_nonzero_slots(name):
    bsr = TILINGS[name]
    bsr = tbsr.BSRMatrix(bsr.tiles.clone(), bsr.block_rows, bsr.block_cols, bsr.rowptr, bsr.shape)
    bsr.tiles[-1, 5, 7] = float("nan")  # NaN != 0: an edge, as in the plain versions
    edges = tbsr.bsr_edges(bsr)
    rows, cols = _expected_edges(bsr)
    n_rows, n_cols = bsr.shape
    for t in (edges.rowptr, edges.cols, edges.rows, edges.colptr, edges.colperm):
        assert t.dtype == torch.int32
    assert edges.nnz == len(rows) == int((bsr.tiles != 0).sum())
    np.testing.assert_array_equal(edges.rows.numpy(), rows)
    np.testing.assert_array_equal(edges.cols.numpy(), cols)
    np.testing.assert_array_equal(edges.rowptr.numpy(),
                                  np.searchsorted(rows, np.arange(n_rows + 1)))
    colptr, perm = edges.colptr.numpy(), edges.colperm.numpy()
    np.testing.assert_array_equal(np.diff(colptr), np.bincount(cols, minlength=n_cols))
    np.testing.assert_array_equal(np.sort(perm), np.arange(len(rows)))
    for j in np.unique(cols):
        ids = perm[colptr[j]:colptr[j + 1]]
        assert (cols[ids] == j).all() and (np.diff(ids) > 0).all()
    assert tbsr.bsr_edges(bsr) is edges  # constant tiles: built once and kept


@pytest.mark.parametrize("case", ["square_with_empty_block_rows", "nonfinite"])
def test_bsr_edges_take_nothing_from_pad_tiles(case):
    bsr = (gat_nonfinite_case()[0] if case == "nonfinite"
           else tbsr.bsr_from_scipy(CASES[case]()))
    assert (bsr.tiles.abs().sum(dim=(1, 2)) == 0).any()  # bsr_from_scipy padded it
    with_pad, without = tbsr.bsr_edges(bsr), tbsr.bsr_edges(no_pad(bsr))
    for field in ("rowptr", "cols", "rows", "colptr", "colperm"):
        assert torch.equal(getattr(with_pad, field), getattr(without, field))


def test_bsr_edges_are_not_kept_for_trainable_tiles():
    bsr = tbsr.bsr_from_scipy(CASES["rectangular"]())
    bsr.tiles.requires_grad_(True)
    first = tbsr.bsr_edges(bsr)
    assert bsr._edges is None and tbsr.bsr_edges(bsr) is not first
    assert torch.equal(first.cols, tbsr.bsr_edges(bsr).cols)


# -- csrc/bsr_gat_bwd.cu in numpy ------------------------------------------


def _act(raw, act):
    with np.errstate(over="ignore", invalid="ignore"):
        if act == "sigmoid":
            return (np.float32(1) / (np.float32(1) + np.exp(-raw))).astype(np.float32)
        return np.where(raw >= 0, raw, SLOPE * raw).astype(np.float32)


def _act_grad(raw, act):
    with np.errstate(over="ignore", invalid="ignore"):
        if act == "sigmoid":
            s = np.float32(1) / (np.float32(1) + np.exp(-raw))
            return (s * (np.float32(1) - s)).astype(np.float32)
        return np.where(raw >= 0, np.float32(1), SLOPE).astype(np.float32)


def _seq_sum(x, axis=0):
    """A float32 sum term after term, as a warp adds a row's edges."""
    if x.shape[axis] == 0:
        return np.zeros(x.shape[:axis] + x.shape[axis + 1:], np.float32)
    return np.take(np.add.accumulate(x, axis=axis, dtype=np.float32), -1, axis=axis)


def emulate_gat_grads(bsr, er, el, h, g, out, m, l, act, repair=True):
    """The passes of csrc/bsr_gat_bwd.cu: (1) by row over its edges, da and p
    per edge and der; (2) by column over its edges, del and dh; then (3) the
    repair of the marked rows' and columns' off-edge slots. numpy float32,
    inputs padded as the wrapper pads them."""
    n_er, n_el, n_src = er.shape[0], el.shape[0], h.shape[0]
    n_rows, n_cols = bsr.shape
    f32 = lambda t, n: np.pad(t.numpy().astype(np.float32),  # noqa: E731
                              [(0, n - t.shape[0])] + [(0, 0)] * (t.dim() - 1))
    er, m, l = f32(er, n_rows), f32(m, n_rows), f32(l, n_rows)
    g, out = f32(g, n_rows), f32(out, n_rows)
    el, h = f32(el, n_cols), f32(h, n_cols)
    e = tbsr.bsr_edges(bsr)
    rowptr, cols, rows = e.rowptr.numpy(), e.cols.numpy(), e.rows.numpy()
    colptr, perm = e.colptr.numpy(), e.colperm.numpy()
    sig = act == "sigmoid"
    with np.errstate(all="ignore"):
        r = (g * out).sum(1, dtype=np.float32)
        lc = np.where(np.isnan(l), l, np.maximum(l, np.float32(1e-12)))
        # pass 1
        s = (g[rows] * h[cols]).sum(1, dtype=np.float32)
        raw = er[rows] + el[cols]
        p = np.exp(_act(raw, act) - m[rows]) / lc[rows]
        da = p * (s - r[rows]) * _act_grad(raw, act)
        der = np.array([_seq_sum(da[rowptr[i]:rowptr[i + 1]]) for i in range(n_rows)], np.float32)
        row_mark = (~(np.abs(g) < HUGE)).any(1) | ~(np.abs(r) < HUGE_R) | np.isnan(l)
        # pass 2
        del_ = np.array([_seq_sum(da[perm[colptr[j]:colptr[j + 1]]]) for j in range(n_cols)],
                        np.float32)
        contrib = p[perm][:, None] * g[rows[perm]]
        dh = np.stack([_seq_sum(contrib[colptr[j]:colptr[j + 1]]) for j in range(n_cols)])
        col_mark = (~(np.abs(h) < HUGE)).any(1)
        if sig:
            row_mark |= ~np.isfinite(er)
            col_mark |= ~np.isfinite(el)
        # pass 3
        blk = bsr.block
        for t in range(bsr.nb if repair and (row_mark.any() or col_mark.any()) else 0):
            ri = int(bsr.block_rows[t]) * blk + np.arange(blk)
            cj = int(bsr.block_cols[t]) * blk + np.arange(blk)
            off = (bsr.tiles[t].numpy() == 0) & (row_mark[ri][:, None] | col_mark[cj][None, :])
            ii, jj = np.nonzero(off)
            i, j = ri[ii], cj[jj]
            s_off = (g[i] * h[j]).sum(1, dtype=np.float32)
            bad = np.isnan(l[i]) | ~np.isfinite(s_off - r[i]) | np.isnan(
                _act_grad(er[i] + el[j], act))
            der[i[bad]] = np.nan
            del_[j[bad]] = np.nan
            for a, b in zip(i[row_mark[i]], j[row_mark[i]]):
                dh[b, np.isnan(l[a]) | ~np.isfinite(g[a])] = np.nan
    return der[:n_er], del_[:n_el], dh[:n_src]


def _gat_case(bsr, d, seed, act):
    er, el, h, g = gat_inputs(bsr, d, seed)
    out, m, l = tbsr.bsr_gat_reference(bsr, er, el, h, act=act, return_stats=True)
    return er, el, h, g, out[:g.shape[0]], m, l


@pytest.mark.parametrize("act", ACTS)
def test_gat_grads_emulation_matches_plain_and_jax(act):
    bsr = TILINGS["square_with_empty_block_rows"]
    args = _gat_case(bsr, 24, 11, act)
    jb = jpk.bsr_from_scipy(CASES["square_with_empty_block_rows"]())
    want = jpk.bsr_gat_grads(jb, *(jnp.asarray(t.numpy()) for t in args), act=act)
    ref = tbsr.bsr_gat_grads_reference(bsr, *args, act=act)
    for got, plain, jax_out in zip(emulate_gat_grads(bsr, *args, act=act), ref, want):
        assert got.shape == plain.shape == jax_out.shape
        np.testing.assert_allclose(got, plain.numpy(), **GRAD)
        np.testing.assert_allclose(got, np.asarray(jax_out), **GRAD)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("name,d", [("skewed", 5), ("knn", 30), ("rectangular", 17),
                                    ("exact_blocks_dense", 8)])
def test_gat_grads_emulation_matches_plain(name, d, act):
    bsr = TILINGS[name]
    args = _gat_case(bsr, d, d, act)
    ref = tbsr.bsr_gat_grads_reference(bsr, *args, act=act)
    for got, plain in zip(emulate_gat_grads(bsr, *args, act=act), ref):
        np.testing.assert_allclose(got, plain.numpy(), **GRAD)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("d", NONFINITE_WIDTHS)
def test_gat_grads_emulation_repairs_nonfinite_inputs(d, act):
    """±inf, NaN, 0x7fffffff and ±3.4e38 in h and ḡ, some in rows and
    columns without edges (rows 5, 6 and the block-row of pad tiles; column
    300): the kernel's passes with the repair give the plain version's NaN
    and infinities; the passes alone miss NaN that only off-edge slots make."""
    bsr, er, el, h, g = gat_nonfinite_case(d)
    out, m, l = tbsr.bsr_gat_reference(bsr, er, el, h, act=act, return_stats=True)
    args = (er, el, h, g, out[:g.shape[0]], m, l)
    ref = [t.numpy() for t in tbsr.bsr_gat_grads_reference(bsr, *args, act=act)]
    got = emulate_gat_grads(bsr, *args, act=act)
    bare = emulate_gat_grads(bsr, *args, act=act, repair=False)
    for name, a, b in zip(("der", "del", "dh"), got, ref):
        assert np.isnan(b).any(), name
        np.testing.assert_allclose(a, b, equal_nan=True, err_msg=name, **GRAD)
    der, del_, dh = ref
    assert np.isnan(der[[5, 130]]).all() and np.isnan(del_[256:384]).any()
    assert not all(np.array_equal(np.isnan(a), np.isnan(b)) for a, b in zip(bare, ref))


# -- csrc/bsr_spmm_max.cu in numpy -----------------------------------------

# the order in which a warp meets a tile row's edges: by ballot of the lanes'
# float4 component q, lane l holding column 4 l + q
_BALLOT_ORDER = np.array([4 * lane + q for q in range(4) for lane in range(32)])


def emulate_spmm_max(bsr, h, weighted, slots):
    """csrc/bsr_spmm_max.cu's walk: the work items of ``work_schedule`` for
    ``slots`` resident thread blocks, each folding its tiles' edges into a
    running max per row (from -inf, NaN kept), found from the tile rows in
    ballot order (weighted) or from the edge bits (unweighted); split rows'
    partials then combined by max in chunk order."""
    blk, d = bsr.block, h.shape[1]
    h = h.numpy()
    sched = tbsr.work_schedule(bsr.rowptr.numpy(), slots)
    bits = tbsr.bsr_edge_mask(bsr).numpy().view(np.uint32)
    tiles, bcols = bsr.tiles.numpy(), bsr.block_cols.numpy()
    out = np.full((bsr.shape[0] // blk, blk, d), np.nan, np.float32)
    scratch = np.full((sched.n_slots, blk, d), np.nan, np.float32)
    for r, t0, t1, slot in sched.items:
        acc = np.full((blk, d), -np.inf, np.float32)
        for t in range(t0, t1):
            hs = h[bcols[t] * blk:(bcols[t] + 1) * blk]
            for i in range(blk):
                if weighted:
                    js = _BALLOT_ORDER[tiles[t, i, _BALLOT_ORDER] != 0]
                    msgs = tiles[t, i, js, None] * hs[js]
                else:
                    word_bits = (bits[t, i, :, None] >> np.arange(32, dtype=np.uint32)) & 1
                    msgs = hs[np.nonzero(word_bits.ravel())[0]]
                for msg in msgs:
                    acc[i] = np.maximum(acc[i], msg)  # NaN-keeping, as max.NaN.f32
        (out[r] if slot < 0 else scratch[slot])[...] = acc
    for r, slot0, k, _ in sched.rows:
        out[r] = scratch[slot0]
        for c in range(1, k):
            out[r] = np.maximum(out[r], scratch[slot0 + c])
    return out.reshape(-1, d)


def _max_cases():
    skew = skewed_bsr(seed=4)
    h = torch.from_numpy(np.random.default_rng(4).standard_normal((skew.shape[1], 6))
                         .astype(np.float32))
    h[3, 0], h[200, 1] = float("nan"), float("inf")
    edge_bsr, edge_h = max_edge_case()
    sq = tbsr.bsr_from_scipy(signed(CASES["square_with_empty_block_rows"]()))
    sq_h = torch.from_numpy(np.random.default_rng(5).standard_normal((sq.shape[1], 5))
                            .astype(np.float32))
    return {"skewed": (skew, h), "edge_case": (edge_bsr, edge_h), "square": (sq, sq_h)}


MAX_CASES = _max_cases()


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("name", sorted(MAX_CASES))
def test_spmm_max_emulation_matches_plain_exactly(name, weighted):
    bsr, h = MAX_CASES[name]
    sched = tbsr.work_schedule(bsr.rowptr.numpy(), 2)
    if name == "skewed":
        assert len(sched.rows)  # a block-row cut in chunks
    ref = tbsr.bsr_spmm_max_reference(bsr, h, weighted=weighted).numpy()
    got = emulate_spmm_max(bsr, h, weighted, slots=2)
    assert np.isneginf(got).any()
    np.testing.assert_array_equal(got, ref)
