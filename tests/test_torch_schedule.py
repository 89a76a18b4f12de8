"""The SpMM kernel's work schedule and the 3xTF32 products of the CUDA kernels,
on the CPU (dance_tpu_torch.ops.bsr.work_schedule; csrc/tf32x3.cuh).

The schedule is plain numpy and is checked here directly: every tile of every
block-row in exactly one item, in order, split rows summed in chunk order.
The kernels' float32-accurate tensor-core products are emulated with numpy:
TF32 keeps 10 mantissa bits (the high part truncated, the low part rounded
to nearest, ties away), the three products of the 3xTF32 split are float32
matrix products. That
records why the port keeps its 1e-5 bound against the plain versions: one
TF32 product misses it, the split stays within float32's own rounding. No
JAX: the schedule has no JAX counterpart (the TPU grid runs in order).
"""

import numpy as np
import pytest
import torch

from dance_tpu_torch.ops import bsr as tbsr
from torch_cases import CASES, SKEWED_ROW_TILES, no_pad, skewed_bsr


def _tilings():
    out = {"skewed": skewed_bsr()}
    for case, make in CASES.items():
        bsr = tbsr.bsr_from_scipy(make())
        out[case] = bsr
        out[f"{case}-no_pad"] = no_pad(bsr)
        out[f"{case}-transposed"] = tbsr.bsr_transpose(bsr)
    out["skewed-transposed"] = tbsr.bsr_transpose(out["skewed"])
    return out


TILINGS = _tilings()


@pytest.mark.parametrize("name", sorted(TILINGS))
@pytest.mark.parametrize("n_sms,blocks_per_item", [(1, 1), (4, 2), (132, 8)])
def test_work_schedule_covers_every_tile_once_in_order(name, n_sms, blocks_per_item):
    bsr = TILINGS[name]
    rowptr = bsr.rowptr.numpy()
    slots = 2 * n_sms  # two resident thread blocks per SM
    sched = tbsr.work_schedule(rowptr, slots, blocks_per_item)
    nb, n_brows = int(rowptr[-1]), len(rowptr) - 1
    per_slot = -(-nb * blocks_per_item // slots)
    assert sched.chunk == max(tbsr.MIN_CHUNK, -(-per_slot // tbsr.ITEMS_PER_SLOT))
    items, rows = sched.items, sched.rows
    assert items.dtype == rows.dtype == np.int32
    lengths = items[:, 2] - items[:, 1]
    assert (lengths >= 0).all() and lengths.max(initial=0) <= sched.chunk
    assert (np.diff(lengths) <= 0).all()  # longest first
    split = {int(r): (int(s), int(k)) for r, s, k, _ in rows}
    seen_slots = []
    for r in range(n_brows):
        mine = items[items[:, 0] == r]
        mine = mine[np.argsort(mine[:, 1], kind="stable")]
        # consecutive runs that tile [rowptr[r], rowptr[r + 1]) exactly
        assert mine[0, 1] == rowptr[r] and mine[-1, 2] == rowptr[r + 1]
        np.testing.assert_array_equal(mine[1:, 1], mine[:-1, 2])
        n = rowptr[r + 1] - rowptr[r]
        if n <= sched.chunk:
            assert len(mine) == 1 and mine[0, 3] == -1 and r not in split
        else:
            slot0, k = split[r]
            assert k == len(mine) == -(-n // sched.chunk)
            # chunk c writes slot slot0 + c; sizes differ by at most one
            np.testing.assert_array_equal(mine[:, 3], slot0 + np.arange(k))
            assert np.ptp(mine[:, 2] - mine[:, 1]) <= 1
            seen_slots += list(mine[:, 3])
    assert sorted(seen_slots) == list(range(sched.n_slots))


def test_work_schedule_splits_the_long_row_and_bounds_the_longest_item():
    rowptr = skewed_bsr().rowptr.numpy()
    sched = tbsr.work_schedule(rowptr, slots=8, blocks_per_item=2)
    # 116 tiles x 2 blocks over 8 block slots: 29 tile-steps a slot
    chunk = -(-29 // tbsr.ITEMS_PER_SLOT)
    assert sched.chunk == chunk and 4 <= chunk < 110
    # the 110-tile row becomes k chunks of nearly equal size: the longest item
    # takes ceil(110 / k) tile-steps instead of 110
    k = -(-110 // chunk)
    longest = int((sched.items[:, 2] - sched.items[:, 1]).max())
    assert longest == -(-110 // k) and sched.rows.tolist() == [[1, 0, k, 0]]
    assert (sched.items[sched.items[:, 0] == 2][:, 1:3] == rowptr[2]).all()  # empty row kept
    assert len(sched.items) == k + sum(1 for n in SKEWED_ROW_TILES if n <= chunk)


@pytest.mark.parametrize("name", ["skewed", "square_with_empty_block_rows-no_pad",
                                  "exact_blocks_dense-transposed"])
def test_work_schedule_two_pass_sum_matches_plain_spmm(name):
    """Emulate the kernel's two passes from the schedule (each item's tiles
    summed into the output or its slot, then each split row's slots in
    chunk order) and hold the result against the plain version."""
    bsr = TILINGS[name]
    sched = tbsr.work_schedule(bsr.rowptr.numpy(), slots=2)
    blk, d = bsr.block, 24
    b = np.random.default_rng(0).standard_normal((bsr.shape[1], d)).astype(np.float32)
    tiles, cols = bsr.tiles.numpy(), bsr.block_cols.numpy()
    out = np.full((bsr.shape[0] // blk, blk, d), np.nan, np.float32)
    scratch = np.full((sched.n_slots, blk, d), np.nan, np.float32)
    for r, t0, t1, slot in sched.items:
        acc = np.zeros((blk, d), np.float32)
        for t in range(t0, t1):
            acc += tiles[t] @ b[cols[t] * blk:(cols[t] + 1) * blk]
        (out[r] if slot < 0 else scratch[slot])[...] = acc
    for r, slot0, k, _ in sched.rows:
        out[r] = scratch[slot0]
        for c in range(1, k):
            out[r] += scratch[slot0 + c]
    ref = tbsr.bsr_spmm_reference(bsr, torch.from_numpy(b)).numpy()
    # float32 sums of up to ~1,400 terms in another order: within 1e-5 of
    # the largest entry, the bound chip_smoke.py holds the kernel to
    np.testing.assert_allclose(out.reshape(ref.shape), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


# -- 3xTF32 ----------------------------------------------------------------


def tf32(x: np.ndarray) -> np.ndarray:
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``; ±inf and NaN pass unchanged."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    with np.errstate(over="ignore"):
        r = ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    return np.where(np.isfinite(x), r, x).astype(np.float32)


def truncate_tf32(x: np.ndarray) -> np.ndarray:
    """x with its 13 low mantissa bits cleared: what the mma reads of a
    float32 operand."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray, guard: bool = True):
    """``(big, hi, lo)`` of tf32x3::split: big = hi = x truncated to TF32,
    lo = rna(x - hi); with ``guard`` the correction parts are 0 where x is
    not finite."""
    big = truncate_tf32(x)
    with np.errstate(invalid="ignore"):
        lo = tf32(x - big)
    if not guard:
        return big, big, lo
    fin = np.isfinite(x)
    return big, np.where(fin, big, 0).astype(np.float32), np.where(fin, lo, 0).astype(np.float32)


def tf32x3_matmul(a: np.ndarray, b: np.ndarray, guard: bool = True) -> np.ndarray:
    """``a @ b`` as the kernels take it: a_lo b_hi + a_hi b_lo + a_big b_big,
    each product of TF32 parts exact in float32, summed in float32."""
    (ab, ah, al), (bb, bh, bl) = split(a, guard), split(b, guard)
    with np.errstate(invalid="ignore", over="ignore"):
        return (al @ bh + ah @ bl) + ab @ bb


def test_tf32x3_meets_the_float32_bound_where_tf32_does_not():
    """At scDeepSort's shape (a 128-row block-row of ~94 tiles, 12,032
    columns, tile density 0.3, d = 256): 3xTF32 stays within 1e-6 of the
    float32 product, relative to its largest entry; one TF32 product is
    ~3e-4 off, past the port's 1e-5 bound."""
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((128, 12032)) * (rng.random((128, 12032)) < 0.3)).astype(np.float32)
    b = rng.standard_normal((12032, 256)).astype(np.float32)
    ref = a @ b
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(ref).max()
    err3 = np.abs(tf32x3_matmul(a, b) - ref).max() / scale
    err1 = np.abs(tf32(a) @ tf32(b) - ref).max() / scale
    err_f32 = np.abs(ref - exact).max() / np.abs(exact).max()
    assert err3 <= 1e-6, err3
    assert err1 > 1e-5, err1
    assert err3 <= 4 * err_f32  # the size of float32's own rounding


def test_tf32_rounding_is_to_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32's ulp at 1.0
    x = np.array([1.0, 1 + ulp / 2, 1 + ulp / 4, -(1 + ulp / 2), 1 + ulp / 2 + ulp / 8],
                 np.float32)
    np.testing.assert_array_equal(tf32(x), np.array([1.0, 1 + ulp, 1.0, -(1 + ulp), 1 + ulp],
                                                    np.float32))
    big, _, lo = split(x)  # hi + lo holds these exactly
    np.testing.assert_array_equal(big.astype(np.float64) + lo, x.astype(np.float64))


def test_nonfinite_operands_give_the_plain_product_only_with_the_guard():
    """±inf and NaN: the correction parts of a non-finite operand are 0, so
    only big * big carries it and the result is the float32 product's, NaN
    for NaN and 0 * inf included. Unguarded, inf - inf = NaN in lo and
    0 * inf in a_lo b_hi (a = 1.0 has lo = 0) turn ±inf into NaN."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((16, 24)).astype(np.float32)
    a[:, 5] = 1.0          # TF32-exact: lo = 0
    a[3, 7] = 0.0
    a[4, 9] = np.inf
    b = rng.standard_normal((24, 8)).astype(np.float32)
    b[5, 0], b[5, 1], b[7, 2], b[2, 3] = np.inf, -np.inf, np.inf, np.nan
    with np.errstate(invalid="ignore", over="ignore"):
        ref = a @ b
    got = tf32x3_matmul(a, b)
    assert np.isinf(ref).any() and np.isnan(ref).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(got[np.isinf(ref)], ref[np.isinf(ref)])
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5, atol=1e-5)
    unguarded = tf32x3_matmul(a, b, guard=False)
    assert np.isnan(unguarded[np.isinf(ref)]).any()


def test_split_next_to_flt_max_stays_finite_and_exact():
    """A finite x within half a TF32 ulp of FLT_MAX would round to ±inf and
    make the correction terms inf - inf; truncated, hi stays finite, so
    hi + lo is x to within lo's rounding and the product is the float32
    one."""
    fmax = np.finfo(np.float32).max
    x = np.array([3.4024e38, 3.4028e38, fmax, -fmax, 3.4e38, 1.5], np.float32)
    big, hi, lo = split(x)
    assert np.isinf(tf32(x[:4])).all()  # what rounding hi would give
    assert np.isfinite(big).all() and np.isfinite(lo).all()
    np.testing.assert_array_equal(big, hi)
    # lo keeps 11 significant bits of x - hi, which is under a TF32 ulp of x
    np.testing.assert_allclose(big.astype(np.float64) + lo, x, rtol=2.0 ** -21, atol=0)
    rng = np.random.default_rng(5)
    a = rng.random((16, 24)).astype(np.float32)
    b = rng.standard_normal((24, 8)).astype(np.float32)
    b[3, :6] = x
    ref = a @ b
    got = tf32x3_matmul(a, b)
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)


# -- the GAT kernels' inputs and split rows --------------------------------


def test_edge_mask_bits_are_the_nonzero_slots():
    bsr = skewed_bsr(seed=1)
    bsr.tiles[0, 3, 5] = float("nan")  # NaN != 0: an edge, as in the plain version
    mask = tbsr.bsr_edge_mask(bsr)
    assert mask.dtype == torch.int32 and mask.shape == (bsr.nb, 128, 4)
    words = mask.numpy().view(np.uint32)
    bits = (words[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    np.testing.assert_array_equal(bits.reshape(bsr.nb, 128, 128).astype(bool),
                                  (bsr.tiles != 0).numpy())
    assert tbsr.bsr_edge_mask(bsr) is mask  # constant tiles: computed once and kept


@pytest.mark.parametrize("act", ["leaky_relu", "sigmoid"])
def test_gat_split_rows_combine_to_the_whole_softmax(act):
    """The GAT kernel's split rows: each chunk's softmax (acc = out l, m, l)
    over its own tiles, combined in chunk order as bsr_gat_combine_kernel
    does (M = max m_c, L = sum l_c e^(m_c - M), out = sum acc_c e^(m_c - M) /
    L), equals the softmax over the whole row."""
    from torch_cases import gat_inputs

    bsr = skewed_bsr(seed=2)
    er, el, h, _ = gat_inputs(bsr, 24, seed=2)
    whole, m_ref, l_ref = tbsr.bsr_gat_reference(bsr, er, el, h, act=act, return_stats=True)
    sched = tbsr.work_schedule(bsr.rowptr.numpy(), slots=2, blocks_per_item=2)
    (r, slot0, k, _), = sched.rows
    chunks = sorted((it for it in sched.items if it[0] == r), key=lambda it: it[3])
    parts = []
    for _, t0, t1, _ in chunks:
        keep = torch.arange(t0, t1)
        rows = bsr.block_rows[keep]
        sub = tbsr.BSRMatrix(bsr.tiles[keep], rows, bsr.block_cols[keep],
                             tbsr._rowptr(rows, bsr.shape[0] // 128), bsr.shape)
        out, m, l = tbsr.bsr_gat_reference(sub, er, el, h, act=act, return_stats=True)
        sl = slice(r * 128, (r + 1) * 128)
        parts.append((out[sl] * l[sl].clamp(min=1e-12)[:, None], m[sl], l[sl]))
    big_m = torch.stack([m for _, m, _ in parts]).amax(0)
    scales = [torch.exp(m - big_m) for _, m, _ in parts]
    big_l = sum(l * sc for (_, _, l), sc in zip(parts, scales))
    out = sum(acc * sc[:, None] for (acc, _, _), sc in zip(parts, scales))
    out = out / big_l.clamp(min=1e-12)[:, None]
    sl = slice(r * 128, (r + 1) * 128)
    assert k == len(chunks) > 1
    torch.testing.assert_close(big_m, m_ref[sl], rtol=0, atol=0)
    torch.testing.assert_close(big_l, l_ref[sl], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out, whole[sl], rtol=1e-5, atol=1e-5)
