"""Port parity for bf16 streaming (``compute_dtype`` / ``bsr_dtype``): the
plain versions of the bf16 SpMM and SDDMM, ``bsr_spmm_ad``'s gradients,
``AdaptiveSAGE(bsr_dtype=...)`` and ``AdaptiveSAGE(use_norm=False)`` against
the JAX package's ``compute_dtype=jnp.bfloat16`` path.

The JAX side runs the Pallas kernels in interpret mode on the CPU, as
tests/test_gnn.py:70-125 does. Inputs are made with numpy from a seed and
handed to both packages. Both round the operands to bf16 to nearest even
(JAX's ``astype``, torch's ``.to``; bit-equal, checked below) and sum the
exact float32 products of the rounded values in float32, in another order:
so the outputs and gradients agree at 1e-5 of the largest reference value,
as the float32 path does (tests/test_torch_kernels.py). On the card the
kernels are held against these plain versions in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dance_tpu.nn.gnn import AdaptiveSAGE as JAdaptiveSAGE
from dance_tpu.ops import pallas_kernels as jpk
from dance_tpu_torch.graph import Graph
from dance_tpu_torch.modules.single_modality.cell_type_annotation import ScDeepSort
from dance_tpu_torch.nn.gnn import AdaptiveSAGE
from dance_tpu_torch.ops import bsr as tbsr
from torch_cases import CASES, dense

BF16 = torch.bfloat16
REL = 1e-5  # of max |reference|: float32 sums of the same exact products


def _close(got, want, rel=REL, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, f"{name}: max error {err} of max |ref| above {rel}"


def _gnn_case(seed=2):
    """tests/test_gnn.py:70's 300 x 200 case: a random graph plus a diagonal,
    so that every tile row has a tile."""
    adj = sp.random(300, 200, density=0.05, random_state=seed, format="csr", dtype=np.float32)
    return adj + sp.csr_matrix((np.ones(200, np.float32), (np.arange(200), np.arange(200))),
                               shape=(300, 200))


def test_bf16_rounding_matches_jax():
    """torch's ``.to(bfloat16)`` and JAX's ``astype`` round alike, ties to
    even, infinities and NaN included."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32) * 10,
                        np.float32([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 3.4e38,
                                    np.inf, -np.inf, 1e-40, 0.0, -0.0])])
    j = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    t = torch.from_numpy(x).to(BF16).float().numpy()
    np.testing.assert_array_equal(t.view(np.uint32), j.view(np.uint32))
    nan = torch.tensor([np.nan]).to(BF16).float()
    assert torch.isnan(nan).all() and np.isnan(np.asarray(jnp.float32(np.nan).astype(
        jnp.bfloat16), np.float32))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [16, 50, 140])
def test_spmm_bf16_matches_jax(case, d):
    adj = CASES[case]()
    rng = np.random.default_rng(d)
    bsr = tbsr.bsr_from_scipy(adj)
    b = rng.standard_normal((bsr.shape[1], d)).astype(np.float32)
    ref = np.asarray(jpk.bsr_spmm(jpk.bsr_from_scipy(adj), jnp.asarray(b),
                                  compute_dtype=jnp.bfloat16))
    n = tbsr.bsr_spmm.launches, tbsr.bsr_spmm.launches_bf16
    out = tbsr.bsr_spmm(bsr, torch.from_numpy(b), compute_dtype=BF16)
    assert out.dtype == torch.float32
    assert (tbsr.bsr_spmm.launches, tbsr.bsr_spmm.launches_bf16) == n  # the CPU launches none
    _close(out.numpy(), ref, name="A @ B")
    # the plain version is the float32 product of the rounded operands
    rounded = dense(tbsr.BSRMatrix(bsr.tiles.to(BF16).float(), bsr.block_rows, bsr.block_cols,
                                   bsr.rowptr, bsr.shape))
    b16 = torch.from_numpy(b).to(BF16).double().numpy()
    _close(out.numpy(), rounded @ b16, name="against float64")


@pytest.mark.parametrize("d", [50, 96, 130])
def test_sddmm_bf16_matches_jax(d):
    adj = CASES["square_with_empty_block_rows"]()
    rng = np.random.default_rng(d)
    bsr = tbsr.bsr_from_scipy(adj)
    g = rng.standard_normal((bsr.shape[0], d)).astype(np.float32)
    b = rng.standard_normal((bsr.shape[1], d)).astype(np.float32)
    jb = jpk.bsr_from_scipy(adj)
    ref = np.asarray(jpk.bsr_sddmm(jb.block_rows, jb.block_cols, jnp.asarray(g),
                                   jnp.asarray(b), compute_dtype=jnp.bfloat16))
    out = tbsr.bsr_sddmm(bsr.block_rows, bsr.block_cols, torch.from_numpy(g),
                         torch.from_numpy(b), compute_dtype=BF16)
    _close(out.numpy(), ref)
    plain = tbsr.bsr_sddmm_reference(bsr.block_rows, bsr.block_cols, torch.from_numpy(g),
                                     torch.from_numpy(b), BF16)
    assert torch.equal(out, plain)
    # bf16 differs from float32 by bf16's rounding, not by more
    f32 = tbsr.bsr_sddmm_reference(bsr.block_rows, bsr.block_cols, torch.from_numpy(g),
                                   torch.from_numpy(b))
    _close(out.numpy(), f32.numpy(), rel=2e-2)


def test_spmm_ad_bf16_grads_match_jax():
    """Gradients for the tiles and B in bf16 against ``jax.grad`` through JAX's
    ``bsr_spmm_ad(compute_dtype=jnp.bfloat16)``: dB = Aᵀḡ on the rounded
    transposed tiles and ḡ, dA by the SDDMM on the rounded ḡ and B."""
    adj = _gnn_case()
    rng = np.random.default_rng(3)
    bsr = tbsr.bsr_from_scipy(adj)
    b = rng.standard_normal((bsr.shape[1], 96)).astype(np.float32)
    w = rng.standard_normal((bsr.shape[0], 96)).astype(np.float32)
    jb = jpk.bsr_from_scipy(adj)

    def jloss(blocks, bb):
        m = jpk.BSRMatrix(blocks, jb.block_rows, jb.block_cols, jb.shape)
        return jnp.sum(jpk.bsr_spmm_ad(m, bb, compute_dtype=jnp.bfloat16) ** 2 * w)

    jd_tiles, jd_b = jax.grad(jloss, argnums=(0, 1))(jb.blocks, jnp.asarray(b))

    tb = torch.from_numpy(b).requires_grad_(True)
    bsr.tiles.requires_grad_(True)
    out = tbsr.bsr_spmm_ad(bsr, tb, compute_dtype=BF16)
    (out ** 2 * torch.from_numpy(w)).sum().backward()
    _close(tb.grad.numpy(), jd_b, name="dB")
    _close(bsr.tiles.grad.numpy(), jd_tiles, name="dA")
    # float32 is None: the same function, bit for bit
    tb32 = torch.from_numpy(b)
    assert torch.equal(tbsr.bsr_spmm_ad(bsr, tb32, compute_dtype=torch.float32),
                       tbsr.bsr_spmm_ad(bsr, tb32))


def _sage_params(jparams, use_norm):
    p = jax.tree_util.tree_map(np.asarray, jparams)
    state = {"linear.weight": torch.tensor(p["Dense_0"]["kernel"].T),
             "linear.bias": torch.tensor(p["Dense_0"]["bias"])}
    if use_norm:
        state.update({"norm.weight": torch.tensor(p["LayerNorm_0"]["scale"]),
                      "norm.bias": torch.tensor(p["LayerNorm_0"]["bias"])})
    return state


def _sage_run(branch, use_norm, exact=False, seed=7):
    """One AdaptiveSAGE forward and backward in each package from the flax
    weights (``dance_tpu_torch.utils.params``'s mapping), ``bsr_dtype`` bf16.
    With ``exact`` the kernel and ``w_out`` are multiples of 1/16 in [-1, 1]:
    the cotangent ``w_out Wᵀ`` is exact in float32, so both packages hand
    the SpMM's backward the same float32 cotangent and round it alike."""
    from dance_tpu.graph import Graph as JGraph

    rng = np.random.default_rng(seed)
    expr = sp.random(160, 70, density=0.2, random_state=seed, dtype=np.float32, format="csr")
    cf, gf = rng.random((160, 12), dtype=np.float32), rng.random((70, 12), dtype=np.float32)
    j, t = (JGraph.from_cell_feature_matrix(expr, cf, gf),
            Graph.from_cell_feature_matrix(expr, cf, gf))
    n_genes = t.info["num_genes"]
    alpha = rng.normal(1.0, 0.3, n_genes + 2).astype(np.float32)
    h = np.asarray(t.ndata["features"])
    w_out = rng.standard_normal((t.num_nodes, 8)).astype(np.float32)
    jadj = j.to_adaptive_bsr(dense=branch == "dense")
    gene_id = j.to_device().ndata["cell_id"]
    jlayer = JAdaptiveSAGE(out_dim=8, dropout=0.0, use_norm=use_norm, bsr_dtype=jnp.bfloat16)
    params = jlayer.init(jax.random.key(0), jadj, jnp.asarray(h), gene_id,
                         jnp.asarray(alpha))["params"]
    assert ("LayerNorm_0" in params) == use_norm
    if exact:
        w_out = (rng.integers(-16, 17, w_out.shape) / 16).astype(np.float32)
        kernel = rng.integers(-16, 17, params["Dense_0"]["kernel"].shape) / 16
        params = {**params, "Dense_0": {**params["Dense_0"],
                                        "kernel": jnp.asarray(kernel, jnp.float32)}}

    def jloss(params, h, alpha):
        return jnp.sum(jlayer.apply({"params": params}, jadj, h, gene_id, alpha) * w_out)

    jout = jlayer.apply({"params": params}, jadj, jnp.asarray(h), gene_id, jnp.asarray(alpha))
    jg_params, jg_h, jg_alpha = jax.grad(jloss, argnums=(0, 1, 2))(
        params, jnp.asarray(h), jnp.asarray(alpha))

    def port(dtype):
        layer = AdaptiveSAGE(h.shape[1], 8, dropout=0.0, use_norm=use_norm, bsr_dtype=dtype)
        layer.load_state_dict(_sage_params(params, use_norm))
        th = torch.from_numpy(h.copy()).requires_grad_(True)
        talpha = torch.from_numpy(alpha.copy()).requires_grad_(True)
        out = layer(t.to_adaptive_bsr(dense=branch == "dense", device="cpu"), th,
                    torch.from_numpy(t.ndata["cell_id"].astype(np.int64)), talpha)
        (out * torch.from_numpy(w_out)).sum().backward()
        got = {"out": out, "dh": th.grad, "dalpha": talpha.grad, "dW": layer.linear.weight.grad}
        if use_norm:
            got["dscale"] = layer.norm.weight.grad
        else:
            assert layer.norm is None and not any(k.startswith("norm")
                                                  for k in layer.state_dict())
        return {k: v.detach().numpy() for k, v in got.items()}

    want = {"out": jout, "dh": jg_h, "dalpha": jg_alpha,
            "dW": np.asarray(jg_params["Dense_0"]["kernel"]).T}
    if use_norm:
        want["dscale"] = jg_params["LayerNorm_0"]["scale"]
    return port(BF16), port(None), want


@pytest.mark.parametrize("branch,use_norm,exact", [("bsr", False, True), ("bsr", True, False),
                                                   ("dense", True, False)])
def test_adaptive_sage_bf16_matches_jax(branch, use_norm, exact):
    """The BSR branch streams its SpMM in bf16 (alpha's scaling stays float32
    before the cast, as in JAX); the dense branch ignores ``bsr_dtype``, as
    JAX's does. ``use_norm=False`` drops the LayerNorm and its weights, as
    flax's layer does (gnn.py:88, :147-148).

    The forward and the weights' gradients hold at 1e-5. So do the
    gradients of h and alpha, which come out of the backward SpMM, where the
    cotangent reaching it is the same in both packages (``exact``). After
    a LayerNorm it is not: each package's float32 rounding of its backward
    puts a few cotangent values on either side of a bf16 rounding midpoint
    (one of 3,072 here), and such a value is rounded one bf16 step (2^-8 of
    it) apart, which moves the gradients below by ~2e-5 of their largest
    value. There they hold at 1e-4, still ten times inside the ~1e-3 by
    which the float32 layer's gradients differ."""
    got, f32, want = _sage_run(branch, use_norm, exact)
    for name in want:
        below = name in ("dh", "dalpha") and branch == "bsr" and not exact
        _close(got[name], want[name], rel=1e-4 if below else REL, name=name)
    if branch == "bsr":
        # bf16 streaming shows: it moved the output and the gradients below it
        for name in ("out", "dh"):
            gap = np.abs(got[name] - f32[name]).max() / np.abs(f32[name]).max()
            assert gap > 5e-4, f"{name}: bf16 within {gap} of float32"
    else:
        for name in want:
            np.testing.assert_array_equal(got[name], f32[name])


def test_compute_dtype_takes_bf16_and_float32_only():
    bsr = tbsr.bsr_from_scipy(CASES["rectangular"]())
    b = torch.ones((bsr.shape[1], 8))
    g = torch.ones((bsr.shape[0], 8))
    for dtype in (torch.float16, torch.float64, "bfloat16"):
        with pytest.raises(ValueError, match="ROADMAP"):
            tbsr.bsr_spmm(bsr, b, compute_dtype=dtype)
        with pytest.raises(ValueError, match="ROADMAP"):
            tbsr.bsr_sddmm(bsr.block_rows, bsr.block_cols, g, b, compute_dtype=dtype)
        with pytest.raises(ValueError, match="ROADMAP"):
            tbsr.bsr_spmm_ad(bsr, b, compute_dtype=dtype)
    assert tbsr.compute_dtype_of("x", torch.float32) is None
    assert tbsr.compute_dtype_of("x", None) is None
    assert tbsr.compute_dtype_of("x", BF16) is BF16
    rng = np.random.default_rng(0)
    expr = sp.random(60, 25, density=0.25, random_state=0, dtype=np.float32, format="csr")
    graph = Graph.from_cell_feature_matrix(expr, rng.random((60, 6), dtype=np.float32),
                                           rng.random((25, 6), dtype=np.float32))
    m = ScDeepSort(dim_in=6, dim_hid=8, num_layers=2, device="cpu")
    with pytest.raises(ValueError, match="ROADMAP"):
        m.fit(graph, rng.integers(0, 3, 60), epochs=1, use_bsr=True, bsr_dtype=torch.float16)


def test_bf16_tiles_are_kept_and_follow_in_place_edits():
    """The bf16 copy of the tiles is made once and kept beside the transpose,
    and built again after ``tiles.mul_`` or a replaced tile tensor
    (``ops.bsr._drop_stale``); for trainable tiles it is never kept."""
    bsr = tbsr.bsr_from_scipy(_gnn_case(4))
    kept = tbsr.bsr_compute_tiles(bsr, BF16)
    assert kept.dtype == BF16 and tbsr.bsr_compute_tiles(bsr, BF16) is kept
    assert torch.equal(kept, bsr.tiles.to(BF16))
    at = tbsr.bsr_transpose(bsr)
    kept_t = tbsr.bsr_compute_tiles(at, BF16)
    assert torch.equal(kept_t, at.tiles.to(BF16))

    g = torch.randn((bsr.shape[0], 16), generator=torch.Generator().manual_seed(0))

    def grad_b():
        b = torch.linspace(-1, 1, bsr.shape[1] * 16).reshape(-1, 16).requires_grad_(True)
        (tbsr.bsr_spmm_ad(bsr, b, compute_dtype=BF16) * g).sum().backward()
        return b.grad

    first = grad_b()
    g16 = g.to(BF16).double().numpy()
    _close(first.numpy(), dense(tbsr.BSRMatrix(kept.float(), bsr.block_rows, bsr.block_cols,
                                               bsr.rowptr, bsr.shape)).T @ g16)
    bsr.tiles.mul_(2.0)  # exact in bf16 too
    again = tbsr.bsr_compute_tiles(bsr, BF16)
    assert again is not kept and torch.equal(again, 2 * kept)
    assert tbsr.bsr_transpose(bsr) is not at
    assert torch.equal(grad_b(), 2 * first)
    bsr.tiles = bsr.tiles / 2  # a replaced tensor is followed too
    assert torch.equal(tbsr.bsr_compute_tiles(bsr, BF16), kept)
    assert torch.equal(grad_b(), first)
    trainable = tbsr.bsr_from_scipy(_gnn_case(4))
    trainable.tiles.requires_grad_(True)
    assert torch.equal(tbsr.bsr_compute_tiles(trainable, BF16), kept)
    assert trainable._tiles_bf16 is None
