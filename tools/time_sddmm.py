"""Time the SDDMM (``bsr_sddmm``, csrc/bsr_sddmm.cu) in float32 and bf16,
and the bf16 SpMM (``bsr_spmm(compute_dtype=torch.bfloat16)``,
csrc/bsr_spmm.cu), on scDeepSort's bench tiling (3,039 tiles, d = 256)
against variants of their sources, in one process on one card, so that the
comparison shares the card and its power limit.

    python3 tools/time_sddmm.py                    # from the root of the checkout
    python3 tools/time_sddmm.py NAME=path/to.cu    # also another whole bsr_sddmm.cu

Each variant is the committed sources with the text edits listed in
``VARIANTS`` (file, old text, new text; or a whole other ``bsr_sddmm.cu``
given as ``NAME=PATH``), built into ``build/time_sddmm/<variant>/``
(git-ignored) and loaded in place of the package's kernels. The variants
run in the order committed, others, others reversed, committed; each run
checks each kernel against its plain version (``chip_smoke.REL_BOUND``),
then prints the per-call time of 10 calls queued back to back (median of
20) and the device time of the kernel's own launches (torch.profiler; it
misses some launches queued back to back, so a device time far below the
back-to-back time is a miss), with the registers and spills that ptxas
reported for the SDDMM. Imports no JAX.
"""
import re
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import numpy as np
import scipy.sparse as sp
import torch

import chip_smoke as cs
from dance_tpu_torch.graph import Graph
from dance_tpu_torch.ops import _build, bsr
from dance_tpu_torch.transforms import weighted_feature_pca

SOURCE = "bsr_sddmm.cu"
_MMA2_BODY = """  float s[4] = {0.f, 0.f, 0.f, 0.f};
  mma_acc(s, a0, b00, b01);
  mma_acc(s, a1, b10, b11);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += s[i];"""
VARIANTS = {
    "committed": [],
    # bf16: each k = 16 step summed from zero and added in float32
    "an add a step": [("bf16_mma.cuh", _MMA2_BODY, """  float s[4] = {0.f, 0.f, 0.f, 0.f};
  float u[4] = {0.f, 0.f, 0.f, 0.f};
  mma_acc(s, a0, b00, b01);
  mma_acc(u, a1, b10, b11);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += s[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += u[i];""")],
    # bf16: every product summed into the accumulators inside the mma, with
    # no float32 add on the CUDA cores (the mma truncates its sums)
    "sums in the mma": [("bf16_mma.cuh", _MMA2_BODY, """  mma_acc(c, a0, b00, b01);
  mma_acc(c, a1, b10, b11);""")],
    # the tile's accumulators stored from registers, a float2 a lane (each
    # quad of lanes one 32-byte sector), with no pass through shared memory
    "direct stores": [(SOURCE,
        """  tf32x3::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it becomes the output tile
""", """  tf32x3::cp_async_wait<0>();
  {
    float* o = out + static_cast<size_t>(t) * kBlock * kBlock;
    const int gq = lane / 4, t4 = lane % 4;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        float* c = o + (m0 + mt * 16 + gq) * kBlock + n0 + nt * 8 + 2 * t4;
        __stcs(reinterpret_cast<float2*>(c), make_float2(acc[mt][nt][0], acc[mt][nt][1]));
        __stcs(reinterpret_cast<float2*>(c + 8 * kBlock),
               make_float2(acc[mt][nt][2], acc[mt][nt][3]));
      }
    return;
  }
""")],
    # the SDDMM as 8 warps of 32 x 64: 128 registers a thread, each fragment
    # split serving half the products
    "8 warps of 32x64": [(SOURCE, "constexpr int kThreads = 128;",
                          "constexpr int kThreads = 256;"),
                         (SOURCE, "constexpr int kWarpsM = 2;", "constexpr int kWarpsM = 4;")],
}


def build_variant(name: str, edits=(), source=None):
    slug = re.sub(r"[^a-z0-9]+", "_", name.lower())
    root = REPO / "build" / "time_sddmm" / slug
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, root / "csrc")
    if source:
        shutil.copyfile(source, root / "csrc" / SOURCE)
    for file, old, new in edits:
        path = root / "csrc" / file
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: {old!r} is not in {file} exactly once")
        path.write_text(text.replace(old, new))
    committed = _build.CSRC_DIR
    _build.CSRC_DIR = root / "csrc"
    try:
        kernels = _build.build(root / "lib")
    finally:
        _build.CSRC_DIR = committed
    lines = kernels.log.splitlines()
    notes = [f"{'bf16' if 'kernelIt' in e else 'f32'}: {lines[i + 2].strip()}; "
             f"{lines[i + 3].strip()}" for i, e in enumerate(lines)
             if "Compiling entry" in e and "bsr_sddmm_kernel" in e and i + 3 < len(lines)]
    return kernels, notes


def use(kernels):
    """Make the package launch ``kernels``' functions."""
    _build.load_kernels = lambda: kernels


def bench_tiling(cuda):
    """chip_smoke phase 2's graph and its BSR tiling."""
    expr = sp.random(cs.N_CELLS, cs.N_GENES, density=cs.DENSITY, random_state=0,
                     dtype=np.float32, format="csr")
    cell_feat, gene_feat = weighted_feature_pca(expr, expr, cs.DIM, device=cuda)
    graph = Graph.from_cell_feature_matrix(expr, cell_feat, gene_feat)
    return graph.to_adaptive_bsr(device=cuda).bsr


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = torch.device("cuda")
    print(cs.card_line(), flush=True)
    a = bench_tiling(cuda)
    gen = torch.Generator().manual_seed(0)
    b = torch.randn((a.shape[1], cs.DIM), generator=gen).to(cuda)
    g = torch.randn((a.shape[0], cs.DIM), generator=gen).to(cuda)
    print(f"bench tiling: {a.nb} tiles, d = {cs.DIM}", flush=True)
    bf16 = torch.bfloat16
    calls = {  # name: (the call, its plain version, the kernels the profiler counts)
        "sddmm f32": (lambda: bsr.bsr_sddmm(a.block_rows, a.block_cols, g, b),
                      lambda: bsr.bsr_sddmm_reference(a.block_rows, a.block_cols, g, b),
                      ("bsr_sddmm_kernel",)),
        "sddmm bf16": (
            lambda: bsr.bsr_sddmm(a.block_rows, a.block_cols, g, b, compute_dtype=bf16),
            lambda: bsr.bsr_sddmm_reference(a.block_rows, a.block_cols, g, b, bf16),
            ("bsr_sddmm_kernel",)),
        "spmm bf16": (lambda: bsr.bsr_spmm(a, b, compute_dtype=bf16),
                      lambda: bsr.bsr_spmm_reference(a, b, bf16),
                      ("bsr_spmm_bf16_kernel", "bsr_spmm_reduce_kernel")),
    }
    refs = {label: plain() for label, (_, plain, _) in calls.items()}
    built = {name: build_variant(name, edits) for name, edits in VARIANTS.items()}
    for arg in sys.argv[1:]:
        name, path = arg.split("=", 1)
        built[name] = build_variant(name, source=path)
    others = [n for n in built if n != "committed"]
    for name in ["committed", *others, *reversed(others), "committed"]:
        kernels, notes = built[name]
        use(kernels)
        bsr.launch_geometry.cache_clear()
        a._schedules.clear()
        for label, (fn, _, names) in calls.items():
            cs.check(f"{name} {label}", [fn()], [refs[label]])
            b2b = cs.median_ms(fn, inner=cs.STREAM)
            dev = cs.device_ms(fn, names)
            print(f"{name:>18s} {label:>10s}: b2b {b2b!r} ms, device {dev!r} ms", flush=True)
        print(f"{name:>18s} ptxas: {notes}", flush=True)


if __name__ == "__main__":
    main()
