"""Time the BSR max aggregation (``bsr_spmm_max``, csrc/bsr_spmm_max.cu) on
graph-sc's tiling at d = 200 against variants of its source, in one process
on one card, so that the comparison shares the card and its power limit.

    python3 tools/time_max.py            # from the root of the checkout

Each variant is the committed source with the text edits listed in
``VARIANTS``, built into ``build/time_max/<variant>/`` (git-ignored) and
loaded in place of the package's kernels. The variants run in the order
committed, others, others reversed, committed; each run checks the kernel
against its plain version (equal, NaN and -inf included), then prints the
per-call time of 10 calls queued back to back (median of 20) and the device
time of the kernel's own launches (torch.profiler), weighted and unweighted,
with the registers that ptxas gave the fold kernel. Imports no JAX.
"""
import re
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import torch

import chip_smoke as cs
from dance_tpu_torch.modules.single_modality.clustering import graphsc_preprocess
from dance_tpu_torch.ops import _build, bsr

SOURCE = "bsr_spmm_max.cu"
VARIANTS = {
    "committed": [],
    # 16 warps of 8 rows each: fewer warps in flight
    "512 threads": [("constexpr int kThreads = 1024;", "constexpr int kThreads = 512;")],
    # one edge an iteration: its message loaded, then folded
    "one edge at once": [(
        """  for (; bits & (bits - 1); bits &= bits - 1) {
    const int b0 = __ffs(bits) - 1;
    bits &= bits - 1;
    const float4 m0 = message(b0), m1 = message(__ffs(bits) - 1);
    fold(acc, m0);
    fold(acc, m1);
  }
  if (bits) fold(acc, message(__ffs(bits) - 1));""",
        """  for (; bits; bits &= bits - 1) fold(acc, message(__ffs(bits) - 1));""")],
}


def build_variant(name: str, edits):
    slug = re.sub(r"[^a-z0-9]+", "_", name.lower())
    root = REPO / "build" / "time_max" / slug
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, root / "csrc")
    path = root / "csrc" / SOURCE
    text = path.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: {old!r} is not in {SOURCE} exactly once")
        text = text.replace(old, new)
    path.write_text(text)
    committed = _build.CSRC_DIR
    _build.CSRC_DIR = root / "csrc"
    try:
        kernels = _build.build(root / "lib")
    finally:
        _build.CSRC_DIR = committed
    regs = [line.strip() for line in kernels.log.splitlines() if "registers" in line]
    entries = [line for line in kernels.log.splitlines() if "Compiling entry" in line]
    fold = [r for e, r in zip(entries, regs) if "bsr_spmm_max_kernel" in e]
    return kernels, fold


def use(kernels):
    """Make the package launch ``kernels``' functions."""
    _build.load_kernels = lambda: kernels
    bsr.launch_geometry.cache_clear()


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = torch.device("cuda")
    print(cs.card_line(), flush=True)
    counts, _ = cs.clustered_counts(cs.GSC_CELLS, cs.GSC_GENES, cs.GSC_TYPES, seed=0)
    g, _ = graphsc_preprocess(counts, n_top_genes=cs.GSC_HVG, device=cuda)
    tiling = g.to_bsr(device=cuda)
    d = cs.GSC_HIDDEN
    h = torch.randn((tiling.shape[1], d), generator=torch.Generator().manual_seed(3)).to(cuda)
    print(f"graph-sc tiling: {tiling.nb} tiles, {cs.edge_count(tiling)} edges, d = {d}",
          flush=True)
    refs = {w: bsr.bsr_spmm_max_reference(tiling, h, weighted=w) for w in (True, False)}
    built = {name: build_variant(name, edits) for name, edits in VARIANTS.items()}
    others = [n for n in VARIANTS if n != "committed"]
    for name in ["committed", *others, *reversed(others), "committed"]:
        kernels, fold = built[name]
        use(kernels)
        tiling._schedules.clear()
        for weighted in (True, False):
            fn = lambda: bsr.bsr_spmm_max(tiling, h, weighted=weighted)  # noqa: E731
            cs.check_max(f"{name} weighted={weighted}", fn(), refs[weighted])
            b2b = cs.median_ms(fn, inner=cs.STREAM)
            dev = cs.device_ms(fn, ("bsr_spmm_max",))
            geo = bsr.launch_geometry("max", d, torch.cuda.current_device())
            print(f"{name:>12s} weighted={weighted!s:5s}: b2b {b2b!r} ms, device {dev!r} ms; "
                  f"{geo['threads']} threads, {geo['blocks_per_sm']} blocks/SM; {fold}",
                  flush=True)


if __name__ == "__main__":
    main()
