"""Instruction mix of the tensor-core kernels as compiled for the card: builds
the kernels (``dance_tpu_torch.ops._build``), disassembles the library with
``cuobjdump -sass`` and prints, per kernel, its instruction count, its HMMA
count and the most frequent opcodes. A kernel whose main loop issues many
instructions per HMMA is bound by issue, not by the tensor cores.

    python3 tools/sass_mix.py

Needs the CUDA toolkit (``nvcc``, ``cuobjdump``); runs no kernel. Imports no JAX.
"""
import collections
import os
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from dance_tpu_torch.ops._build import load_kernels

KERNELS = ("bsr_spmm_kernel", "bsr_spmm_reduce_kernel", "bsr_gat_kernel",
           "bsr_gat_combine_kernel")


def main() -> int:
    lib = load_kernels().path
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    mixes, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            mixes[name] = collections.Counter()
        elif name and "*/" in line and ";" in line:
            words = line.split("*/", 1)[1].strip().rstrip(" ;").split()
            if words and words[0].startswith("@"):  # predicate
                words = words[1:]
            if words:
                mixes[name][words[0].split(".")[0]] += 1
    for name, mix in mixes.items():
        if not any(k in name for k in KERNELS):
            continue
        total, hmma = sum(mix.values()), mix.get("HMMA", 0)
        top = ", ".join(f"{op} {n}" for op, n in mix.most_common(16))
        per = f", {total / hmma:.2f} per HMMA" if hmma else ""
        print(f"{name[:90]}: {total} instructions, {hmma} HMMA{per}; {top}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
