"""Build and load the hand-written CUDA kernels of ``dance_tpu_torch/csrc``.

The JAX package needs no build: Pallas kernels are traced by ``jax.jit``
(dance_tpu/ops/pallas_kernels.py:101,159). Here the kernels are CUDA C++ for
Hopper (``sm_90a``), compiled by ``nvcc`` into one shared library with a plain
C interface and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/dance_tpu_torch/lib....so csrc/*.cu

The build happens at first use, under ``build/dance_tpu_torch/`` at the root
of the checkout, in a file keyed by a hash of the sources and flags, so a
changed source rebuilds and an unchanged one loads at once. There is no
fallback: a missing ``nvcc`` or a failed build raises.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dance_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C symbol -> argument types (pointers and the stream as c_void_p, or ctypes
# would pass them as 32-bit ints)
SIGNATURES = {
    "dtt_bsr_spmm_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "dtt_bsr_sddmm_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
}


@dataclass
class Kernels:
    """The loaded library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an existing build was loaded
    log: str              # nvcc's output (ptxas registers / shared memory)


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
                       "dance_tpu_torch/csrc cannot be built")


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(build_dir: Path = BUILD_DIR) -> Kernels:
    """Compile ``csrc/*.cu`` unless a build of the same sources exists; load it."""
    path = build_dir / f"libdance_tpu_torch_{source_hash()}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        nvcc = find_nvcc()
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
        os.replace(tmp, path)  # atomic: a concurrent build never loads half a file
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return Kernels(lib, path, seconds, log)


@functools.lru_cache(maxsize=None)
def load_kernels() -> Kernels:
    """The process-wide loaded kernel library (built at first call)."""
    return build()


__all__ = ["Kernels", "build", "find_nvcc", "load_kernels", "source_hash"]
