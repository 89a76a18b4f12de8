"""Build and load the hand-written CUDA kernels of ``dance_tpu_torch/csrc``.

The JAX package needs no build: Pallas kernels are traced by ``jax.jit``
(dance_tpu/ops/pallas_kernels.py:101,159). Here the kernels are CUDA C++ for
Hopper (``sm_90a``), compiled by ``nvcc`` into one shared library with a plain
C interface and loaded with ``ctypes``. Each source is compiled on its own,
all of them at once, then the objects are linked:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \\
         -Xptxas -v -c -o build/dance_tpu_torch/<hash>.<pid>.objs/<name>.o csrc/<name>.cu
    nvcc -shared -o build/dance_tpu_torch/libdance_tpu_torch_<hash>.so <objects>  # once

The build happens at first use, under ``build/dance_tpu_torch/`` at the root
of the checkout, in a file keyed by a hash of the flags, the sources and the
headers they share (``csrc/*.cuh``), so a changed source or header rebuilds
and an unchanged one loads at once. There is no fallback: a missing ``nvcc``
or a failed build raises.

The host library of Louvain (``csrc/host/louvain.cpp``, a copy of
dance_tpu/native/louvain.cpp) is built the same way by the host compiler,
with the JAX package's flags (dance_tpu/native/__init__.py:29), so that its
floating-point contractions, and so its labels, are the same:

    g++ -O3 -march=native -shared -fPIC -o build/dance_tpu_torch/liblouvain_<hash>.so \
        csrc/host/louvain.cpp

``-march=native`` ties the library to the CPU it was built on, so the key
hashes the compiler's predefined macros under that flag (the instruction
sets it targets) with the flags and the source. A failed build raises too:
where the JAX package falls back to its numpy loop, the port does not.
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C symbol -> argument types (pointers and the stream as c_void_p, or ctypes
# would pass them as 32-bit ints)
SIGNATURES = {
    "dtt_bsr_spmm_f32": (_P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _P),
    "dtt_bsr_spmm_bf16": (_P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _P),
    "dtt_bsr_sddmm_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "dtt_bsr_sddmm_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "dtt_bsr_spmm_max_f32": (_P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _P),
    "dtt_bsr_gat_f32": (_P, _P, _P, _I, _P, _I) + (_P,) * 7 + (_I, _I, _F, _I, _P),
    "dtt_bsr_gat_stats_f32": (_P, _P, _P, _I, _P, _I) + (_P,) * 9 + (_I, _I, _F, _I, _P),
    "dtt_bsr_gat_grads_f32": (_P,) * 20 + (_I,) * 6 + (_F, _I, _P),
    "dtt_bsr_spmm_info": (_I, _P, _I),
    "dtt_bsr_spmm_bf16_info": (_I, _P, _I),
    "dtt_bsr_gat_info": (_I, _P, _I),
    "dtt_bsr_spmm_max_info": (_I, _P, _I),
}


HOST_DIR = CSRC_DIR / "host"
HOST_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_I32, _I64, _U64, _D = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64, ctypes.c_double


@dataclass
class Kernels:
    """The loaded library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an existing build was loaded
    log: str              # the compiler's output (nvcc: ptxas registers / shared memory)


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
                       "dance_tpu_torch/csrc cannot be built")


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def headers():
    """The shared headers the sources include (``tf32x3.cuh``, ``bf16_mma.cuh``)."""
    return sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    """Key of a build: the flags, every source and every shared header, so
    that an edited header rebuilds too."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def compile_commands(nvcc: str, obj_dir: Path):
    """One ``nvcc -c`` per source, and the objects they write."""
    objs = [obj_dir / f"{src.stem}.o" for src in sources()]
    return [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources(), objs)], objs


def _run_all(cmds):
    """Run the commands at once; return each one's (returncode, output)."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    return [(proc.returncode, out) for proc, out in
            ((proc, proc.communicate()[0]) for proc in procs)]


def build(build_dir: Path = BUILD_DIR) -> Kernels:
    """Compile ``csrc/*.cu`` unless a build of the same sources exists; load it."""
    key = source_hash()
    path = build_dir / f"libdance_tpu_torch_{key}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        nvcc = find_nvcc()
        obj_dir = build_dir / f"{key}.{os.getpid()}.objs"
        obj_dir.mkdir(parents=True, exist_ok=True)
        cmds, objs = compile_commands(nvcc, obj_dir)
        t0 = time.perf_counter()
        results = _run_all(cmds)
        log = "".join(out for _, out in results)
        failed = [(cmd, rc) for cmd, (rc, _) in zip(cmds, results) if rc != 0]
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        if not failed:
            link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
            (rc, out), = _run_all([link])
            log += out
            if rc != 0:
                failed = [(link, rc)]
        seconds = time.perf_counter() - t0
        shutil.rmtree(obj_dir, ignore_errors=True)
        if failed:
            tmp.unlink(missing_ok=True)
            cmd, rc = failed[0]
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{log}")
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


def find_host_compiler() -> str:
    """``g++`` (the JAX package's compiler), else ``c++``."""
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (g++, c++) on PATH: the Louvain library of "
                       "dance_tpu_torch/csrc/host cannot be built")


def host_hash(cxx: str, src: Path) -> str:
    """Key of a host build: the flags, the source and the instruction sets
    that ``-march=native`` selects on this machine."""
    macros = subprocess.run([cxx, "-march=native", "-dM", "-E", "-x", "c++", os.devnull],
                            capture_output=True, text=True, check=True).stdout
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    for part in (cxx.encode(), macros.encode(), src.read_bytes()):
        h.update(part)
    return h.hexdigest()[:16]


def build_louvain(build_dir: Path = BUILD_DIR) -> Kernels:
    """Compile ``csrc/host/louvain.cpp`` unless a build of the same key
    exists; load it and declare ``louvain_csr``'s C signature."""
    src = HOST_DIR / "louvain.cpp"
    cxx = find_host_compiler()
    path = build_dir / f"liblouvain_{host_hash(cxx, src)}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *HOST_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        (rc, log), = _run_all([cmd])
        seconds = time.perf_counter() - t0
        if rc != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cxx} failed ({rc}): {' '.join(cmd)}\n{log}")
        os.replace(tmp, path)  # atomic: concurrent builds each write their own file
    lib = ctypes.CDLL(str(path))
    lib.louvain_csr.argtypes = (_P, _P, _P, _I64, _D, _U64, _I32, _I32, _P)
    lib.louvain_csr.restype = _I32
    return Kernels(lib, path, seconds, log)


@functools.lru_cache(maxsize=None)
def load_louvain() -> Kernels:
    """The process-wide Louvain library (built at first call)."""
    return build_louvain()


__all__ = ["Kernels", "build", "build_louvain", "compile_commands", "find_host_compiler",
           "find_nvcc", "headers", "host_hash", "load_kernels", "load_louvain", "source_hash"]
