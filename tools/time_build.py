"""Time the kernel build of ``dance_tpu_torch/csrc`` with the sources
compiled one after another and all at once (as ``ops._build.build`` does),
in the order serial, parallel, parallel, serial. The link step is timed
with each.

    python3 tools/time_build.py

Needs ``nvcc``; writes its objects under the git-ignored ``build/`` and
removes them. Imports no JAX.
"""
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from dance_tpu_torch.ops import _build


def one_build(nvcc: str, work: Path, parallel: bool) -> float:
    work.mkdir(parents=True)
    cmds, objs = _build.compile_commands(nvcc, work)
    t0 = time.perf_counter()
    if parallel:
        results = _build._run_all(cmds)
    else:
        results = [_build._run_all([cmd])[0] for cmd in cmds]
    link = [nvcc, "-shared", "-o", str(work / "lib.so"), *map(str, objs)]
    results += _build._run_all([link])
    seconds = time.perf_counter() - t0
    for (rc, out), cmd in zip(results, cmds + [link]):
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
    shutil.rmtree(work)
    return seconds


def main() -> int:
    nvcc = _build.find_nvcc()
    root = _build.BUILD_DIR / "time_build"
    shutil.rmtree(root, ignore_errors=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    print(f"{len(_build.sources())} sources: {', '.join(s.name for s in _build.sources())}")
    times = {"serial": [], "parallel": []}
    for i, mode in enumerate(("serial", "parallel", "parallel", "serial")):
        times[mode].append(one_build(nvcc, root / str(i), mode == "parallel"))
        print(f"{mode}: {times[mode][-1]!r} s", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    for mode, ts in times.items():
        print(f"{mode} median {statistics.median(ts)!r} s over {len(ts)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
