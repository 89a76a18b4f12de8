"""Tracing and timing (counterpart: dance_tpu/utils/profile.py:20-67).

- :func:`trace`: ``torch.profiler`` around the enclosed block (the CPU, and
  the card when there is one), written as a Chrome trace
  (``trace.json`` in ``log_dir``);
- :class:`StageTimer`: wall-clock seconds per named stage;
- :func:`block_timed`: a call timed to the end of its device work.
"""

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

from dance_tpu_torch.settings import logger


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the enclosed block and write ``log_dir/trace.json`` (a
    ``dance_tpu_torch_trace`` folder under the temporary directory when
    None), which Perfetto's UI opens; yields ``log_dir``."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "dance_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("Trace (%.2fs) written to %s", time.perf_counter() - t0, path)


class StageTimer:
    """Accumulates wall-clock seconds per named stage; ``summary()`` -> dict
    of seconds (counterpart: profile.py:37)."""

    def __init__(self):
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._totals[name] += dt
            self._counts[name] += 1
            logger.debug("stage %s: %.3fs", name, dt)

    def summary(self) -> Dict[str, float]:
        return dict(self._totals)

    def report(self) -> str:
        lines = [f"{name:<40s} {total:8.3f}s  (n={self._counts[name]})"
                 for name, total in sorted(self._totals.items(), key=lambda kv: -kv[1])]
        return "\n".join(lines)


def _devices(out, found):
    if isinstance(out, torch.Tensor):
        found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _devices(v, found)
    return found


def block_timed(fn, *args, **kwargs):
    """Run ``fn`` and wait for the device work of its tensor outputs;
    returns ``(result, seconds)`` (counterpart: profile.py:62)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    for dev in _devices(out, set()):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


__all__ = ["StageTimer", "block_timed", "trace"]
