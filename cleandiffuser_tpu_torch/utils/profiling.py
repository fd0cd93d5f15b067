"""Profiling hooks (counterpart of cleandiffuser_tpu/utils/profiling.py).

- `trace(log_dir, with_memory=True)`: a context manager that profiles the
  enclosed region with `torch.profiler` (the CPU, and CUDA activity when
  a CUDA device is present) and writes a Chrome trace, which TensorBoard's
  profiler plugin also reads, into `log_dir`; `with_memory` records
  tensor allocations too. It yields the profiler, whose `key_averages()`
  read the region's operator times.
- `annotate(name)`: a named range (`torch.profiler.record_function`),
  visible in the trace and in the profiler's events, as the ranges the
  pipelines open around a plan's stages.
- `Throughput`: an items/s meter with EMA smoothing.

Nothing on a pipeline's path calls these; a benchmark harness does.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

__all__ = ["trace", "annotate", "Throughput"]


@contextlib.contextmanager
def trace(log_dir: str, with_memory: bool = True):
    """Profile the enclosed region; its trace goes to
    `log_dir/trace_<pid>_<ns>.pt.trace.json`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities, profile_memory=with_memory)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


def annotate(name: str):
    """A named range visible in profiler timelines."""
    return torch.profiler.record_function(name)


class Throughput:
    """items/s meter with EMA smoothing."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.rate: Optional[float] = None
        self._last = time.perf_counter()

    def update(self, items: int) -> float:
        now = time.perf_counter()
        dt = max(now - self._last, 1e-9)
        self._last = now
        inst = items / dt
        self.rate = inst if self.rate is None else self.ema * self.rate + (1 - self.ema) * inst
        return self.rate
