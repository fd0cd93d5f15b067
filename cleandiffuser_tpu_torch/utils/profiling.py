"""Profiling hooks (counterpart of cleandiffuser_tpu/utils/profiling.py).

- `trace(log_dir, with_memory=True)`: a context manager that profiles the
  enclosed region with `torch.profiler` (the CPU, and CUDA activity when
  a CUDA device is present) and writes a Chrome trace, which TensorBoard's
  profiler plugin also reads, into `log_dir`; `with_memory` records
  tensor allocations too. It yields the profiler, whose `key_averages()`
  read the region's operator times.
- `annotate(name)`: the port's one way to open a named span. While a
  profiler records, a `torch.profiler.record_function` range, visible in
  the trace and in the profiler's events beside the kernels launched
  under it; otherwise one shared no-op context, so a span on the main
  path costs a flag read when nothing records.

The pipelines open spans around a plan's stages: `dd.plan` and
`diffuser.plan` around the plan function in `act`; `sampler.denoise`,
`sampler.guide` and `sampler.update` in each step of the VP-SDE sampler
(diffusion/diffusionsde.py); the Veteran and DiffuserLite stages. The
benchmark's per-layer metrics read the first five (`benchmark/metrics/`).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "annotate"]

# reentrant and stateless: every span opened while nothing records shares it
_NO_SPAN = contextlib.nullcontext()


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
    """A named span in the profiler's record while one records; else a
    shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN
