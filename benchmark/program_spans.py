"""Device time per plan under the program's own spans, from the traced
run's record of the host and the device.

The port opens its spans through `annotate` (its utils/profiling.py): one
around each plan, which the cell's family names (`Cell.plan_span`, such as
`dd.plan` or `diffuser.plan`, handed on as `ctx.plan_span`), and in every
sampler step `sampler.denoise` (the network's forward under CFG),
`sampler.guide` (the classifier's input gradient, where it guides) and
`sampler.update` (the solver's update). A stage's value is the device time
of the kernels launched while its spans were open
(`Trace.device_time_under`) over the number of plan spans in the window.
A program that opens no plan span, or whose stage launched no kernel
there, has nothing to read: None. Imports nothing of the program.
"""

from __future__ import annotations

import bisect

from benchmark import tracing

GUIDE_SPAN = "sampler.guide"
# the autograd engine's event around each backward node it runs
BACKWARD = "autograd::engine::evaluate_function"


def host_spans(trace, names):
    """(start, end) of every host span named in `names` that opened in the
    window, sorted (a span's device-side copy left out)."""
    return sorted((e.time_range.start, e.time_range.end) for e in trace.events
                  if e.name in names and not tracing._is_device(e)
                  and trace.start <= e.time_range.start < trace.end)


def ms_per_plan(trace, plan_span: str, is_root):
    """Device milliseconds under the host events for which `is_root` holds,
    over the window's spans named `plan_span`."""
    plans = len(host_spans(trace, (plan_span,)))
    if not plans:
        return None
    seconds = trace.device_time_under(is_root)
    return seconds * 1e3 / plans if seconds > 0 else None


def span_ms_per_plan(trace, plan_span: str, name: str):
    """Device milliseconds per plan under the spans named `name`."""
    return ms_per_plan(trace, plan_span, lambda e: e.name == name)


def guide_ms_per_plan(trace, plan_span: str):
    """Device milliseconds per plan under `sampler.guide`, and under every
    autograd engine event that starts while one is open: on a CUDA device
    the backward's kernels are launched from the engine's own thread, whose
    events have no host parent under the span."""
    spans = host_spans(trace, (GUIDE_SPAN,))
    starts = [s for s, _ in spans]

    def in_guide(t):
        j = bisect.bisect_right(starts, t) - 1
        return j >= 0 and t < spans[j][1]

    return ms_per_plan(trace, plan_span, lambda e: e.name == GUIDE_SPAN or (
        e.name.startswith(BACKWARD) and in_guide(e.time_range.start)))
