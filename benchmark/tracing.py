"""The traced run's reduction: from `torch.profiler`'s events to the device's
busy time, its idle gaps and what the host did in them, kernel times by
name, and device time under a span.

The busy time is the union of the device's operation intervals (the
arithmetic of `chip_smoke.py` and `tools/profile_{dd,diffuser}_plan.py`,
taken over intervals instead of summed, so that overlapping operations
count once). Device-side copies of the benchmark's spans and of other user
annotations are left out: they cover kernels counted on their own. The
window is the `bench.window` span the harness opens around the measured
loop, or, for a record of the device alone, the host's clock around it.
Nothing is written to disk.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

WINDOW_SPAN = "bench.window"
TOP = 10  # entries of each breakdown list


def _is_device(evt) -> bool:
    from torch.autograd import DeviceType

    return evt.device_type == DeviceType.CUDA


def _is_annotation(evt) -> bool:
    return bool(getattr(evt, "is_user_annotation", False)) or evt.name.startswith("bench.")


def _merge(intervals):
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


class Trace:
    """One traced window. Times in microseconds from the profiler's start.
    A trace of the host and the device finds its window in the
    `bench.window` span; a trace of the device alone takes the whole
    record, and the window's length from the host's clock (`window_s`)."""

    def __init__(self, events, window_s=None):
        self.events = list(events)
        windows = [e for e in self.events if e.name == WINDOW_SPAN and not _is_device(e)]
        if window_s is not None:
            self.start, self.end, self.thread = -float("inf"), float("inf"), None
            self._window_s = window_s
        elif len(windows) == 1:
            win = windows[0]
            self.start, self.end = win.time_range.start, win.time_range.end
            self.thread = win.thread
            self._window_s = (self.end - self.start) / 1e6
        else:
            raise RuntimeError(f"the trace holds {len(windows)} {WINDOW_SPAN} spans, not 1")
        # every device operation in the window: (name, start, end)
        self.ops = [(e.name, e.time_range.start, e.time_range.end) for e in self.events
                    if _is_device(e) and not _is_annotation(e)
                    and e.time_range.end > self.start and e.time_range.start < self.end]
        self.busy_intervals = _merge((max(s, self.start), min(t, self.end))
                                     for _, s, t in self.ops)

    @property
    def window_s(self) -> float:
        return self._window_s

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals) / 1e6

    def kernels(self):
        """The device operations that are kernels (not copies or fills)."""
        return [op for op in self.ops if not op[0].startswith(("Memcpy", "Memset"))]

    def kernel_time_s(self, match: str):
        """(launches, device seconds) of the kernels whose name contains `match`."""
        hits = [t - s for name, s, t in self.ops if match in name]
        return len(hits), sum(hits) / 1e6

    def device_ops(self):
        """The device operations that took the most time, summed by name."""
        by_name = defaultdict(float)
        for name, s, t in self.ops:
            by_name[name[:160]] += (t - s) / 1e6
        return sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:TOP]

    def gaps(self):
        """The window's idle intervals (start, end): no device operation ran."""
        edges = [self.start] + [x for iv in self.busy_intervals for x in iv] + [self.end]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def host_segments(self):
        """The loop thread's timeline cut into segments, each labelled by the
        innermost host operation or span open over it: (start, end, label),
        sorted and disjoint; time outside every operation has no segment."""
        host = sorted(((e.time_range.start, e.time_range.end, e.name) for e in self.events
                       if not _is_device(e) and e.thread == self.thread
                       and e.name != WINDOW_SPAN), key=lambda h: (h[0], -h[1]))
        segs, stack, cursor = [], [], None

        def close_until(t):
            nonlocal cursor
            while stack and stack[-1][0] <= t:
                end, name = stack.pop()
                if cursor < end:
                    segs.append((cursor, end, name))
                    cursor = end

        for start, end, name in host:
            close_until(start)
            if stack and cursor < start:
                segs.append((cursor, start, stack[-1][1]))
            cursor = start
            # an event that outlives the one it opened in is cut at its end
            stack.append((min(end, stack[-1][0]) if stack else end, name))
        close_until(float("inf"))
        return segs

    def idle_gaps(self):
        """Idle seconds summed by what the host's loop thread was doing at
        each gap's midpoint: the innermost host operation or span open then."""
        segs = self.host_segments()
        starts = [seg[0] for seg in segs]
        by_label = defaultdict(float)
        for s, t in self.gaps():
            mid = (s + t) / 2
            j = bisect.bisect_right(starts, mid) - 1
            label = segs[j][2] if j >= 0 and segs[j][1] >= mid else "python between operations"
            by_label[label[:160]] += (t - s) / 1e6
        return sorted(([k, v] for k, v in by_label.items()), key=lambda kv: -kv[1])[:TOP]

    def device_time_under(self, is_root) -> float:
        """Device seconds of the kernels that the host events for which
        `is_root(event)` holds launched, with their children's; a root
        under another root counts once, and a span's device-side copy is
        left out."""
        def under_root(evt):
            p = evt.cpu_parent
            while p is not None:
                if is_root(p):
                    return True
                p = p.cpu_parent
            return False

        def own(evt):
            kernels = sum(k.duration for k in evt.kernels if k.name != evt.name)
            return kernels + sum(own(ch) for ch in evt.cpu_children)

        roots = [e for e in self.events if not _is_device(e) and is_root(e)
                 and not under_root(e) and self.start <= e.time_range.start < self.end]
        return sum(own(e) for e in roots) / 1e6


