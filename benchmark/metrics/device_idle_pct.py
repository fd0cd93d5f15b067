"""device_idle_pct: the share of the traced window in which no operation ran
on the device (the union of the profiler's device intervals)."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
