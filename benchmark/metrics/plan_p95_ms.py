"""plan_p95_ms: the 95th percentile of every plan's latency in the window,
from the request's inputs to the synchronise after its `act` (host clock)."""

from benchmark import stats


def read(ctx):
    return stats.percentile([s * 1e3 for s in ctx.latencies_s], 95)
