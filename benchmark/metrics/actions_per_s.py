"""actions_per_s: every action the window's plans returned over the window's
seconds (host clock, closed loop; the window ends with the first plan that
finishes past `--seconds`)."""

from benchmark import stats


def read(ctx):
    return stats.rate(ctx.actions, ctx.window_s)
