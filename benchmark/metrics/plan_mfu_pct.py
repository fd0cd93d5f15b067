"""plan_mfu_pct: the plans' model operations (the algorithm's, counted once)
finished in the traced window over the window's seconds, as a share of the
chip's peak for the configuration's precision."""


def read(ctx):
    if ctx.peaks is None:
        return None
    peak = ctx.peaks[ctx.config["peak"]]
    return 100.0 * ctx.work["plan_ops"] * ctx.plans / (ctx.trace.window_s * peak)
