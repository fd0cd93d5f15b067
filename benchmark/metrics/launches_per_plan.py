"""launches_per_plan: kernels the device ran in the traced window (copies
and fills left out) over the plans finished in it."""


def read(ctx):
    return len(ctx.trace.kernels()) / ctx.plans
