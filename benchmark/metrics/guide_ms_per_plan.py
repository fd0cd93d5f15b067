"""guide_ms_per_plan: device milliseconds per plan of the classifier's
guidance, from the traced run's record of the host and the device: the
kernels launched under the program's `sampler.guide` spans (the forward
under grad) and under the autograd engine's events that start inside one
(the backward). Nothing to read where no plan guides."""

from benchmark import program_spans


def read(ctx):
    return program_spans.guide_ms_per_plan(ctx.host_trace, ctx.plan_span)
