"""denoise_ms_per_plan: device milliseconds per plan of the kernels
launched under the program's `sampler.denoise` spans (the network's
forward under CFG, its doubled batch and their combination), from the
traced run's record of the host and the device. Nothing to read where the
program opens no such span."""

from benchmark import program_spans


def read(ctx):
    return program_spans.span_ms_per_plan(ctx.host_trace, ctx.plan_span, "sampler.denoise")
