"""setup_s: from the process's start to the window's: importing torch and
the program, the CUDA context, the seeded weights, the pipeline, loading
(and in a fresh checkout building) the kernels, and the warm-up plans of
the cell's own shapes (host clock)."""


def read(ctx):
    return ctx.setup_s
