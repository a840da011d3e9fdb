"""setup_s: seconds from the process's start to the measured window:
imports, CUDA's start, the kernels' build or load, the data drawn on the
card, the warm-up job."""


def read(ctx):
    return ctx.setup_s
