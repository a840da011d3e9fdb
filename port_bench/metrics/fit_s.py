"""fit_s: the measured window's seconds over the fits it completed."""


def read(ctx):
    return ctx.window_s / len(ctx.jobs) if ctx.jobs else None
