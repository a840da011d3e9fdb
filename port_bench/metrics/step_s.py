"""step_s: the measured window's seconds over the training steps it
completed (host clock, each step ended by a synchronize)."""


def read(ctx):
    return ctx.window_s / len(ctx.jobs) if ctx.jobs else None
