"""path_s: the measured window's seconds over the whole paths (CV sweep,
1-SE pick and refit) it completed."""


def read(ctx):
    return ctx.window_s / len(ctx.jobs) if ctx.jobs else None
