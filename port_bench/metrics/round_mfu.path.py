"""round_mfu.path: the least time of every path round's operations at
the peaks of their precisions (K5, K1, K2 and the solves of the λ chunks
and the refit; ``pbench/work.py``) over the window's seconds, in %."""
from pbench import readers


def read(ctx):
    if not ctx.on_card or not ctx.jobs:
        return None
    sweep = sum(j["sweep_rounds"] for j in ctx.jobs)
    refit = sum(j["refit_rounds"] for j in ctx.jobs)
    least = (sweep * readers.ops_s(readers.sweep_round(ctx))
             + refit * readers.ops_s(readers.refit_round(ctx)))
    return 100.0 * least / ctx.window_s
