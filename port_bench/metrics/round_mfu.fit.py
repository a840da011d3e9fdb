"""round_mfu.fit: the least time of every fit round's operations at the
peaks of their precisions (K3, K1, K2 and the solve; ``pbench/work.py``)
over the window's seconds, in %."""
from pbench import readers


def read(ctx):
    if not ctx.on_card or not ctx.jobs:
        return None
    rounds = sum(j["rounds"] for j in ctx.jobs)
    least = rounds * readers.ops_s(readers.fit_round(ctx.config))
    return 100.0 * least / ctx.window_s
