"""collective_ms: device ms a round inside the program's secure-round
span (K1, the int64 field sums, K2 and the packing around them); nothing
where no op under such a span launched device work."""
from pbench import readers


def read(ctx):
    if ctx.trace is None:
        return None
    return readers.device_ms_per_round(ctx, ctx.trace["collective_us"])
