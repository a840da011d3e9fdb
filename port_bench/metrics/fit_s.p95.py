"""fit_s.p95: the 95th percentile of every fit's seconds in the window
(host clock from the call to its result)."""
import statistics


def read(ctx):
    times = [j["seconds"] for j in ctx.jobs]
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=100, method="inclusive")[94]
