"""k5_roofline: K5's least time at the cell's shapes (``pbench/work.py``:
the λ chunks' 5-configuration launches and the refit's one) over its
device time, in %."""
from pbench import readers


def read(ctx):
    us = readers.category_us(ctx, "K5")
    if not ctx.on_card or not us or not ctx.trace["k5_launches"]:
        return None
    jobs = ctx.trace["jobs"]
    sweep = sum(j["sweep_rounds"] for j in jobs)
    refit = sum(j["refit_rounds"] for j in jobs)
    if sweep + refit != ctx.trace["k5_launches"]:
        return None
    least = (sweep * readers.sweep_round(ctx)[0].least_s()
             + refit * readers.refit_round(ctx)[0].least_s())
    return 100.0 * least / (us * 1e-6)
