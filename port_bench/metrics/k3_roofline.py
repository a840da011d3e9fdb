"""k3_roofline: K3's least time at the cell's shapes (``pbench/work.py``,
X read once in float64) over its device time, per launch, in %."""
from pbench import readers


def read(ctx):
    us = readers.category_us(ctx, "K3")
    launches = ctx.trace and ctx.trace["k3_launches"]
    if not ctx.on_card or not us or not launches:
        return None
    least = readers.fit_round(ctx.config)[0].least_s()
    return 100.0 * launches * least / (us * 1e-6)
