"""attention_roofline: the least time of the traced steps' K7, K8a and
K8b launches at the cell's shapes (the entry's ``attention_work``, from
``pbench/work.py``) over their device time, in %."""

KERNELS = {"K7": "K7 flash_attention", "K8a": "K8a flash_dq",
           "K8b": "K8b flash_dkdv"}


def read(ctx):
    if not ctx.on_card or ctx.trace is None:
        return None
    us = sum(ctx.trace["by_category_us"].get(c, 0.0)
             for c in KERNELS.values())
    launches = {k: ctx.trace.get(k, 0) for k in KERNELS}
    if not us or not all(launches.values()):
        return None
    per_launch = ctx.entry.attention_work(ctx.config, ctx.traffic)
    least = sum(n * per_launch[k].least_s() for k, n in launches.items())
    return 100.0 * least / (us * 1e-6)
