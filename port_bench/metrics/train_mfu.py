"""train_mfu: the model FLOPs of the window's steps (the entry's
``step_flops``: 6 x the parameters a token multiplies by x the tokens,
and attention's causal pairs, recomputation not counted) at the bf16
peak, over the window's seconds, in %."""
from pbench import peaks


def read(ctx):
    if not ctx.on_card or not ctx.jobs:
        return None
    flops = len(ctx.jobs) * ctx.entry.step_flops(ctx.config, ctx.traffic)
    return 100.0 * flops / peaks.BF16 / ctx.window_s
