"""idle_share: the share of the traced window in which no operation ran
on the card, in %."""
from pbench import readers


def read(ctx):
    return readers.idle_share(ctx)
