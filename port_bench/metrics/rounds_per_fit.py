"""rounds_per_fit: secure rounds a fit, the program's own count
(``FitResult.iterations``), averaged over the window's fits."""
from pbench import readers


def read(ctx):
    return readers.mean_rounds(ctx)
