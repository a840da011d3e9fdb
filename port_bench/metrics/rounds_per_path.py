"""rounds_per_path: secure rounds a path, the program's own count
(``PathReport.rounds_total``, the refit's included), averaged over the
window's paths."""
from pbench import readers


def read(ctx):
    return readers.mean_rounds(ctx)
