"""solve_ms: device ms a round in the float64 Newton solve's kernels
(cuSOLVER's LU and triangular solves, by kernel name)."""
from pbench import readers


def read(ctx):
    return readers.device_ms_per_round(ctx,
                                       readers.category_us(ctx, "solve"))
