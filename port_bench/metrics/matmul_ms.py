"""matmul_ms: device ms a traced training step in cuBLAS's matrix
products (the linear layers and the head, forward and backward)."""


def read(ctx):
    if not ctx.on_card or ctx.trace is None or not ctx.trace["jobs"]:
        return None
    us = ctx.trace["by_category_us"].get("matmul (cuBLAS)")
    return us / 1e3 / len(ctx.trace["jobs"]) if us else None
