"""small_ops_ms: device ms a traced training step outside the flash
kernels and cuBLAS's products: AdamW's passes, the norms, rotary, SwiGLU's
gate, the loss's softmax, casts, copies and memsets."""
from pbench import categories

BIG = ("K7 flash_attention", "K8a flash_dq", "K8b flash_dkdv",
       "matmul (cuBLAS)")


def read(ctx):
    if not ctx.on_card or ctx.trace is None or not ctx.trace["jobs"]:
        return None
    known = {c for c, _ in categories.TRAIN_CATEGORIES} | {categories.OTHER}
    by_cat = ctx.trace["by_category_us"]
    if not set(by_cat) <= known:
        return None  # not a training step's categories
    us = sum(v for c, v in by_cat.items() if c not in BIG)
    return us / 1e3 / len(ctx.trace["jobs"]) if us else None
