"""Gradient compression: int8 quantized all-reduce with error feedback.

The JAX package's ``optim/compression.py``: each pod quantizes its local
gradient to int8 with a per-leaf absmax scale, sums the int8 payload over
the pod axis (in int32) and dequantizes, carrying the quantization
residual into the next step.  4x less cross-pod traffic than float32 on
a fabric that moves the int8 codes; compression applies to the plain
mode only (compressing shares would break the field homomorphism).  The
LM training driver builds the error-feedback tree (``--compress``).
"""
from __future__ import annotations

import torch

from ..core.flatbuf import tree_flatten, tree_unflatten
from ..distributed import compat

__all__ = ["compressed_psum", "init_error_feedback"]


def init_error_feedback(params):
    """Zero float32 residuals shaped like ``params``."""
    leaves, treedef = tree_flatten(params)
    return tree_unflatten(treedef, [
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for p in leaves])


def _quantize(g):
    """(int8 q, float32 scale, residual g - q * scale) of one leaf, with
    scale = (max|g| + 1e-12) / 127."""
    absmax = torch.max(torch.abs(g)) + 1e-12
    scale = absmax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale, g - q.to(torch.float32) * scale


def compressed_psum(grads, axis_name: str, error_fb):
    """Quantized all-reduce over ``axis_name`` with error feedback: call on
    every rank under a mesh with that axis.

    Returns (mean_grads, new_error_fb).  Each leaf's scale is the maximum
    over the pods (one float32 each) so the int8 sum stays linear; the
    codes are summed as int32.  Bit-identical to the JAX package on the
    same inputs: the same float32 operations in the same order.
    """
    n = compat.axis_size(axis_name)

    def one(g, e):
        g32 = g.to(torch.float32) + e
        _, scale, _ = _quantize(g32)
        # common scale across pods keeps the sum linear
        scale = compat.pmax(scale.reshape(1), axis_name).reshape(())
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        resid = g32 - q.to(torch.float32) * scale
        total = compat.psum(q.to(torch.int32), axis_name, donate=True)
        mean = total.to(torch.float32) * scale / n
        return mean.to(g.dtype), resid

    flat_g, treedef = tree_flatten(grads)
    flat_e = tree_flatten(error_fb)[0]
    outs = [one(g, e) for g, e in zip(flat_g, flat_e)]
    return (tree_unflatten(treedef, [o[0] for o in outs]),
            tree_unflatten(treedef, [o[1] for o in outs]))
