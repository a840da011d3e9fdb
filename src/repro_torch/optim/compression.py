"""Gradient compression: int8 quantization with error feedback.

The JAX package's ``optim/compression.py``: each pod quantizes its local
gradient to int8 with a per-leaf absmax scale and carries the residual
into the next step.  Its ``compressed_psum`` is a collective over a mesh
axis and comes with the multi-device wires (ROADMAP slice D); the LM
training driver only builds the error-feedback tree (``--compress``).
"""
from __future__ import annotations

import torch

from ..core.flatbuf import tree_flatten, tree_unflatten

__all__ = ["init_error_feedback"]


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
