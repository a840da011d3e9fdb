"""Shared primitive layers: RMSNorm, rotary embedding, MLPs.

The JAX package's ``models/layers.py`` op for op, with its dtype rules
written out: norms and rotary tables in float32, results cast back to the
input's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "rotary", "apply_rope", "swiglu", "gelu_mlp",
           "pad_steps"]


def rms_norm(x, scale, eps: float = 1e-6):
    """x * rsqrt(mean(x^2) + eps) * (1 + scale), in float32.  The scale is
    zero-initialised, so a fresh norm is the identity gain."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps))
            * (1.0 + scale.to(torch.float32))).to(dt)


def rotary(positions, dim: int, theta: float, dtype=torch.float32):
    """(..., P) int positions -> cos/sin tables (..., P, dim//2)."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=positions.device) / dim))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, cos, sin):
    """x: (B, S, H, D); cos/sin: (B, S, D//2) or (S, D//2).

    The products promote x to the tables' float32 (as JAX promotes bf16 x
    f32), and the result is cast back to x's dtype.
    """
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    if cos.dim() == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    dt = torch.promote_types(x.dtype, cos.dtype)
    x1, x2 = x1.to(dt), x2.to(dt)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def swiglu(x, w1, w3, w2):
    """LLaMA-style gated MLP: (x@w1 * silu(x@w3)) @ w2 — the SiLU is on the
    w3 branch."""
    return ((x @ w1) * F.silu(x @ w3)) @ w2


def gelu_mlp(x, w1, w2):
    """GELU MLP with JAX's default tanh approximation."""
    return F.gelu(x @ w1, approximate="tanh") @ w2


def pad_steps(out, trip: int):
    """The (B, steps, ...) outputs of a loop a dry run probed
    (``obs/cost.loop_steps``) stretched along axis 1 to ``trip`` by its
    last step, on ``meta`` (shapes only); ``out`` itself when every step
    ran."""
    steps = out.shape[1]
    if steps == trip:
        return out
    return torch.cat([out, out[:, -1:].expand(-1, trip - steps,
                                              *out.shape[2:])], dim=1)
