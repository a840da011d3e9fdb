"""Public wrappers around the port's kernels (shapes and layouts).

These are what the rest of the port calls; each has the output layout of
its counterpart in the JAX package's ``kernels/ops.py``.  Each routes
through a kernel wrapper that launches the CUDA kernel for CUDA tensors
and runs the kernel's plain PyTorch version for CPU tensors.  Unlike the
TPU kernels, none needs its inputs padded to a block multiple.
"""
from __future__ import annotations

import torch

from .fused_irls import fused_irls_kernel
from .shamir_poly import encode_share_kernel
from .shamir_reconstruct import reconstruct_kernel

__all__ = ["fused_irls", "shamir_protect_flat", "shamir_reveal_flat"]


def fused_irls(beta, X, y, counts=None, mxu_operand=None):
    """Batched masked IRLS summaries: (H (S,d,d) f32, g (S,d), dev (S,)).

    X: (S, N_max, d) float64; y: (S, N_max); counts: (S,) true (ragged)
    row counts, default N_max everywhere.  ``mxu_operand`` is the float32
    copy of X fed to the Gram — pass it from a hot loop to cast once per
    fit instead of once per call.
    """
    s_dim, n, _ = X.shape
    if counts is None:
        counts = torch.full((s_dim,), n, dtype=torch.int32, device=X.device)
    Xm = X.to(torch.float32) if mxu_operand is None else mxu_operand
    return fused_irls_kernel(beta.to(torch.float64), X, Xm,
                             y.to(torch.float64), counts.to(torch.int32))


def shamir_protect_flat(buf, coeffs, num_shares: int, moduli, frac_bits: int,
                        points=None) -> torch.Tensor:
    """Fused fixed-point encode + share of a flat buffer in ONE launch.

    ``buf`` (rows, 128) float, ``coeffs`` (R, t-1, rows, 128) int32.
    Returns (len(points), R, rows, 128) int32 — the holder axis leads so
    a Computation Center's slice is ``out[j]``.  ``points`` defaults to
    the full 1..num_shares fan-out.
    """
    if points is None:
        points = tuple(range(1, num_shares + 1))
    if any(not (1 <= j <= num_shares) for j in points):
        raise ValueError(f"points must be in 1..{num_shares}, got {points}")
    return encode_share_kernel(buf, coeffs, tuple(moduli), frac_bits,
                               tuple(points))


def shamir_reveal_flat(shares, points, moduli, frac_bits: int
                       ) -> torch.Tensor:
    """Fused Lagrange reconstruction + CRT decode -> (rows, 128) float64.

    ``shares`` is (k, R, rows, 128) int32: the aggregated slices of the
    centers at the public 1-based ``points``.
    """
    if len(points) != shares.shape[0]:
        raise ValueError("points must match the share count")
    return reconstruct_kernel(shares, tuple(points), tuple(moduli), frac_bits)
