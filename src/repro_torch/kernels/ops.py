"""Public wrappers around the port's kernels (shapes and layouts).

These are what the rest of the port calls; each has the output layout of
its counterpart in the JAX package's ``kernels/ops.py``.  Each routes
through a kernel wrapper that launches the CUDA kernel for CUDA tensors
and runs the kernel's plain PyTorch version for CPU tensors.  Unlike the
TPU kernels, none needs its inputs padded to a block multiple.
"""
from __future__ import annotations

import torch

from .fused_irls import (
    fused_irls_cv_kernel,
    fused_irls_kernel,
    gram_hessian_kernel,
)
from .shamir_poly import encode_share_kernel, share_kernel
from .shamir_reconstruct import reconstruct_kernel

__all__ = ["fused_irls", "fused_irls_cv", "gram_hessian",
           "shamir_protect_flat", "shamir_reconstruct",
           "shamir_reveal_flat", "shamir_shares"]


def gram_hessian(X, w):
    """X^T diag(w) X for caller-given row weights: (d, d) float32 (K6).

    X (N, d) and w (N,) of any float dtype are cast to float32; the sum is
    accumulated in float32.  The secure fit derives w from beta inside K3
    instead; this op serves models that reweight rows themselves (offset
    or exposure models).
    """
    return gram_hessian_kernel(X, w)


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


def fused_irls_cv(betas, X, y, fold_ids, fold_of, counts=None,
                  mxu_operand=None):
    """Cross-validated batched IRLS summaries over a (config, institution)
    grid: (H (C,S,d,d) f32, g (C,S,d), dev_train (C,S), dev_val (C,S),
    correct_val (C,S), count_val (C,S)), all but H float64.

    ``betas`` (C, d) holds one iterate per (lambda x fold) configuration,
    ``fold_ids`` (S, N_max) each row's fold and ``fold_of`` (C,) each
    configuration's held-out fold (-1: none, a full-data fit sharing the
    launch).  ``counts=None`` means all N_max rows of every institution;
    rows past ``counts`` are masked whatever their fold id.
    """
    s_dim, n, _ = X.shape
    if counts is None:
        counts = torch.full((s_dim,), n, dtype=torch.int32, device=X.device)
    Xm = X.to(torch.float32) if mxu_operand is None else mxu_operand
    return fused_irls_cv_kernel(
        betas.to(torch.float64), X, Xm, y.to(torch.float64),
        counts.to(torch.int32), fold_ids.to(torch.int32),
        fold_of.to(torch.int32))


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


def shamir_shares(secret, coeffs, num_shares: int, modulus: int
                  ) -> torch.Tensor:
    """(num_shares, n) int64 shares of ``secret`` (n,) under the
    polynomial ``coeffs`` (t-1, n), both reduced mod ``modulus`` (K4).

    The per-residue form of the JAX package's ``ops.shamir_shares``;
    ``ShamirScheme(backend="kernel")`` calls K4 once for all residues.
    """
    if modulus >= 2**31:
        raise ValueError("kernel field elements must fit 31 bits")
    return share_kernel(secret[None], coeffs[None], (modulus,),
                        num_shares)[:, 0]


def shamir_reconstruct(secret_shares, points, modulus: int) -> torch.Tensor:
    """(n,) int64 secret from the (k, n) reduced shares held at the public
    1-based ``points``: K2 in its residues mode, one residue.

    Residues travel to K2 as int32 (exact: each is <= 2**31 - 2) in
    (rows, 128) tiles, the tail padded with zeros and cut off again.
    """
    if modulus >= 2**31:
        raise ValueError("kernel field elements must fit 31 bits")
    k, n = secret_shares.shape
    rows = max(1, -(-n // 128))
    tiles = torch.nn.functional.pad(secret_shares.to(torch.int32),
                                    (0, rows * 128 - n))
    rec = reconstruct_kernel(tiles.reshape(k, 1, rows, 128), tuple(points),
                             (modulus,), None)
    return rec.reshape(rows * 128)[:n].to(torch.int64)
