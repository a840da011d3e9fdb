"""K1: fused fixed-point encode + Shamir share evaluation (flat wire).

The port of the JAX package's ``kernels/shamir_poly.py::
shamir_encode_share_pallas``.  The CUDA kernel lives in
``csrc/shamir_poly.cu``; :func:`encode_share_plain` beside it is the same
function in plain PyTorch — the CPU path and the kernel's oracle.

The TPU kernel's ``mulmod31``, ``addmod`` and ``_fold`` split 31-bit
products into 16-bit limbs because the TPU vector unit has no 64-bit
integer multiply; Hopper has one, so they have no counterpart here.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["encode_share_kernel", "encode_share_plain"]


def _max_signed(moduli) -> int:
    m = 1
    for p in moduli:
        m *= p
    return (m - 1) // 2


def _check_args(x, coeffs, moduli, points):
    if x.dim() != 2 or x.shape[1] != 128:
        raise ValueError(f"payload must be (rows, 128), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"payload must be float32/float64, got {x.dtype}")
    if coeffs.dim() != 4 or coeffs.shape[0] != len(moduli) or \
            tuple(coeffs.shape[2:]) != tuple(x.shape):
        raise ValueError(
            f"coeffs must be (R={len(moduli)}, t-1, rows, 128), got "
            f"{tuple(coeffs.shape)}"
        )
    if coeffs.dtype != torch.int32:
        raise TypeError(f"coeffs must be int32, got {coeffs.dtype}")
    if not points or any(j < 1 for j in points):
        raise ValueError(f"points must be >= 1, got {points}")
    if coeffs.device != x.device:
        raise ValueError("payload and coeffs must be on one device")


def encode_share_plain(x: torch.Tensor, coeffs: torch.Tensor,
                       moduli: tuple[int, ...], frac_bits: int,
                       points: tuple[int, ...]) -> torch.Tensor:
    """Plain PyTorch K1: (len(points), R, rows, 128) int32 shares.

    s = round(x * 2**frac_bits) in x's dtype (half to even), clipped to
    +-float(max_signed) in x's dtype, lifted to residues with Python-sign
    ``%``, then a Horner evaluation at each point.
    """
    _check_args(x, coeffs, moduli, points)
    lim = float(_max_signed(moduli))
    s = torch.clamp(torch.round(x * float(1 << frac_bits)), -lim, lim)
    s = s.to(torch.float64).to(torch.int64)
    c = coeffs.to(torch.int64)
    t_minus_1 = c.shape[1]
    out = []
    for j in points:
        per_residue = []
        for r, p in enumerate(moduli):
            acc = torch.zeros_like(s)
            for k in range(t_minus_1 - 1, -1, -1):
                acc = (acc * j + c[r, k]) % p
            per_residue.append((acc * j + torch.remainder(s, p)) % p)
        out.append(torch.stack(per_residue))
    return torch.stack(out).to(torch.int32)


def encode_share_kernel(x: torch.Tensor, coeffs: torch.Tensor,
                        moduli: tuple[int, ...], frac_bits: int,
                        points: tuple[int, ...]) -> torch.Tensor:
    """K1 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Returns (len(points), R, rows, 128)
    int32 shares, holder axis leading."""
    if x.device.type == "cpu":
        return encode_share_plain(x, coeffs, moduli, frac_bits, points)
    if x.device.type != "cuda":
        raise ValueError(f"no K1 for device {x.device}")
    _check_args(x, coeffs, moduli, points)
    x = x.contiguous()
    coeffs = coeffs.contiguous()
    rows = x.shape[0]
    R, t_minus_1 = coeffs.shape[0], coeffs.shape[1]
    out = torch.empty((len(points), R, rows, 128), dtype=torch.int32,
                      device=x.device)
    mods = (ctypes.c_longlong * R)(*moduli)
    pts = (ctypes.c_int * len(points))(*points)
    err = _build.library().repro_k1_encode_share(
        x.data_ptr(), int(x.dtype == torch.float64), coeffs.data_ptr(),
        out.data_ptr(), rows * 128, R, t_minus_1, mods, pts, len(points),
        float(_max_signed(moduli)), float(1 << frac_bits),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "K1 encode_share")
    encode_share_kernel.launches += 1
    return out


encode_share_kernel.launches = 0
