"""K1 and K4: Shamir share evaluation by Horner's rule.

* K1 (:func:`encode_share_kernel`) — fused fixed-point encode + shares of
  the flat wire, the port of the JAX package's ``kernels/shamir_poly.py::
  shamir_encode_share_pallas`` (CUDA in ``csrc/shamir_poly.cu``);
* K4 (:func:`share_kernel`) — shares of already-encoded field elements
  for the leaf-wise ``ShamirScheme(backend="kernel")``, the port of
  ``shamir_poly_pallas`` (CUDA in ``csrc/shamir_share.cu``), every residue
  in one launch.

Each has its plain PyTorch version beside it (``*_plain``) — the CPU path
and the kernel's oracle — and gives ``meta`` tensors its outputs' shapes
(``flash_attention``'s docstring says how the wrappers route devices).

The TPU kernel's ``mulmod31``, ``addmod`` and ``_fold`` split 31-bit
products into 16-bit limbs because the TPU vector unit has no 64-bit
integer multiply; Hopper has one, so they have no counterpart here.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, field_consts, ref, work as _work
from ..obs import cost as _cost
from ..obs import gate as _gate

__all__ = ["encode_share_kernel", "encode_share_plain", "share_kernel",
           "share_plain"]

# K1's struct path takes up to 16 points (csrc/shamir_poly.cu); K4's
# residue limit (csrc/shamir_share.cu): a field has at most 8
K1_STRUCT_POINTS, K4_MAX_R = 16, 8


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


def _k1_work(x, coeffs, moduli, frac_bits, points):
    return _work.k1_encode_share(x.numel(), x.element_size(), len(moduli),
                                 coeffs.shape[1], len(points))


@_cost.kernel("K1", _k1_work)
@_gate.kernel
def encode_share_kernel(x: torch.Tensor, coeffs: torch.Tensor,
                        moduli: tuple[int, ...], frac_bits: int,
                        points: tuple[int, ...]) -> torch.Tensor:
    """K1 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Returns (len(points), R, rows, 128)
    int32 shares, holder axis leading.  The kernel takes moduli in (1,
    2**31) (``field_consts.barrett_constants``)."""
    if _build.plain(x, "K1"):
        return encode_share_plain(x, coeffs, moduli, frac_bits, points)
    _check_args(x, coeffs, moduli, points)
    consts = field_consts.barrett_constants(tuple(moduli))
    barrett = (ctypes.c_ulonglong * len(consts))(*consts)
    x = x.contiguous()
    coeffs = coeffs.contiguous()
    rows = x.shape[0]
    R, t_minus_1 = coeffs.shape[0], coeffs.shape[1]
    out = torch.empty((len(points), R, rows, 128), dtype=torch.int32,
                      device=x.device)
    if max(points) >= field_consts.MAX_MODULUS:
        raise ValueError(f"K1 takes points below 2**31, got {max(points)}")
    if x.device.type == "meta":
        return out
    # up to K1_STRUCT_POINTS points ride in the launch's parameters; more
    # go as a device table, int32 (each < 2**31) read as uint32
    pts = (ctypes.c_int * len(points))(*points)
    table = field_consts.device_table(tuple(points), torch.int32, x.device) \
        if len(points) > K1_STRUCT_POINTS else None
    err = _build.library().repro_k1_encode_share(
        x.data_ptr(), int(x.dtype == torch.float64), coeffs.data_ptr(),
        out.data_ptr(), rows * 128, R, t_minus_1, barrett, pts,
        table.data_ptr() if table is not None else None, len(points),
        float(_max_signed(moduli)), float(1 << frac_bits),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "K1 encode_share")
    encode_share_kernel.launches += 1
    return out


encode_share_kernel.launches = 0


# -- K4: leaf-wise shares of encoded field elements ---------------------------

def _check_share_args(secret, coeffs, moduli, num_shares):
    if secret.dim() != 2 or secret.shape[0] != len(moduli):
        raise ValueError(f"secret must be (R={len(moduli)}, n), got "
                         f"{tuple(secret.shape)}")
    if coeffs.dim() != 3 or coeffs.shape[0] != secret.shape[0] or \
            coeffs.shape[2] != secret.shape[1]:
        raise ValueError(f"coeffs must be (R, t-1, n={secret.shape[1]}), "
                         f"got {tuple(coeffs.shape)}")
    if secret.dtype != torch.int64 or coeffs.dtype != torch.int64:
        raise TypeError("secret and coeffs must be int64 field elements")
    if coeffs.device != secret.device:
        raise ValueError("secret and coeffs must be on one device")
    if any(not (num_shares < p < 2**31) for p in moduli):
        raise ValueError(f"moduli must lie in (w, 2**31), got {moduli}")
    if num_shares < 1 or len(moduli) > K4_MAX_R:
        raise ValueError(f"K4 takes w >= 1 and R <= {K4_MAX_R}; got "
                         f"w={num_shares}, R={len(moduli)}")


def share_plain(secret: torch.Tensor, coeffs: torch.Tensor,
                moduli: tuple[int, ...], num_shares: int) -> torch.Tensor:
    """Plain PyTorch K4: (w, R, n) int64 shares.

    ``secret`` (R, n) and ``coeffs`` (R, t-1, n) hold reduced int64 field
    elements; share j is q(j) = secret + sum_k coeffs[k] j^(k+1) mod p_r,
    by Horner's rule per residue (``ref.shamir_shares``).
    """
    _check_share_args(secret, coeffs, moduli, num_shares)
    return torch.stack([ref.shamir_shares(secret[r], coeffs[r], num_shares, p)
                        for r, p in enumerate(moduli)], dim=1)


def _k4_work(secret, coeffs, moduli, num_shares):
    R, t_minus_1, n = coeffs.shape
    return _work.k4_share(n, R, t_minus_1, num_shares)


@_cost.kernel("K4", _k4_work)
@_gate.kernel
def share_kernel(secret: torch.Tensor, coeffs: torch.Tensor,
                 moduli: tuple[int, ...], num_shares: int) -> torch.Tensor:
    """K4 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Returns (w, R, n) int64 shares,
    holder axis leading, every residue from one launch.  The kernel
    reduces by Barrett's method (``field_consts.barrett_constants``)."""
    if _build.plain(secret, "K4"):
        return share_plain(secret, coeffs, moduli, num_shares)
    _check_share_args(secret, coeffs, moduli, num_shares)
    secret = secret.contiguous()
    coeffs = coeffs.contiguous()
    consts = field_consts.barrett_constants(tuple(moduli))
    barrett = (ctypes.c_ulonglong * len(consts))(*consts)
    R, t_minus_1, n = coeffs.shape
    out = torch.empty((num_shares, R, n), dtype=torch.int64,
                      device=secret.device)
    if secret.device.type == "meta":
        return out
    err = _build.library().repro_k4_share(
        secret.data_ptr(), coeffs.data_ptr(), out.data_ptr(), n, R,
        t_minus_1, barrett, num_shares,
        torch.cuda.current_stream(secret.device).cuda_stream,
    )
    _build.check(err, "K4 share")
    share_kernel.launches += 1
    return out


share_kernel.launches = 0
