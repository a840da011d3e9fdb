"""K2: Lagrange reconstruction + CRT/Garner decode of aggregated shares.

The port of the JAX package's ``kernels/shamir_reconstruct.py::
shamir_reconstruct_pallas`` (``garner=True``) together with the uint64
epilogue of its ``ops.shamir_reveal_flat``: the CUDA kernel in
``csrc/shamir_reconstruct.cu`` emits the (rows, 128) float64 aggregate
directly.  :func:`reconstruct_plain` is the same function in plain
PyTorch — the CPU path and the kernel's oracle.

With ``frac_bits=None`` both return the reconstructed residues
(R, rows, 128) int32 instead of decoding them.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["lagrange_weights_host", "reconstruct_kernel",
           "reconstruct_plain"]


def lagrange_weights_host(
    points, moduli
) -> tuple[tuple[int, ...], ...]:
    """L_i(0) per residue as nested Python-int tuples.

    ``points`` are the public 1-based share evaluation points; weights are
    computed with big-int modular inverses host-side (leaks nothing).
    """
    if len(set(points)) != len(points):
        raise ValueError(
            f"reconstruction points must be distinct, got {tuple(points)}"
        )
    out = []
    for p in moduli:
        row = []
        for i, xi in enumerate(points):
            num, den = 1, 1
            for j, xj in enumerate(points):
                if i == j:
                    continue
                num = (num * xj) % p
                den = (den * ((xj - xi) % p)) % p
            row.append((num * pow(den, p - 2, p)) % p)
        out.append(tuple(row))
    return tuple(out)


def _check_args(shares, points, moduli, frac_bits):
    if shares.dim() != 4 or shares.shape[3] != 128:
        raise ValueError(
            f"shares must be (k, R, rows, 128), got {tuple(shares.shape)}"
        )
    if shares.dtype != torch.int32:
        raise TypeError(f"shares must be int32, got {shares.dtype}")
    if shares.shape[0] != len(points) or shares.shape[1] != len(moduli):
        raise ValueError(
            f"shares {tuple(shares.shape)} do not match {len(points)} "
            f"points x {len(moduli)} residues"
        )
    if frac_bits is not None:
        if len(moduli) > 2:
            raise ValueError("decode supports 1- or 2-residue fields")
        if len(moduli) == 2 and not moduli[0] > moduli[1]:
            raise ValueError("garner decode assumes moduli sorted descending")


def reconstruct_plain(shares: torch.Tensor, points: tuple[int, ...],
                      moduli: tuple[int, ...],
                      frac_bits: int | None) -> torch.Tensor:
    """Plain PyTorch K2: (rows, 128) float64, or (R, rows, 128) int32
    residues when ``frac_bits`` is None."""
    _check_args(shares, points, moduli, frac_bits)
    lams = lagrange_weights_host(tuple(points), tuple(moduli))
    sh = shares.to(torch.int64)
    rec = []
    for r, p in enumerate(moduli):
        acc = torch.zeros_like(sh[0, r])
        for i, lam in enumerate(lams[r]):
            acc = (acc + lam * sh[i, r]) % p
        rec.append(acc)
    if frac_bits is None:
        return torch.stack(rec).to(torch.int32)
    if len(moduli) == 2:
        p1, p2 = moduli
        k = ((rec[1] - rec[0] % p2) % p2) * pow(p1 % p2, p2 - 2, p2) % p2
        x = rec[0] + p1 * k
        m = p1 * p2
    else:
        x, m = rec[0], moduli[0]
    signed = torch.where(x <= (m - 1) // 2, x, x - m)
    return signed.to(torch.float64) / float(1 << frac_bits)


def reconstruct_kernel(shares: torch.Tensor, points: tuple[int, ...],
                       moduli: tuple[int, ...],
                       frac_bits: int | None) -> torch.Tensor:
    """K2 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if shares.device.type == "cpu":
        return reconstruct_plain(shares, points, moduli, frac_bits)
    if shares.device.type != "cuda":
        raise ValueError(f"no K2 for device {shares.device}")
    _check_args(shares, points, moduli, frac_bits)
    shares = shares.contiguous()
    k, R, rows = shares.shape[0], shares.shape[1], shares.shape[2]
    if frac_bits is None:
        out = torch.empty((R, rows, 128), dtype=torch.int32,
                          device=shares.device)
    else:
        out = torch.empty((rows, 128), dtype=torch.float64,
                          device=shares.device)
    lams = lagrange_weights_host(tuple(points), tuple(moduli))
    flat_lams = (ctypes.c_longlong * (R * k))(*[w for row in lams for w in row])
    mods = (ctypes.c_longlong * R)(*moduli)
    err = _build.library().repro_k2_reconstruct(
        shares.data_ptr(), out.data_ptr(), rows * 128, k, R, flat_lams, mods,
        int(frac_bits is not None),
        float(1 << (frac_bits or 0)),
        torch.cuda.current_stream(shares.device).cuda_stream,
    )
    _build.check(err, "K2 reconstruct")
    reconstruct_kernel.launches += 1
    return out


reconstruct_kernel.launches = 0
