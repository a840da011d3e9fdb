"""Fixed-point encoding of real summaries into the secret-sharing field.

    encode(x) = round(x * 2**frac_bits)  lifted to residues mod p_r
    decode(v) = centered_signed(v) / 2**frac_bits

The aggregation (sums over institutions, share-wise homomorphic ops) is
exact in the field as long as the aggregate magnitude stays below
``capacity()``.  Quantization happens once, at encode time.  Rounding is
round-half-to-even (``torch.round``), as ``jnp.round`` does in the JAX
package, so both encode the same floats to the same integers.

Values past capacity saturate (clip to +-max_signed) rather than wrap.
Saturation is still silently wrong, so ``check_headroom`` and
``encode(..., check=True)`` raise ``OverflowError`` on the spot — the
port runs eagerly, so the check is an ordinary host comparison.

The kernel backend fuses this codec into the encode+share and reveal
kernels (``kernels/shamir_poly.py``, ``kernels/shamir_reconstruct.py``);
this module remains the leaf-wise oracle those kernels are tested against.
"""
from __future__ import annotations

import dataclasses

import torch

from .field import FIELD_WIDE, FieldSpec, crt_combine_signed, lift_signed

__all__ = ["FixedPointCodec"]


def _raise_overflow(max_abs: float, bound: float, capacity: float,
                    what: str) -> None:
    if max_abs > bound:
        raise OverflowError(
            f"fixed-point overflow in {what}: max |value| {max_abs:g} "
            f"exceeds the codec capacity {capacity:g} — the aggregate would "
            "saturate and reveal a plausible-but-wrong float (see "
            "SecureCollective.headroom_ok for the aggregate bound)"
        )


@dataclasses.dataclass(frozen=True)
class FixedPointCodec:
    field: FieldSpec = FIELD_WIDE
    # 28 frac bits: quantization 3.7e-9 while leaving ~8.6e9 of integer
    # headroom for Hessian-scale aggregates
    frac_bits: int = 28

    @property
    def scale(self) -> int:
        return 1 << self.frac_bits

    def capacity(self) -> float:
        """Largest |real value| exactly representable (incl. aggregates)."""
        return self.field.max_signed / self.scale

    def check_headroom(self, x: torch.Tensor, num_addends: int = 1,
                       what: str = "protect") -> None:
        """Raise ``OverflowError`` when ``num_addends * max|x|`` exceeds
        ``capacity()`` — the predicate ``headroom_ok`` tests, as a hard
        failure so saturation can never masquerade as a valid reveal."""
        cap = self.capacity()
        max_abs = float(x.to(torch.float64).abs().max())
        _raise_overflow(max_abs, cap / max(1, num_addends), cap, what)

    def encode(self, x: torch.Tensor, check: bool = False) -> torch.Tensor:
        """float tensor (...) -> field residues (R, ...) int64.

        ``check=True`` raises instead of silently saturating when a scaled
        magnitude exceeds ``field.max_signed``.
        """
        scaled = torch.round(x.to(torch.float64) * self.scale)
        lim = float(self.field.max_signed)
        if check:
            _raise_overflow(float(scaled.abs().max()), lim,
                            self.capacity(), "encode")
        scaled = torch.clamp(scaled, -lim, lim)
        return lift_signed(scaled.to(torch.int64), self.field)

    def decode(self, v: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
        """field residues (R, ...) -> float tensor (...)."""
        signed = crt_combine_signed(v, self.field)
        return (signed.to(torch.float64) / self.scale).to(dtype)
