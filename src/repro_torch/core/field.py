"""Prime-field arithmetic for Shamir secret-sharing, on int64 tensors.

The field is the JAX package's: ``FIELD31`` is the Mersenne prime
p = 2**31 - 1 and ``FIELD_WIDE`` the CRT pair (2**31 - 1, 2**31 - 19),
whose product M = p1 * p2 < 2**62 gives ~61.9 bits of exact dynamic range
for fixed-point aggregates.

Element tensors carry a leading residue axis ``R`` (R = 1 or 2):
shape ``(R, *secret_shape)``.  Elements are **int64**, not uint64:
PyTorch has no uint64 add on the CPU, and nothing needs it — a reduced
residue is < 2**31 and a product of two is < 2**62.  The one place that
needs Python's sign convention for ``%`` (``lift_signed``) uses
``torch.remainder``, never ``torch.fmod``.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "FieldSpec",
    "FIELD31",
    "FIELD_WIDE",
    "fadd",
    "fsub",
    "fmul",
    "fneg",
    "fsum",
    "fpow_host",
    "finv_host",
    "random_elements",
    "random_elements_fast",
    "crt_combine_signed",
    "lift_signed",
]

P31 = 2**31 - 1
P31B = 2**31 - 19


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """A prime field (or CRT product of prime fields) for secret sharing."""

    name: str
    moduli: tuple[int, ...]  # python ints, each < 2**31

    @property
    def num_residues(self) -> int:
        return len(self.moduli)

    @property
    def modulus_product(self) -> int:
        m = 1
        for p in self.moduli:
            m *= p
        return m

    @property
    def max_signed(self) -> int:
        """Largest magnitude representable as a centered (signed) value."""
        return (self.modulus_product - 1) // 2

    def moduli_array(self, device) -> torch.Tensor:
        """(R,) moduli as int64 on ``device`` (caller reshapes): int64,
        the port's element type, where the JAX package's are uint64."""
        return torch.tensor(self.moduli, dtype=torch.int64, device=device)

    def bcast(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """int64 moduli shaped to broadcast against ``x``'s residue axis."""
        shape = [1] * x.dim()
        shape[axis] = self.num_residues
        return self.moduli_array(x.device).reshape(shape)


FIELD31 = FieldSpec("field31", (P31,))
FIELD_WIDE = FieldSpec("field_wide", (P31, P31B))


def _check(x: torch.Tensor, field: FieldSpec, axis: int = 0) -> None:
    if x.dtype != torch.int64:
        raise TypeError(f"field elements must be int64, got {x.dtype}")
    if x.shape[axis] != field.num_residues:
        raise ValueError(
            f"residue axis {axis} has size {x.shape[axis]} != field residues "
            f"{field.num_residues}"
        )


def fadd(a: torch.Tensor, b: torch.Tensor, field: FieldSpec,
         residue_axis: int = 0) -> torch.Tensor:
    """(a + b) mod p, per residue.  Inputs reduced; sum < 2**32."""
    _check(a, field, residue_axis)
    return (a + b) % field.bcast(a, residue_axis)


def fsub(a: torch.Tensor, b: torch.Tensor, field: FieldSpec,
         residue_axis: int = 0) -> torch.Tensor:
    """(a - b) mod p, per residue, as a + (p - b).  Inputs reduced."""
    _check(a, field, residue_axis)
    p = field.bcast(a, residue_axis)
    return (a + (p - b)) % p


def fneg(a: torch.Tensor, field: FieldSpec,
         residue_axis: int = 0) -> torch.Tensor:
    """-a mod p, per residue (0 stays 0).  Input reduced."""
    _check(a, field, residue_axis)
    p = field.bcast(a, residue_axis)
    return (p - a) % p


def fmul(a: torch.Tensor, b: torch.Tensor, field: FieldSpec,
         residue_axis: int = 0) -> torch.Tensor:
    """(a * b) mod p.  Reduced inputs < 2**31, so products fit in int64."""
    _check(a, field, residue_axis)
    return (a * b) % field.bcast(a, residue_axis)


def fsum(stacked: torch.Tensor, field: FieldSpec, axis: int = 0,
         residue_axis: int = 1) -> torch.Tensor:
    """Reduce a stacked batch of field tensors mod p in ONE pass.

    ``stacked`` is (S, ..., R, ...) with ``residue_axis`` counted after
    the reduction axis is removed.  The sum runs exact in int64 — exact
    while S * max(p) < 2**63, the bound
    ``collective.check_aggregation_headroom`` enforces — and reduces mod p
    once.  Accepts int32 share tensors (the flat wire format) and returns
    the input dtype.
    """
    s = stacked.sum(dim=axis, dtype=torch.int64)
    _check(s, field, residue_axis)
    return (s % field.bcast(s, residue_axis)).to(stacked.dtype)


def fpow_host(base: int, exp: int, p: int) -> int:
    return pow(int(base), int(exp), int(p))


def finv_host(x: int, p: int) -> int:
    """Modular inverse via Fermat; host-side (public Lagrange points only)."""
    if x % p == 0:
        raise ZeroDivisionError("no inverse of 0")
    return pow(int(x) % p, p - 2, p)


def random_elements(
    generator: torch.Generator, shape: tuple[int, ...], field: FieldSpec,
    device=None, dtype: torch.dtype = torch.int64,
) -> torch.Tensor:
    """Uniform random field elements, shape (R, *shape), int64 or ``dtype``
    (int32 holds them too: every p_r < 2**31).

    Drawn independently per residue in [0, p_r) (exact uniform, the values
    ``torch.randint`` gives) straight into its slice of one buffer, on the
    generator's device.
    """
    dev = generator.device if device is None else device
    out = torch.empty((field.num_residues, *shape), dtype=dtype, device=dev)
    for r, p in enumerate(field.moduli):
        out[r].random_(0, p, generator=generator)
    return out


def random_elements_fast(
    generator: torch.Generator, shape: tuple[int, ...], field: FieldSpec,
    device=None, dtype: torch.dtype = torch.int64,
) -> torch.Tensor:
    """Near-uniform random field elements, shape (R, *shape), int64 or
    ``dtype``: one 64-bit draw per element reduced mod p_r.

    The modulo bias is below p / 2**64 < 2**-33, negligible for sharing
    coefficients, and one draw an element is what the JAX package's
    ``random_elements_fast`` takes; the values depend only on the
    generator (torch's stream, not threefry's).  Torch has no uint64
    arithmetic on the CPU, so each word is drawn as an int64 w over the
    full 64-bit range and reduced as the unsigned word u = w + 2**64 [w <
    0] would be: u mod p = (w mod p + 2**64 mod p) mod p for negative w,
    with Python's sign convention for ``remainder`` and no overflow.
    """
    dev = generator.device if device is None else device
    out = torch.empty((field.num_residues, *shape), dtype=dtype, device=dev)
    words = torch.empty(shape, dtype=torch.int64, device=dev)
    for r, p in enumerate(field.moduli):
        words.random_(-2**63, None, generator=generator)
        red = torch.remainder(words, p)
        out[r] = torch.where(words < 0, (red + (2**64 % p)) % p, red)
    return out


def crt_combine_signed(residues: torch.Tensor,
                       field: FieldSpec) -> torch.Tensor:
    """Combine (R, ...) residues into centered signed int64 values.

    For R = 1: center around 0 (values > p/2 map negative).
    For R = 2: Garner's formula — x = r1 + p1 * ((r2 - r1) * inv(p1) mod p2),
    every intermediate < 2**62, then center around M/2.
    """
    _check(residues, field)
    if field.num_residues == 1:
        p = field.moduli[0]
        v = residues[0]
        return torch.where(v <= field.max_signed, v, v - p)
    if field.num_residues != 2:
        raise NotImplementedError("only 1- or 2-residue fields supported")
    p1, p2 = field.moduli
    inv_p1 = finv_host(p1, p2)  # public constant
    r1, r2 = residues[0], residues[1]
    diff = (r2 - r1 % p2) % p2  # (r2 - r1) mod p2, python-sign %
    k = (diff * inv_p1) % p2  # < p2 < 2**31
    x = r1 + p1 * k  # < p1*p2 < 2**62
    m = field.modulus_product
    return torch.where(x <= field.max_signed, x, x - m)


def lift_signed(values: torch.Tensor, field: FieldSpec) -> torch.Tensor:
    """Map signed int64 values (|v| <= max_signed) to (R, ...) residues."""
    # torch.remainder follows Python's sign convention: already in [0, p)
    return torch.stack([torch.remainder(values, p) for p in field.moduli])
