"""Host-side constants of the Shamir kernels' field arithmetic.

K1, K2 and K4 (``csrc/field_arith.cuh``) reduce modulo each residue's
prime by Barrett's method, with no integer division on the card: they take
``mu = floor(2**64 / p)`` beside ``p``, computed here once a modulus and
passed in the kernels' parameter structs.  ``tests/test_torch_field_reduce.py``
replays the kernels' reduction with these same constants.

K1's evaluation points and K2's Lagrange weights have no fixed count, so
they reach the card as small device tables (:func:`device_table`),
uploaded once per set of values and device.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["MAX_MODULUS", "barrett_constants", "device_table",
           "garner_inverse"]

# every modulus the kernels take lies in (1, 2**31): a residue and a
# Lagrange weight fit 31 bits, so a product of two fits 62
MAX_MODULUS = 2**31


@functools.lru_cache(maxsize=None)
def barrett_constants(moduli: tuple[int, ...]) -> tuple[int, ...]:
    """(mu_0, p_0, mu_1, p_1, ...): each modulus after its Barrett
    constant ``mu = floor(2**64 / p)``, the layout the kernels read."""
    out = []
    for p in moduli:
        p = int(p)
        if not 1 < p < MAX_MODULUS:
            raise ValueError(
                f"the field kernels take moduli in (1, 2**31), got {p}")
        out += [(1 << 64) // p, p]
    return tuple(out)


@functools.lru_cache(maxsize=None)
def garner_inverse(p1: int, p2: int) -> int:
    """p1^-1 mod p2 (p2 prime), Garner's constant for the CRT pair."""
    return pow(p1 % p2, p2 - 2, p2)


@functools.lru_cache(maxsize=64)
def device_table(values: tuple[int, ...], dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """``values`` as a 1-D tensor on ``device``, uploaded once: every
    later launch with the same values reads the same table.  The table is
    never written, so sharing it between launches and streams is safe."""
    return torch.tensor(values, dtype=dtype, device=device)
