"""Shamir t-of-w secret sharing, vectorized over tensors and trees.

The paper's protection mechanism (Eq. 7): each secret ``m`` is the
constant term of a random degree-(t-1) polynomial
``q(x) = m + a_1 x + ... + a_{t-1} x^{t-1}`` over a prime field; share
``j`` is ``(j, q(j))`` for j = 1..w.  Reconstruction is Lagrange
interpolation at 0 from any t shares.  One independent polynomial per
tensor element, evaluated with Horner's rule.

Share tensors have shape ``(w, R, *secret_shape)``: the leading axis is
the holder (Computation Center) axis.

Backends
--------
``backend="reference"`` (default) runs the int64 ``%`` arithmetic in
plain PyTorch — the correctness oracle.  ``backend="kernel"`` is the
port's name for the JAX package's ``"pallas"``: the leaf-wise share runs
through K4 (``kernels/shamir_poly.py::share_kernel``, every residue in
one launch) and reconstruction through K2's residues mode, one launch per
residue (``ops.shamir_reconstruct``).  It also marks an aggregator whose
flat wire runs through the fused encode+share and reveal kernels
(``SecureCollective``).  Given the same coefficients the two backends
give bit-identical shares and reconstructions.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..kernels import ops
from ..kernels.shamir_poly import share_kernel
from ..kernels.shamir_reconstruct import lagrange_weights_host
from .field import FIELD_WIDE, FieldSpec, fadd, fmul, random_elements
from .flatbuf import tree_flatten, tree_unflatten

__all__ = ["ShamirScheme", "lagrange_coeffs_at_zero", "BACKENDS"]

BACKENDS = ("reference", "kernel")


def lagrange_coeffs_at_zero(points: Sequence[int], field: FieldSpec,
                            device=None) -> torch.Tensor:
    """Public Lagrange weights L_i(0) per residue: (R, len(points)) int64.

    Computed host-side with Python ints — the points are public (they
    identify Computation Centers), so this leaks nothing.
    """
    return torch.tensor(lagrange_weights_host(tuple(points), field.moduli),
                        dtype=torch.int64, device=device)


@dataclasses.dataclass(frozen=True)
class ShamirScheme:
    """t-of-w threshold scheme over ``field`` with a backend switch."""

    threshold: int = 2  # t: min cooperating centers to reconstruct
    num_shares: int = 3  # w: total Computation Centers
    field: FieldSpec = FIELD_WIDE
    backend: str = "reference"  # "reference" | "kernel"

    def __post_init__(self):
        if not (1 <= self.threshold <= self.num_shares):
            raise ValueError("need 1 <= t <= w")
        if self.num_shares >= min(self.field.moduli):
            raise ValueError("w must be < field modulus")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}")

    # -- sharing ------------------------------------------------------------
    def share(self, generator: torch.Generator,
              secret: torch.Tensor) -> torch.Tensor:
        """Split field elements (R, ...) into shares (w, R, ...).

        Coefficients are fresh uniform field elements per tensor element
        (information-theoretic hiding below threshold t); evaluation is
        delegated to ``share_with_coeffs``.
        """
        coeffs = random_elements(
            generator, (self.threshold - 1,) + tuple(secret.shape[1:]),
            self.field, device=secret.device,
        )  # (R, t-1, ...)
        return self.share_with_coeffs(secret, coeffs)

    def share_with_coeffs(self, secret: torch.Tensor,
                          coeffs: torch.Tensor) -> torch.Tensor:
        """Deterministic share evaluation given coefficients (R, t-1, ...).

        Both backends give bit-identical output for the same inputs.
        """
        t, w, field = self.threshold, self.num_shares, self.field
        if tuple(coeffs.shape[:2]) != (field.num_residues, t - 1):
            raise ValueError(
                f"coeffs must be (R, t-1, ...), got {tuple(coeffs.shape)}"
            )
        if t == 1:  # q(x) = m: every share is the secret itself
            return secret.expand((w,) + tuple(secret.shape)).clone()
        if self.backend == "kernel":
            num_r = field.num_residues
            out = share_kernel(secret.reshape(num_r, -1),
                               coeffs.reshape(num_r, t - 1, -1),
                               field.moduli, w)  # (w, R, n): one launch
            return out.reshape((w,) + tuple(secret.shape))
        coeffs = coeffs.transpose(0, 1)  # (t-1, R, ...)

        def eval_at(x: int) -> torch.Tensor:
            # q(x) = (..(a_{t-1} x + a_{t-2}) x + ..) x + m, per residue
            acc = torch.zeros_like(secret)
            for k in range(t - 2, -1, -1):
                acc = fadd(fmul(acc, x, field), coeffs[k], field)
            return fadd(fmul(acc, x, field), secret, field)

        return torch.stack([eval_at(j) for j in range(1, w + 1)])

    # -- reconstruction -----------------------------------------------------
    def reconstruct(self, shares: torch.Tensor,
                    points: Sequence[int] | None = None) -> torch.Tensor:
        """Recover secret (R, ...) from >= t shares (k, R, ...).

        ``points`` are the 1-based holder ids of the provided share slices
        (default: 1..k).  Any t-subset suffices.
        """
        k = shares.shape[0]
        if points is None:
            points = list(range(1, k + 1))
        if len(points) != k:
            raise ValueError("points must match share count")
        if k < self.threshold:
            raise ValueError(
                f"need >= t={self.threshold} shares, got {k} "
                "(information-theoretically irrecoverable below threshold)"
            )
        if self.backend == "kernel":
            return torch.stack([
                ops.shamir_reconstruct(shares[:, r].reshape(k, -1),
                                       tuple(points), p)
                .reshape(shares.shape[2:])
                for r, p in enumerate(self.field.moduli)
            ])  # (R, ...): one K2 launch per residue
        lam = lagrange_coeffs_at_zero(points, self.field, shares.device)
        acc = torch.zeros_like(shares[0])
        for i in range(k):
            li = lam[:, i].reshape(
                (self.field.num_residues,) + (1,) * (shares.dim() - 2)
            )
            acc = fadd(acc, fmul(shares[i], li, self.field), self.field)
        return acc

    # -- tree convenience ---------------------------------------------------
    def share_pytree(self, generator: torch.Generator, tree):
        leaves, treedef = tree_flatten(tree)
        return tree_unflatten(treedef,
                              [self.share(generator, l) for l in leaves])

    def reconstruct_pytree(self, tree, points: Sequence[int] | None = None):
        leaves, treedef = tree_flatten(tree)
        return tree_unflatten(treedef,
                              [self.reconstruct(l, points) for l in leaves])
