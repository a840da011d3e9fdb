"""The one secure collective: pack -> protect -> aggregate -> reveal -> unpack.

Institutions protect local summaries, Computation Centers aggregate
share-wise (Algorithm 2), and only the threshold-met *aggregate* is ever
reconstructed.  :class:`SecureCollective` owns that chain once.  This is
the main-path part of the JAX package's ``core/collective.py``: the
multi-config round, the in-SPMD wires (``psum``, ``psum_2d``,
``allreduce``) and the sharded aggregate belong to later slices.

Backends and the flat wire
--------------------------
``backend="reference"`` walks the summary tree leaf by leaf through the
int64 field oracle; it is the exactness oracle the flat wire is measured
against.

``backend="kernel"`` (the JAX package's ``"pallas"``) runs the fused
pipeline: the float tree is packed into ONE (rows, 128) buffer
(``flatbuf.pack_pytree``), so each phase is a single kernel launch:

* protect   — fused fixed-point encode + Horner shares (kernel K1);
* aggregate — an exact int64 sum over the institutions, one trailing mod;
* reveal    — fused Lagrange reconstruction + CRT decode (kernel K2),
  then unpack back to the original tree.

Shares travel as int32: every residue is <= 2**31 - 2, so a share costs
4 bytes on the wire, as the JAX package's uint32 shares do, and
``round_bytes`` is the same model.

The named boundaries ``_protect_flat``, ``_reveal_flat`` and
``declassify_sum`` are the only places that encode, reveal or sum in the
clear; each records to the privacy ledger (:mod:`repro_torch.obs.ledger`)
before it runs.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..kernels import ops
from ..obs import ledger as _ledger
from ..obs.trace import traced as _traced
from .field import FieldSpec, fsum, random_elements
from .fixed_point import FixedPointCodec
from .flatbuf import (
    LANES,
    ROW_ALIGN,
    FlatLayout,
    _rows_for,
    pack_pytree,
    pack_pytree_batched,
    tree_flatten,
    tree_unflatten,
    unpack_pytree,
)
from .shamir import ShamirScheme

__all__ = [
    "check_aggregation_headroom",
    "declassify_sum",
    "FlatProtected",
    "SecureCollective",
]

# int64 accumulator: S reduced residues (< max p) sum exactly below 2**63
ACCUMULATOR_LIMIT = 2**63


def check_aggregation_headroom(num_addends: int, field: FieldSpec) -> None:
    """Guard the exact int64 share sum: ``S * max(p_r) < 2**63``.

    Every aggregation path accumulates reduced share elements (< p_r) in
    int64 and applies ONE trailing mod, which is exact iff the unreduced
    sum cannot overflow.  The JAX package accumulates in uint64 and allows
    S * max(p) < 2**64; the port's signed accumulator halves that to
    ~2**32 institutions for the 31-bit moduli.
    """
    if num_addends * max(field.moduli) >= ACCUMULATOR_LIMIT:
        raise ValueError(
            f"cannot aggregate {num_addends} share tensors exactly: "
            f"{num_addends} * max modulus {max(field.moduli)} >= 2**63 "
            "would overflow the int64 accumulator before the trailing mod"
        )


def _tree_map(fn, tree):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(l) for l in leaves])


# ------------------------------------------------------------------------
# The named declassification boundaries: each host wrapper records to the
# runtime privacy ledger, then runs.
# ------------------------------------------------------------------------


def declassify_sum(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """The sanctioned PLAINTEXT aggregation over the institution axis.

    The paper's pragmatic protect modes ("gradient" / "hessian" / "none")
    exchange some summaries in the clear; the protocol contract is that
    only their cross-institution sums ever leave the round, and every
    driver spells those sums through this function so they stay visible
    and counted.
    """
    _ledger.record_site("declassify_sum", what=f"axis{axis}_sum",
                        shape=x.shape)
    return torch.sum(x, dim=axis)


@dataclasses.dataclass(frozen=True)
class FlatProtected:
    """Protected flat-buffer representation: one int32 share tensor.

    ``buf`` is (w, R, rows, 128) fresh from ``protect`` (holder axis
    leading), (w, R, S, rows, 128) from ``protect_batched``, or
    (k, R, rows, 128) once >= t centers stack their aggregate slices for
    reveal.  ``layout`` remembers how to unpack the revealed buffer.
    """

    buf: torch.Tensor
    layout: FlatLayout


def _protect_flat(generator: torch.Generator, buf: torch.Tensor,
                  scheme: ShamirScheme, frac_bits: int, rows: int,
                  points: tuple[int, ...] | None = None) -> torch.Tensor:
    """Encode + share one (rows, 128) buffer: (len(points) or w, R, rows,
    128) int32, with fresh sharing polynomials from ``generator``."""
    _ledger.record_site("_protect_flat", what="encode+share",
                        shape=buf.shape, threshold=scheme.threshold)
    field = scheme.field
    coeffs = random_elements(
        generator, (scheme.threshold - 1, rows, LANES), field,
        device=buf.device,
    ).to(torch.int32)  # (R, t-1, rows, 128)
    return ops.shamir_protect_flat(buf, coeffs, scheme.num_shares,
                                   field.moduli, frac_bits, points=points)


def _reveal_flat(buf: torch.Tensor, scheme: ShamirScheme, frac_bits: int,
                 points: tuple[int, ...]) -> torch.Tensor:
    """Lagrange + CRT reveal of (k, R, rows, 128) aggregated shares to a
    (rows, 128) float64 buffer."""
    _ledger.record_site("_reveal_flat", what="lagrange_reveal",
                        shape=buf.shape, threshold=scheme.threshold)
    return ops.shamir_reveal_flat(buf, points, scheme.field.moduli,
                                  frac_bits)


def _fold_sum_streaming(submissions, field: FieldSpec,
                        residue_axis: int) -> torch.Tensor:
    """Share-wise sum of S tensors with a running int64 accumulator and
    one trailing mod (exact under ``check_aggregation_headroom``)."""
    acc = submissions[0].to(torch.int64)
    for nxt in submissions[1:]:
        acc = acc + nxt
    return (acc % field.bcast(acc, residue_axis)).to(submissions[0].dtype)


@dataclasses.dataclass(frozen=True)
class SecureCollective:
    """The one protect -> aggregate -> reveal pipeline for float trees.

    ``backend=None`` inherits the scheme's backend; passing "kernel" or
    "reference" overrides the scheme to match.

    ``overflow_check=True`` arms the fixed-point overflow check on every
    protect path: a value past the capacity bound raises
    ``OverflowError`` instead of saturating into a plausible-but-wrong
    reveal.  ``protect_batched`` tightens the bound to ``capacity / S`` so
    an aggregate that would overflow is caught at protect time.
    """

    scheme: ShamirScheme = ShamirScheme()
    codec: FixedPointCodec = FixedPointCodec()
    backend: str | None = None
    overflow_check: bool = False

    def __post_init__(self):
        if self.backend is None:
            object.__setattr__(self, "backend", self.scheme.backend)
        elif self.backend != self.scheme.backend:
            object.__setattr__(
                self, "scheme",
                dataclasses.replace(self.scheme, backend=self.backend),
            )
        if self.scheme.field.moduli != self.codec.field.moduli:
            raise ValueError("scheme and codec must agree on the field")

    # institution side --------------------------------------------------------
    @_traced("protect")
    def protect(self, generator: torch.Generator, tree):
        """Encode floats to the field and split into shares.

        Reference backend: per-leaf share tree of (w, R, ...) int64.
        Kernel backend: a single ``FlatProtected`` share buffer.
        """
        if self.backend == "kernel":
            buf, layout = pack_pytree(tree)
            if self.overflow_check:
                self.codec.check_headroom(buf, what="protect")
            shares = _protect_flat(generator, buf, self.scheme,
                                   self.codec.frac_bits, layout.rows)
            return FlatProtected(shares, layout)
        encoded = _tree_map(
            lambda x: self.codec.encode(x, check=self.overflow_check), tree
        )
        return self.scheme.share_pytree(generator, encoded)

    @_traced("protect")
    def protect_batched(self, generator: torch.Generator, tree):
        """Protect S institutions' summaries in ONE kernel launch.

        ``tree`` leaves carry a leading S (institution) axis; the S flat
        slices are packed side by side and pushed through a single
        encode+share launch.  Returns a ``FlatProtected`` whose buffer is
        (w, R, S, rows, 128); the layout describes one slice.
        """
        if self.backend != "kernel":
            raise ValueError("protect_batched requires the kernel backend")
        buf, layout = pack_pytree_batched(tree)
        if self.overflow_check:
            self.codec.check_headroom(buf, num_addends=buf.shape[0],
                                      what="protect_batched")
        s_dim, rows = buf.shape[0], layout.rows
        shares = _protect_flat(
            generator, buf.reshape(s_dim * rows, LANES), self.scheme,
            self.codec.frac_bits, s_dim * rows,
        )  # (w, R, S*rows, 128)
        w, num_r = shares.shape[0], shares.shape[1]
        return FlatProtected(shares.reshape(w, num_r, s_dim, rows, LANES),
                             layout)

    # computation-center side -------------------------------------------------
    @_traced("aggregate")
    def aggregate(self, protected: Sequence):
        """Share-wise sum over institutions (still protected)."""
        if not protected:
            raise ValueError("nothing to aggregate")
        if len(protected) == 1:
            return protected[0]
        field = self.scheme.field
        check_aggregation_headroom(len(protected), field)
        # (w, R, ...) protect outputs: residue axis 1
        if isinstance(protected[0], FlatProtected):
            return FlatProtected(
                _fold_sum_streaming([p.buf for p in protected], field, 1),
                protected[0].layout,
            )
        flat = [tree_flatten(p)[0] for p in protected]
        treedef = tree_flatten(protected[0])[1]
        return tree_unflatten(treedef, [
            _fold_sum_streaming([f[i] for f in flat], field, 1)
            for i in range(len(flat[0]))
        ])

    @_traced("aggregate")
    def aggregate_batched(self, protected: FlatProtected) -> FlatProtected:
        """Reduce the institution axis of a ``protect_batched`` output:
        one exact int64 reduction over axis 2 of the (w, R, S, rows, 128)
        buffer — Algorithm 2 for all S submissions at once."""
        check_aggregation_headroom(protected.buf.shape[2], self.scheme.field)
        buf = fsum(protected.buf, self.scheme.field, axis=2, residue_axis=1)
        return FlatProtected(buf, protected.layout)

    def _validated_points(self, points) -> tuple[int, ...]:
        """Normalize + sanity-check reveal points (1-based, distinct).

        ``None`` defaults to the first t points; below-threshold subsets
        are rejected here, before any reduction over a short share axis.
        """
        w = self.scheme.num_shares
        if points is None:
            points = tuple(range(1, self.scheme.threshold + 1))
        points = tuple(int(p) for p in points)
        if any(not (1 <= p <= w) for p in points):
            raise ValueError(f"points must be in 1..{w}, got {points}")
        if len(set(points)) != len(points):
            raise ValueError(f"points must be distinct, got {points}")
        if len(points) < self.scheme.threshold:
            raise ValueError(
                f"need >= t={self.scheme.threshold} shares, got "
                f"{len(points)} (information-theoretically irrecoverable "
                "below threshold)"
            )
        return points

    @_traced("secure_round")
    def secure_round_batched(self, generator: torch.Generator, tree,
                             points: Sequence[int] | None = None,
                             dtype=torch.float64):
        """One whole Algorithm-1+2 round over S-leading summaries.

        protect_batched (ONE encode+share launch) -> aggregate_batched
        (one exact int64 reduction over the institutions) -> reveal of the
        *global* aggregate from the ``points`` centers' slices (default:
        the first t).
        """
        points = self._validated_points(points)
        prot = self.protect_batched(generator, tree)
        aggd = self.aggregate_batched(prot)
        sel = torch.tensor([p - 1 for p in points], device=aggd.buf.device)
        return self.reveal(FlatProtected(aggd.buf[sel], aggd.layout),
                           points=points, dtype=dtype)

    @_traced("reveal")
    def reveal(self, protected, points=None, dtype=torch.float64):
        """Joint reconstruction of the (aggregate) secret -> floats.

        ``points=None`` assumes the share slices are in holder order and
        reconstructs from the first t (any t-subset reconstructs exactly).
        Pass explicit ``points`` when the slices are a non-contiguous
        center subset (then they must match the slice count).
        """
        t = self.scheme.threshold
        if isinstance(protected, FlatProtected):
            k = protected.buf.shape[0]
            if k < t:
                raise ValueError(
                    f"need >= t={t} shares, got {k} "
                    "(information-theoretically irrecoverable below "
                    "threshold)"
                )
            if points is None:
                buf = protected.buf[:t]
                pts = self._validated_points(None)
            else:
                buf = protected.buf
                pts = self._validated_points(points)
                if len(pts) != k:
                    raise ValueError("points must match share count")
            flat = _reveal_flat(buf, self.scheme, self.codec.frac_bits, pts)
            return unpack_pytree(flat, protected.layout, dtype=dtype)
        if points is None:
            leaves = tree_flatten(protected)[0]
            k = leaves[0].shape[0] if leaves else 0
            if k < t:
                raise ValueError(
                    f"need >= t={t} shares, got {k} "
                    "(information-theoretically irrecoverable below "
                    "threshold)"
                )
            protected = _tree_map(lambda s: s[:t], protected)
            points = self._validated_points(None)
        recon = self.scheme.reconstruct_pytree(protected, list(points))
        return _tree_map(lambda v: self.codec.decode(v, dtype=dtype), recon)

    def headroom_ok(self, max_abs: float, num_institutions: int) -> bool:
        """True if S summaries of magnitude <= max_abs aggregate exactly."""
        return max_abs * num_institutions < self.codec.capacity()

    # byte telemetry ----------------------------------------------------------
    def round_bytes(self, d: int, num_parts: int, protect: str,
                    include_count: bool = False,
                    num_live_centers: int | None = None,
                    num_configs: int = 1, extra_scalars: int = 0) -> int:
        """Per-round wire bytes from static shapes/dtypes alone.

        Shares travel as w x R slices of the flat int32 buffer (kernel
        backend, 4 B per element) or int64 leaf tensors (reference, 8 B);
        unprotected leaves go plain in float64.  ``include_count`` adds
        the coordinator's ``count`` leaf; ``num_live_centers`` switches to
        per-center slicing (each online center receives one 1/w slice);
        ``num_configs`` and ``extra_scalars`` size the multi-config wire.
        The same model as the JAX package's, byte for byte.
        """
        extra = (2 if include_count else 1) + extra_scalars
        n_protected = 0
        if protect in ("gradient", "both"):
            n_protected += d
        if protect in ("hessian", "both"):
            n_protected += d * d
        if protect != "none":
            n_protected += extra
        scheme = self.scheme
        w, num_r = scheme.num_shares, scheme.field.num_residues
        share_bytes = 0
        if n_protected:
            if self.backend == "kernel":
                rows = _rows_for(n_protected, ROW_ALIGN)
                share_bytes = w * num_r * rows * LANES * 4  # int32 wire
            else:
                share_bytes = w * num_r * n_protected * 8  # int64 leaves
            if num_live_centers is not None:
                share_bytes = (share_bytes // w) * num_live_centers
        n_plain = 0
        if protect in ("none", "hessian"):
            n_plain += d
        if protect in ("none", "gradient"):
            n_plain += d * d
        if protect == "none":
            n_plain += extra
        return num_configs * num_parts * (share_bytes + n_plain * 8)
