"""The one secure collective: pack -> protect -> aggregate -> reveal -> unpack.

Institutions protect local summaries, Computation Centers aggregate
share-wise (Algorithm 2), and only the threshold-met *aggregate* is ever
reconstructed.  :class:`SecureCollective` owns that chain once, the
counterpart of the JAX package's ``core/collective.py``, with its wires
across ranks (``psum``, ``psum_2d``, ``allreduce``, ``reveal_wire``;
:func:`secure_psum`, :func:`secure_psum_2d`, :class:`ShardedAggregate`)
on ``torch.distributed`` through :mod:`repro_torch.distributed.compat`.

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

The wires widen the int32 shares to int64 for the collective (the sum
of D residues overflows int32 from D = 2 on) and reduce mod p_r after
it, as the JAX package widens its uint32 shares to uint64: 8 bytes an
element cross the wire where a fabric with per-hop modular adds would
move 4 (the JAX package's payload model counts 4).

The named boundaries ``_protect_flat``, ``_reveal_flat``,
``_distributed_reveal`` and ``declassify_sum`` are the only places that
encode, reveal or sum in the clear; each records to the privacy ledger
(:mod:`repro_torch.obs.ledger`) before it runs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from ..distributed import compat as _compat
from ..distributed.sharding import POD_AXIS, SHARE_AXIS
from ..kernels import ops
from ..kernels.shamir_reconstruct import lagrange_weights_host
from ..obs import gate as _gate
from ..obs import ledger as _ledger
from ..obs.trace import traced as _traced
from .field import FieldSpec, crt_combine_signed, fsum, random_elements
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
    unpack_pytree_batched,
    unpack_pytree_tile,
)
from .shamir import ShamirScheme

__all__ = [
    "check_aggregation_headroom",
    "declassify_sum",
    "FlatProtected",
    "SecureCollective",
    "ShardedAggregate",
    "secure_psum",
    "secure_psum_2d",
    "REVEAL_MODES",
    "OUT_MODES",
]

REVEAL_MODES = ("replicated", "sharded")
OUT_MODES = ("tree", "tile")

# int64 accumulator: S reduced residues (< max p) sum exactly below 2**63
ACCUMULATOR_LIMIT = 2**63

_MASK64 = 2**64 - 1


def _splitmix64(x: int) -> int:
    """One splitmix64 step: a bijective 64-bit mix (Steele et al.)."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


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
# runtime privacy ledger, then runs; each is declared to the privacy gate
# (``obs/gate.py``), which sees the same calls.
# ------------------------------------------------------------------------


@_gate.boundary("declassify_sum")
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


def _wire_payload(buf: torch.Tensor) -> torch.Tensor:
    """K1 encodes float32 or float64 payloads: a tree of narrower floats
    (bf16 gradients, as the JAX package's batched round takes them)
    widens exactly to float32."""
    if buf.dtype in (torch.float32, torch.float64):
        return buf
    return buf.to(torch.float32)


@_gate.boundary("_protect_flat")
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
        device=buf.device, dtype=torch.int32,
    )  # (R, t-1, rows, 128)
    return ops.shamir_protect_flat(buf, coeffs, scheme.num_shares,
                                   field.moduli, frac_bits, points=points)


@_gate.boundary("_reveal_flat")
def _reveal_flat(buf: torch.Tensor, scheme: ShamirScheme, frac_bits: int,
                 points: tuple[int, ...]) -> torch.Tensor:
    """Lagrange + CRT reveal of (k, R, rows, 128) aggregated shares to a
    (rows, 128) float64 buffer."""
    _ledger.record_site("_reveal_flat", what="lagrange_reveal",
                        shape=buf.shape, threshold=scheme.threshold)
    return ops.shamir_reveal_flat(buf, points, scheme.field.moduli,
                                  frac_bits)


@_gate.boundary("_distributed_reveal")
def _distributed_reveal(agg_slice: torch.Tensor, scheme: ShamirScheme,
                        codec: FixedPointCodec, points: tuple[int, ...],
                        share_axis: str, dtype) -> torch.Tensor:
    """Lagrange reconstruction as a ``share_axis`` collective.

    ``agg_slice`` is this center's aggregated share slice (R, rows, 128).
    Each center multiplies it by its own public weight ``L_j(0) mod p_r``
    (k partial products, each below p_r < 2**31), ONE int64 sum over the
    share axis and a trailing mod give the aggregate residues on every
    center (exact: k * max(p) < 2**63), and the CRT decode is local.
    Plain field arithmetic, not K2: no center ever holds another's slice.
    """
    _ledger.record_site("_distributed_reveal", what="share_axis_reveal",
                        shape=agg_slice.shape, threshold=scheme.threshold)
    field = scheme.field
    j = _compat.axis_index(share_axis)
    lams = lagrange_weights_host(tuple(points), field.moduli)
    w = torch.tensor([row[j] for row in lams], dtype=torch.int64,
                     device=agg_slice.device)
    p = field.bcast(agg_slice, 0)
    partial = (agg_slice.to(torch.int64) * w[:, None, None]) % p
    summed = _compat.psum(partial, share_axis, donate=True) % p
    signed = crt_combine_signed(summed, field)
    return (signed.to(torch.float64) / codec.scale).to(dtype)


def _field_allreduce(shares: torch.Tensor, axis_name: str, field: FieldSpec,
                     residue_axis: int = 1, scatter_axis: int | None = None,
                     async_op: bool = False):
    """Exact share-wise field sum over a mesh axis (Algorithm 2 on the
    wire).

    The shares widen to int64 so the collective (which has no per-hop
    modular reduction) stays exact under ``check_aggregation_headroom``,
    and one trailing mod returns the reduced wire dtype.
    ``scatter_axis=None`` all-reduces (every rank gets the whole summed
    buffer); an integer reduce-scatters that axis so each rank keeps only
    its 1/D tile.  ``async_op=True`` returns a
    :class:`~repro_torch.distributed.compat.Pending` whose ``wait()``
    gives the reduced result.
    """
    wide = shares.to(torch.int64)
    if scatter_axis is None:  # int64 shares are summed into a copy
        pending = _compat.psum(wide, axis_name, async_op=True,
                               donate=wide is not shares)
    else:
        pending = _compat.psum_scatter(wide, axis_name,
                                       scatter_dimension=scatter_axis,
                                       async_op=True)
    pending = pending.then(
        lambda s: (s % field.bcast(s, residue_axis)).to(shares.dtype))
    return pending if async_op else pending.wait()


@dataclasses.dataclass
class ShardedAggregate:
    """A revealed aggregate that STAYS sharded over the reduce axis.

    ``secure_psum(reveal="sharded", out="tile")`` hands every rank its
    decoded ``(rows / D, 128)`` plaintext tile of the flat aggregate
    buffer instead of all-gathering and unpacking.  Code that consumes
    the aggregate shard-wise skips the gather; :meth:`gather` does what
    ``out="tree"`` would have done, so the two are bit-equal.
    """

    tile: torch.Tensor
    layout: FlatLayout
    num_tiles: int

    def gather(self, axis_name: str, dtype=torch.float32):
        """All-gather the plaintext tiles and unpack the full tree."""
        flat = _compat.all_gather(self.tile, axis_name, axis=0)
        return unpack_pytree(flat, self.layout, dtype=dtype)

    def local_fragments(self, tile_index: int, dtype=None):
        """Leaf fragments in THIS tile: ``{leaf: (start, stop,
        fragment)}`` (:func:`repro_torch.core.flatbuf.unpack_pytree_tile`).
        """
        return unpack_pytree_tile(self.tile, self.layout, tile_index,
                                  self.num_tiles, dtype=dtype)


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

    # rng threading --------------------------------------------------------
    @staticmethod
    def round_seed(seed: int, slot: int) -> int:
        """The 63-bit seed ``round_key`` gives round ``slot``'s generator:
        (seed, slot) mixed by two splitmix64 steps.  A seed of its own, so
        it composes: a wire folds the device's axis index in first and
        the round after (``round_seed(round_seed(seed, idx), r)``)."""
        return _splitmix64(_splitmix64(int(seed) & _MASK64)
                           ^ (int(slot) & _MASK64)) >> 1

    @staticmethod
    def round_key(seed: int, slot: int, device) -> torch.Generator:
        """The one per-round rng rule: round ``slot``'s generator on
        ``device``, seeded from (seed, slot) alone.

        Every scan-block consumer (``fit_scan_block``, the selection
        sweep) draws round r's sharing polynomials from this generator,
        so executed round r sees the same randomness however the fit was
        cut into blocks — which keeps a resumed run's shares identical
        to an uninterrupted one's.  (The JAX package folds the slot into
        a threefry key; the streams differ, the rule is the same.)
        """
        gen = torch.Generator(device=device)
        gen.manual_seed(SecureCollective.round_seed(seed, slot))
        return gen

    # institution side --------------------------------------------------------
    @_traced("protect")
    def protect(self, generator: torch.Generator, tree):
        """Encode floats to the field and split into shares.

        Reference backend: per-leaf share tree of (w, R, ...) int64.
        Kernel backend: a single ``FlatProtected`` share buffer.
        """
        if self.backend == "kernel":
            buf, layout = pack_pytree(tree)
            buf = _wire_payload(buf)
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
        buf = _wire_payload(buf)
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

    def allreduce(self, shares: torch.Tensor, axis_name: str,
                  residue_axis: int = 1, scatter_axis: int | None = None,
                  async_op: bool = False):
        """Algorithm 2 over a mesh axis: exact field sum of share slices
        (:func:`_field_allreduce`)."""
        return _field_allreduce(shares, axis_name, self.scheme.field,
                                residue_axis=residue_axis,
                                scatter_axis=scatter_axis, async_op=async_op)

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

    @_traced("secure_round")
    def secure_round_multiconfig(self, generator: torch.Generator, tree,
                                 points: Sequence[int] | None = None,
                                 dtype=torch.float64):
        """One secure round over a (C, S, ...)-leading summary tree.

        Every leaf carries a leading (configuration, institution) pair of
        axes — for the selection sweep, C is the (lambda x fold) path
        points advancing together.  Three launches whatever C is:

        * ONE encode+share launch (K1) over the C * S flat slices;
        * ONE exact int64 reduction over the institution axis of the
          (w, R, C, S, rows, 128) share buffer — Algorithm 2 per config;
        * ONE Lagrange + CRT reveal (K2) of the (C * rows, 128) stack of
          per-config aggregates, unpacked to (C, ...)-leading leaves.

        Per-institution validation scores therefore exist only as shares;
        only their cross-institution sums are revealed, per config.
        """
        points = self._validated_points(points)
        leaves, treedef = tree_flatten(tree)
        if not leaves:
            raise ValueError("cannot run a round on an empty tree")
        c_dim, s_dim = leaves[0].shape[0], leaves[0].shape[1]
        if any(tuple(l.shape[:2]) != (c_dim, s_dim) for l in leaves):
            raise ValueError(
                "all leaves need the same leading (config, institution) axes"
            )
        flat_tree = tree_unflatten(treedef, [
            l.reshape((c_dim * s_dim,) + tuple(l.shape[2:])) for l in leaves
        ])
        prot = self.protect_batched(generator, flat_tree)
        w, num_r, _, rows, lanes = prot.buf.shape
        by_config = prot.buf.reshape(w, num_r, c_dim, s_dim, rows, lanes)
        check_aggregation_headroom(s_dim, self.scheme.field)
        aggd = fsum(by_config, self.scheme.field, axis=3, residue_axis=1)
        sel = torch.tensor([p - 1 for p in points], device=aggd.device)
        stacked = aggd[sel].reshape(len(points), num_r, c_dim * rows, lanes)
        flat = _reveal_flat(stacked, self.scheme, self.codec.frac_bits,
                            points)  # (C * rows, 128) float64
        return unpack_pytree_batched(flat.reshape(c_dim, rows, lanes),
                                     prot.layout, dtype=dtype)

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

    def reveal_wire(self, buf: torch.Tensor,
                    points: tuple[int, ...]) -> torch.Tensor:
        """Reveal a raw (k, R, rows, 128) aggregated share buffer to a
        (rows, 128) float64 tile: the ``_reveal_flat`` boundary for wire
        code that carries the flat buffer itself (``scan_secure_rounds``),
        so the boundary is only ever called from this module."""
        return _reveal_flat(buf, self.scheme, self.codec.frac_bits, points)

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

    # wires across ranks ------------------------------------------------------
    def psum(self, tree, axis_name: str, seed: int, dtype=torch.float32,
             reveal: str = "replicated", points: Sequence[int] | None = None,
             out: str = "tree"):
        """Secret-shared all-reduce over a mesh axis (the 1D wire); see
        :func:`secure_psum` for the reveal and out contract."""
        if reveal not in REVEAL_MODES:
            raise ValueError(f"reveal must be one of {REVEAL_MODES}")
        if out not in OUT_MODES:
            raise ValueError(f"out must be one of {OUT_MODES}")
        if out == "tile" and reveal != "sharded":
            raise ValueError(
                "out='tile' only makes sense with reveal='sharded' — the "
                "replicated reveal already holds the full aggregate "
                "everywhere"
            )
        pts = self._validated_points(points)
        num_devices = _compat.axis_size(axis_name)
        check_aggregation_headroom(num_devices, self.scheme.field)
        leaves = tree_flatten(tree)[0]
        if self.overflow_check:
            # each rank's contribution within capacity / D, so the D-way
            # field sum cannot overflow
            for leaf in leaves:
                self.codec.check_headroom(leaf, num_addends=num_devices,
                                          what="secure_psum")
        generator = self.round_key(seed, _compat.axis_index(axis_name),
                                   leaves[0].device)
        if self.backend != "kernel":
            if reveal != "replicated":
                raise ValueError(
                    "reveal='sharded' needs the flat-buffer wire (kernel "
                    "backend); the per-leaf reference oracle is "
                    "replicated-only"
                )
            return _secure_psum_per_leaf(tree, axis_name, generator, self,
                                         pts, dtype)
        # the sharded reveal scatters the rows axis: rows a multiple of
        # lcm(8, D), so D tiles split evenly (the zero tail packs to zero
        # shares, benign through reduce and reveal)
        row_align = ROW_ALIGN if reveal == "replicated" else math.lcm(
            ROW_ALIGN, num_devices)
        buf, layout = pack_pytree(tree, row_align=row_align)
        shares = _protect_flat(generator, _wire_payload(buf), self.scheme,
                               self.codec.frac_bits, layout.rows,
                               points=pts)  # (t', R, rows, 128): the subset
        if reveal == "replicated":
            summed = self.allreduce(shares, axis_name)
            flat = _reveal_flat(summed, self.scheme, self.codec.frac_bits,
                                pts)
            return unpack_pytree(flat, layout, dtype=dtype)
        # (t', R, rows / D, 128): this rank's tile of the summed residues
        tile = self.allreduce(shares, axis_name, scatter_axis=2)
        flat_tile = _reveal_flat(tile, self.scheme, self.codec.frac_bits,
                                 pts).to(dtype)  # decode, gather plaintext
        if out == "tile":
            return ShardedAggregate(flat_tile, layout, num_devices)
        flat = _compat.all_gather(flat_tile, axis_name, axis=0)
        return unpack_pytree(flat, layout, dtype=dtype)

    def psum_2d(self, tree, seed: int, dtype=torch.float32,
                pod_axis: str = POD_AXIS, share_axis: str = SHARE_AXIS,
                points: Sequence[int] | None = None):
        """Secret-shared all-reduce on a 2D (pod, share) mesh.

        The share-axis size must equal the reveal subset (default: the
        threshold t).  Every (pod, share) rank draws the SAME sharing
        polynomial for its pod — the generator folds in only the pod
        index, and every rank of a pod must build it on the same device
        type (Philox on the card and the CPU generator give different
        streams) — keeps only its own slice, and the two collectives are

        1. an int64 sum over ``pod_axis`` — Algorithm 2 at center j;
        2. a weighted int64 sum over ``share_axis`` — the distributed
           Lagrange reveal (:func:`_distributed_reveal`).

        Bit-equal to the 1D :meth:`psum` wire: both reveal the exact field
        encoding of the global sum.
        """
        if self.backend != "kernel":
            raise ValueError("secure_psum_2d needs the flat-buffer wire "
                             "(kernel backend)")
        pts = self._validated_points(points)
        k = _compat.axis_size(share_axis)
        if k != len(pts):
            raise ValueError(
                f"share axis has {k} devices but the reveal subset is "
                f"{len(pts)} points — one center per revealed slice"
            )
        num_pods = _compat.axis_size(pod_axis)
        check_aggregation_headroom(num_pods, self.scheme.field)
        buf, layout = pack_pytree(tree)
        generator = self.round_key(seed, _compat.axis_index(pod_axis),
                                   buf.device)
        shares = _protect_flat(generator, _wire_payload(buf), self.scheme,
                               self.codec.frac_bits, layout.rows,
                               points=pts)  # the same on every column
        mine = shares[_compat.axis_index(share_axis)]  # center j's slice
        agg_slice = self.allreduce(mine, pod_axis, residue_axis=0)
        flat = _distributed_reveal(agg_slice, self.scheme, self.codec, pts,
                                   share_axis, torch.float64)
        return unpack_pytree(flat, layout, dtype=dtype)


def _secure_psum_per_leaf(tree, axis_name: str, generator: torch.Generator,
                          agg: SecureCollective, points: tuple[int, ...],
                          dtype):
    """The per-leaf int64 wire: the bit-exactness oracle.

    Protects leaf by leaf through the reference pipeline and all-reduces
    every holder's full (w, R, ...) int64 share tree (w * R * 8 bytes a
    parameter on the wire), then reveals on every rank.
    """
    protected = agg.protect(generator, tree)
    aggregated = _tree_map(
        lambda s: _field_allreduce(s, axis_name, agg.scheme.field),
        protected)
    sel = [p - 1 for p in points]
    subset = _tree_map(lambda s: s[sel], aggregated)
    return agg.reveal(subset, points=points, dtype=dtype)


@_traced("secure_psum")
def secure_psum(tree, axis_name: str, seed: int,
                aggregator: SecureCollective | None = None,
                dtype=torch.float32, reveal: str = "replicated",
                points: Sequence[int] | None = None, out: str = "tree"):
    """Secret-shared all-reduce over a mesh axis (SPMD Algorithm 1, 11-13).

    Call on every rank under ``use_mesh(mesh)``
    (:mod:`repro_torch.distributed.compat`).  Per rank: pack the local
    float tree into ONE (rows, 128) buffer, encode and share it in one K1
    launch (fresh polynomials a rank: the generator is
    ``round_key(seed, axis_index)``), sum the int32 share buffer over
    ``axis_name`` — Algorithm 2, executed by the virtual Computation
    Centers — and reveal only the global sum in one K2 launch.  Only the
    ``points`` subset of share slices (default: the first t) is evaluated
    or sent.

    ``reveal``: ``"replicated"`` — one all-reduce, every rank reveals the
    whole aggregate; ``"sharded"`` — a reduce-scatter over the rows axis,
    each rank reveals its 1/D tile and an all-gather assembles the
    decoded floats, so the share buffer crosses the wire once.
    ``out`` (sharded only): ``"tree"`` gathers and unpacks; ``"tile"``
    returns a :class:`ShardedAggregate` whose ``gather`` is bit-equal.
    ``aggregator=SecureCollective(backend="reference")`` selects the
    per-leaf int64 oracle (replicated only).
    """
    agg = aggregator or SecureCollective(backend="kernel")
    return agg.psum(tree, axis_name, seed, dtype=dtype, reveal=reveal,
                    points=points, out=out)


def secure_psum_2d(tree, seed: int,
                   aggregator: SecureCollective | None = None,
                   dtype=torch.float32, pod_axis: str = POD_AXIS,
                   share_axis: str = SHARE_AXIS,
                   points: Sequence[int] | None = None):
    """Module-level entry of the 2D (pod, share) wire; see
    :meth:`SecureCollective.psum_2d`.  Re-exported by
    :mod:`repro_torch.distributed.multihost`."""
    agg = aggregator or SecureCollective(backend="kernel")
    return agg.psum_2d(tree, seed, dtype=dtype, pod_axis=pod_axis,
                       share_axis=share_axis, points=points)
