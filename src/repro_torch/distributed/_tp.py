"""One rank's part of the LM's sharded program: the weights by their
specs, the activations by their layouts.

The JAX package hands ``rules.constrain`` and the parameter specs to XLA's
partitioner.  Here each rank runs its part explicitly, on its blocks of
the parameters (``sharding.shard_params``), with ``compat``'s named-axis
collectives:

* a weight's FSDP-sharded dimensions (the dp axes, or the whole mesh for
  the ``fsdp_only`` / ``seq_parallel_prefill`` / ``rwkv_batch_parallel``
  specs) are all-gathered before use;
* a column-parallel weight (its output dimension over ``model``) leaves
  the output sharded: this rank's heads or channels;
* a row-parallel weight (its input dimension over ``model``) takes this
  rank's slice of a replicated input (or an input already sharded so)
  and the partial products are summed over ``model``;
* a replicated weight computes plainly.

Activations of a block lie in one of three layouts (``layout``):

* ``"dp"`` — the batch over the dp axes, replicated over ``model``
  (JAX's ``batch_spec()``);
* ``"full"`` — the batch over every axis (JAX's ``_block_batch_spec`` for
  ``fsdp_only`` blocks and ``rwkv_batch_parallel`` RWKV6 blocks); the
  block's weights are gathered whole;
* ``"seq"`` — the batch over the dp axes and the sequence over ``model``
  (JAX's ``_seq_spec``: windowed attention under
  ``seq_parallel_prefill``); the weights are gathered whole.

A collective over an axis of size 1 is skipped.  Without a mesh
(``rules`` None, or its ``mesh`` None) every spec is replicated and every
step computes plainly: the unsharded model is this program on one rank.

Gradients (``compat``'s collectives are differentiable).  Each rank
computes the gradient of the global loss with respect to its own
blocks.  Over the model axis the program keeps Megatron's convention: a
tensor that is the same on every rank of that axis (an activation in
the ``dp`` layout) carries its whole gradient on every rank.  So a cut's
backward gathers (:func:`cut`), an activation gather's keeps this rank's
block (:func:`gather`), a partial sum's psum passes the cotangent on
(:meth:`TP.psum_tp`), and a replicated input of a column-parallel
product, whose gradient on each rank covers only that rank's columns,
goes through ``compat.pvary`` (:meth:`TP.vary`).  A weight is the same
on every rank it is not split over, but where those ranks see other data
(the dp axes always; the model axis in the ``full`` and ``seq``
layouts) each one's gradient is partial: its FSDP gather's backward
reduce-scatters (:meth:`TP.weight`), and a leaf replicated there goes
through ``pvary`` once per use (:meth:`TP.enter`), so its gradient is
summed over those ranks.
"""
from __future__ import annotations

import torch

from . import compat

__all__ = ["TP", "block_layout", "cut", "gather"]


def _block(x, dim: int, axes):
    n = compat.axis_size(axes)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not "
                         f"split over {axes} ({n} ranks)")
    step = x.shape[dim] // n
    return x.narrow(dim, compat.axis_index(axes) * step, step)


class _Cut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axes):
        ctx.mesh, ctx.args = compat.current_mesh(), (axes, dim)
        return _block(x, dim, axes)

    @staticmethod
    def backward(ctx, g):
        with compat.use_mesh(ctx.mesh):
            return compat.all_gather(g, *ctx.args), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axes):
        ctx.mesh, ctx.args = compat.current_mesh(), (dim, axes)
        return compat.all_gather(x, axes, axis=dim)

    @staticmethod
    def backward(ctx, g):
        with compat.use_mesh(ctx.mesh):
            return _block(g, *ctx.args), None, None


def cut(x, dim: int, axes):
    """This rank's block along ``dim`` of a tensor whole over ``axes``
    (an axis name or a tuple of them; row-major over a tuple).  Its
    backward gathers every rank's block of the cotangent: the tensor is
    one value on every rank, which holds its whole gradient."""
    if not axes or compat.axis_size(axes) == 1:
        return x
    if compat._records(x):
        return _Cut.apply(x, dim, axes)
    return _block(x, dim, axes)


def gather(x, dim: int, axes):
    """The whole tensor along ``dim`` from every rank's block (the
    inverse of :func:`cut`; a collective) for the ranks to use alike:
    its backward keeps this rank's block of the cotangent."""
    if not axes or compat.axis_size(axes) == 1:
        return x
    if compat._records(x):
        return _Gather.apply(x, dim, axes)
    return compat.all_gather(x, axes, axis=dim)


def _split(spec) -> set:
    """The mesh axes some dimension of ``spec`` is split over."""
    return {a for axes in spec if axes is not None
            for a in ((axes,) if isinstance(axes, str) else axes)}


def block_layout(cfg, rules, batch: int, seq: int, mixer: str,
                 mode: str) -> str:
    """The layout of a (mixer, ffn) block's activations: JAX's
    ``_seq_spec`` (``seq``), then ``_block_batch_spec`` (``full``), else
    ``dp``.  A decode step runs an attention block in ``dp``: its cache
    is sharded by slot over ``model``, not by row.  Without a mesh, or on
    a mesh of one rank, every block runs in ``dp``."""
    if rules is None or rules.mesh is None or rules.size == 1:
        return "dp"
    tp, total = rules.tp_size, rules.dp_size * rules.tp_size
    if (cfg.seq_parallel_prefill and mode in ("train", "prefill")
            and mixer in ("swa", "local") and seq % tp == 0
            and seq >= 2 * tp and batch % rules.dp_size == 0):
        return "seq"
    if ((cfg.fsdp_only or (mixer == "rwkv6" and cfg.rwkv_batch_parallel))
            and batch % total == 0 and batch >= total
            and not (mode == "decode" and mixer in ("full", "swa", "local",
                                                    "mla"))):
        return "full"
    return "dp"


class TP:
    """This rank's coordinates on ``rules.mesh`` and the sharded program's
    steps.  With a mesh, build it and use it under
    ``compat.use_mesh(rules.mesh)``; without one (``rules`` None or its
    ``mesh`` None) it is one rank holding everything."""

    def __init__(self, rules, cfg):
        self.rules, self.cfg = rules, cfg
        self._specs: dict = {}
        self._varied = None  # (the last input vary() took, its pvary)
        self.meshed = rules is not None and rules.mesh is not None
        self.tp = rules.tp_axis if rules is not None else "model"
        if self.meshed:
            self.dp = rules.dp_axes
            self.ntp = compat.axis_size(self.tp)
            self.ndp = compat.axis_size(self.dp)
            self.tp_rank = compat.axis_index(self.tp)
        else:
            self.dp, self.ntp, self.ndp, self.tp_rank = (), 1, 1, 0

    def rows(self, batch: int):
        """The dp axes a batch of ``batch`` rows splits over: all of them,
        or none where they do not divide it, every rank then holding
        every row (JAX's batch spec falls back so: long_500k's one
        sequence on a 16 x 16 mesh)."""
        return self.dp if batch % self.ndp == 0 else ()

    # -- specs ----------------------------------------------------------------
    def specs(self, kind) -> dict:
        """{leaf name: its per-layer spec} for a block of ``kind``."""
        if kind not in self._specs:
            from ..models.transformer import _block_param_shapes

            self._specs[kind] = {
                name: self.spec(name, shape) for name, shape in
                _block_param_shapes(self.cfg, kind).items()}
        return self._specs[kind]

    def spec(self, name: str, shape) -> tuple:
        if not self.meshed:
            return (None,) * len(shape)
        from .sharding import param_pspec

        return param_pspec(name, tuple(shape), self.rules, self.cfg)

    # -- layouts --------------------------------------------------------------
    def relayout(self, x, src: str, dst: str):
        """(B, S, ...) activations from layout ``src`` to ``dst``: the
        batch and sequence go whole over ``model`` (``dp``), then split as
        ``dst`` splits them.  ``full`` and ``seq`` differ from ``dp`` only
        in ``model``, so no dp axis moves."""
        if src == dst:
            return x
        if src == "full":
            x = gather(x, 0, self.tp)
        elif src == "seq":
            x = gather(x, 1, self.tp)
        if dst == "full":
            x = cut(x, 0, self.tp)
        elif dst == "seq":
            x = cut(x, 1, self.tp)
        return x

    def psum_tp(self, x):
        if self.ntp == 1:
            return x
        return compat.psum(x, self.tp, donate=True)

    def vary(self, x):
        """``compat.pvary`` over ``model``: ``x``, the same on every rank,
        enters products that differ by rank.  One per tensor: the column
        products of one input (q, k and v of ``h``) share it, so autograd
        sums their partial gradients before the one psum."""
        if self.ntp == 1:
            return x
        if self._varied is None or self._varied[0] is not x:
            self._varied = (x, compat.pvary(x, self.tp))
        return self._varied[1]

    # -- weights --------------------------------------------------------------
    def enter(self, p: dict, specs: dict, whole: bool = False) -> dict:
        """A block's leaves (``p``, by ``specs``) ready for this rank's
        data: each goes through ``compat.pvary`` over the axes it is not
        split over whose ranks see other data — the dp axes, and with
        ``whole`` (the ``full`` and ``seq`` layouts) the model axis — so
        its gradient sums their partial ones.  The axes it is split over
        are gathered at use (:meth:`weight`), whose backward sums them."""
        if not self.meshed:
            return p
        see = [a for a in (self.dp + ((self.tp,) if whole else ()))
               if compat.axis_size(a) > 1]
        out = {}
        for name, t in p.items():
            axes = tuple(a for a in see if a not in _split(specs[name]))
            out[name] = compat.pvary(t, axes) if axes else t
        return out

    def weight(self, w, spec, whole: bool = False):
        """``w`` with every sharded dimension gathered but those split over
        ``model`` alone (all of them with ``whole``).  The gather's
        backward reduce-scatters: each rank applies the whole weight to
        its own data."""
        for dim, axes in enumerate(spec):
            if axes is None or (axes == self.tp and not whole):
                continue
            names = (axes,) if isinstance(axes, str) else tuple(axes)
            if not whole and self.tp in names:
                # split over (dp..., model), model last: the model axis
                # sees the same data here, so its ranks each hold the
                # whole gradient; gather it first, as an activation
                w = gather(w, dim, self.tp)
                names = names[:-1]
            if names and compat.axis_size(names) > 1:
                w = compat.all_gather(w, names, axis=dim)
        return w

    def linear(self, x, w, spec, *, split_in: bool = False,
               gather_out: bool = False, whole: bool = False):
        """``x @ w`` by ``w``'s (in, out) spec.  Row-parallel: ``x``'s last
        dimension is cut to this rank's rows (already so with
        ``split_in``) and the products summed over ``model``.
        Column-parallel: the output keeps this rank's columns
        (``gather_out`` gathers them).  ``whole`` gathers ``w`` whole and
        computes plainly (the ``full`` and ``seq`` layouts)."""
        w = self.weight(w, spec, whole)
        if whole:
            return x @ w
        if spec[0] == self.tp and self.ntp > 1:
            if not split_in:
                x = cut(x, -1, self.tp)
            return self.psum_tp(x @ w)
        if spec[1] != self.tp or self.ntp == 1:
            return x @ w
        y = self.vary(x) @ w
        return gather(y, -1, self.tp) if gather_out else y
