"""Taint interpreter: SECRET may only reach PUBLIC through a reveal.

The JAX package's gate walks a traced jaxpr.  The port runs eagerly, so
its gate runs a driver round on small tensors (on the CPU or the card)
under two interpreters and propagates a four-level taint lattice op by op,
join = max:

* ``PUBLIC`` (0)        — revealed aggregates, beta, lambda, generators.
* ``PROTECTED_AGG`` (1) — the share buffer of the *aggregated* secret
  (Algorithm 2 has run over an institution or pod axis of size >= 2):
  still shares, but of the global sum — the only thing a reveal may
  reconstruct.
* ``PROTECTED`` (2)     — per-institution Shamir share buffers straight
  out of the encode+share boundary.  Revealing one reconstructs ONE
  institution's summary: a violation.
* ``SECRET`` (3)        — institution-local inputs (X, y, counts, fold
  ids) and anything derived from them before protection.

Taint lives on storages (``StorageWeakRef``), so a view shares its base's
taint, and an op that writes into an argument (its schema says so) joins
what it wrote into that storage: in-place ops, ``copy_`` and ``out=``
cannot launder.  Every op an interpreter sees joins its inputs into its
outputs, except for the transitions below, the same as the JAX package's
(``src/repro/analysis/taint.py``):

* ``_protect_flat`` (the fused encode + share boundary): outputs are
  PROTECTED whatever came in.
* A sum over the institution axis (axis ndim-3 of a >= 5-D operand, the
  (w, R, [C,] S, rows, 128) layout) with size >= 2 of a PROTECTED share
  buffer: Algorithm 2, PROTECTED -> PROTECTED_AGG.  A sum over any other
  axis keeps the taint.  The operand must be a view of a protect output
  with a nonzero stride on that axis: a buffer built by stacking, gathering
  or expanding one institution's slice is no aggregate.
* A sum over a mesh axis of size >= 2 (``psum`` / ``psum_scatter``) of a
  PROTECTED operand: Algorithm 2 on the wire -> PROTECTED_AGG.
* ``_reveal_flat`` (the fused Lagrange + CRT reveal): the only
  declassification of share material.  Requires input taint exactly
  PROTECTED_AGG and a share dim (leading) >= t.  Outputs PUBLIC.
* ``_distributed_reveal``: the same contract, with the share mesh axis
  (its size >= t) in place of the stacked share dim.
* ``declassify_sum``: the sanctioned plaintext aggregation; needs at
  least two addends, never takes share material, and goes onto the
  report's declassification audit trail.

Violations: SECRET or share material reaching a host read or an output of
the certified run.  The torch analogue of a host callback is a read to
the host: ``.item()``, ``.tolist()``, ``.numpy()``, ``float``/``int``/
``bool``, ``.cpu()``, ``.to("cpu")`` or a ``copy_`` from the card into a
host tensor (seen by a
``TorchFunctionMode``, which also sees ``.numpy()``, a call the dispatcher
never sees).  Findings name the boundary, collective, op or read and
its Python source line.

What a dispatcher cannot see is declared to the gate at its host wrapper
(``repro_torch/obs/gate.py``): the four boundaries, the named-axis
collectives of ``distributed/compat.py`` (axis and group size), and every
kernel wrapper.  A CUDA kernel writes its outputs through ``ctypes``, so
a declared kernel's outputs take the join of its inputs; on the CPU its
plain version runs inside the same declaration, so both devices give the
same taints.  Bodies of declared calls run opaque: the rule, not the
body, decides the outputs.

An eager run sees only the branch it takes (JAX's ``cond`` rule walks
both); coverage comes from the specs listing each mode
(:mod:`repro_torch.analysis.drivers`).  Generator draws are PUBLIC, as
JAX's keys are.  The boundary events of a run are its census, keyed
``(site, shape)`` as the ledger keys its counts; a scan block's executed
slots are folded into one round's census (:meth:`GateTrace.round_census`),
as JAX counts a scan body once.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from collections import Counter

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from ..obs import gate as _gate
from ..obs import trace as _trace
from .report import AnalysisReport, Finding

__all__ = [
    "PUBLIC",
    "PROTECTED_AGG",
    "PROTECTED",
    "SECRET",
    "TAINT_NAMES",
    "HOST_READS",
    "BoundaryEvent",
    "CollectiveEvent",
    "HostRead",
    "GateTrace",
    "verify_run",
]

PUBLIC, PROTECTED_AGG, PROTECTED, SECRET = 0, 1, 2, 3
TAINT_NAMES = {
    PUBLIC: "PUBLIC",
    PROTECTED_AGG: "PROTECTED_AGG",
    PROTECTED: "PROTECTED",
    SECRET: "SECRET",
}

# tensor methods and functions whose result is a host value: a read of
# device data to the host (``to`` counts when its target is the CPU,
# ``copy_`` when it copies the card's data into a host tensor)
HOST_READS = frozenset({
    "item", "tolist", "numpy", "cpu", "__bool__", "__float__", "__int__",
    "__index__", "__complex__", "__array__", "__format__", "__repr__",
    "equal", "allclose", "is_nonzero",
})

# the collectives that sum over a mesh axis (Algorithm 2 on the wire)
_SUM_COLLECTIVES = ("psum", "psum_scatter")

_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # the directory holding repro_torch/
# this module and the two hook layers (the gate's declarations, the span
# tracer's ``traced`` wrapper) are never the source line of a finding
_SKIP_FILES = {os.path.abspath(f) for f in (__file__, _gate.__file__,
                                            _trace.__file__)}
_SKIP_DIRS = (os.path.dirname(os.path.abspath(torch.__file__)),
              os.path.dirname(os.path.abspath(os.__file__)))


@dataclasses.dataclass(frozen=True)
class BoundaryEvent:
    """One call of a named boundary: the census key is (site, shape)."""

    site: str
    shape: tuple
    where: str
    slot: int | None  # the scan slot it ran in, None outside a block


@dataclasses.dataclass(frozen=True)
class CollectiveEvent:
    """One named-axis collective: its axis, the axis size in the mesh in
    use (None when unresolved) and that mesh's axis names."""

    kind: str
    axis: str
    size: int | None
    mesh_axes: tuple | None
    where: str


@dataclasses.dataclass(frozen=True)
class HostRead:
    """One read of tensor data to the host, with the taint it carried and
    the source file and line that made it."""

    kind: str
    where: str
    taint: int
    path: str
    line: int


@dataclasses.dataclass
class GateTrace:
    """What one certified run did, besides its findings."""

    boundaries: list = dataclasses.field(default_factory=list)
    collectives: list = dataclasses.field(default_factory=list)
    kernels: Counter = dataclasses.field(default_factory=Counter)
    host_reads: list = dataclasses.field(default_factory=list)
    slots: list = dataclasses.field(default_factory=list)  # executed flags

    def counts(self) -> dict:
        """Every boundary call, (site, shape) -> n: what the ledger
        records in an ungated run of the same call."""
        return dict(Counter((e.site, e.shape) for e in self.boundaries))

    def round_census(self) -> tuple[dict, int, bool]:
        """``(census, rounds, consistent)``: one round's boundary calls,
        the rounds the run executed, and whether every executed slot of a
        scan block made the same calls.  A run outside any block is one
        round; calls outside a block's slots are added to the census."""
        outside = Counter((e.site, e.shape) for e in self.boundaries
                          if e.slot is None)
        executed = [i for i, ran in enumerate(self.slots) if ran]
        if not executed:
            return dict(outside), 1, True
        per_slot = [Counter((e.site, e.shape) for e in self.boundaries
                            if e.slot == i) for i in executed]
        consistent = all(c == per_slot[0] for c in per_slot)
        return dict(outside + per_slot[0]), len(executed), consistent


def tensors_in(obj):
    """Every tensor inside ``obj``: tuples, lists, dicts, dataclasses and
    named tuples are walked (in order)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from tensors_in(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from tensors_in(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from tensors_in(getattr(obj, f.name))


def _key(t: torch.Tensor) -> StorageWeakRef:
    return StorageWeakRef(t.untyped_storage())


def _loc(filename: str, line: int) -> str:
    path = os.path.abspath(filename)
    if path.startswith(_SRC + os.sep):
        path = os.path.relpath(path, _SRC)
    else:
        path = os.path.basename(path)
    return f"{path}:{line}"


def _frames():
    """(file, line) of the calling Python frames, innermost first, past
    this module, the hook module, torch and the standard library."""
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename
        path = os.path.abspath(name)
        if not (name.startswith("<") or path in _SKIP_FILES
                or path.startswith(_SKIP_DIRS)):
            yield name, f.f_lineno
        f = f.f_back


def source_line() -> str:
    """The innermost caller's ``file:line``."""
    for name, line in _frames():
        return _loc(name, line)
    return "?"


def _call_chain() -> str:
    """The call site and, when it is inside a library module, the first
    caller in another file: ``a.py:10 <- b.py:20``."""
    first = None
    for name, line in _frames():
        if first is None:
            first = (name, line)
        elif name != first[0]:
            return f"{_loc(*first)} <- {_loc(name, line)}"
    return _loc(*first) if first else "?"


def _to_host(name, args, kwargs) -> bool:
    """``to`` a CPU device, or ``copy_`` from the card into a host
    tensor."""
    if name == "copy_":
        return (len(args) > 1 and isinstance(args[1], torch.Tensor)
                and args[0].device.type == "cpu"
                and args[1].device.type != "cpu")
    for a in list(args[1:]) + list(kwargs.values()):
        if isinstance(a, str) and a.split(":")[0] == "cpu":
            return True
        if isinstance(a, torch.device) and a.type == "cpu":
            return True
    return False


class _Gate:
    """The interpreter state of one certified run: taints by storage,
    the protect outputs, and the hooks' handler (``obs/gate.py``)."""

    def __init__(self, threshold: int, report: AnalysisReport):
        self.threshold = threshold
        self.report = report
        self.trace = GateTrace()
        self._taint: dict = {}
        self._origin: dict = {}
        self._shares: set = set()
        self._opaque = 0
        self._slot: int | None = None

    # -- taint bookkeeping ---------------------------------------------------
    def level(self, t: torch.Tensor) -> int:
        return self._taint.get(_key(t), PUBLIC)

    def join(self, ts) -> int:
        return max((self.level(t) for t in ts), default=PUBLIC)

    def _write(self, t: torch.Tensor, level: int, origin, overwrite: bool):
        k = _key(t)
        old = self._taint.get(k, PUBLIC)
        new = level if overwrite else max(old, level)
        self._taint[k] = new
        if new > PUBLIC and (overwrite or new > old or k not in self._origin):
            self._origin[k] = origin() if callable(origin) else origin

    def origin(self, t: torch.Tensor) -> str:
        return self._origin.get(_key(t), "")

    def add(self, severity: str, where: str, message: str) -> None:
        self.report.add(Finding("taint", severity, where, message))

    def declassified(self, where: str, what: str) -> None:
        entry = f"{where}: {what}"
        if entry not in self.report.declassifications:
            self.report.declassifications.append(entry)

    # -- the dispatch-level rule ---------------------------------------------
    def _aggregates(self, func, args) -> bool:
        """Algorithm 2: a sum over the institution axis of a protect
        output's share layout, with two or more distinct institutions."""
        if func is not torch.ops.aten.sum.dim_IntList:
            return False
        x, dims = args[0], args[1]
        nd = x.dim()
        if nd < 5 or not dims or len(dims) != 1:
            return False
        ax = dims[0] % nd
        return (ax == nd - 3 and x.shape[ax] >= 2 and x.stride(ax) != 0
                and _key(x) in self._shares)

    def op(self, func, args, kwargs):
        ins = list(tensors_in((args, kwargs)))
        level = self.join(ins)
        out = func(*args, **kwargs)
        if level == PROTECTED and self._aggregates(func, args):
            out_level = PROTECTED_AGG
        else:
            out_level = level
        if level == PUBLIC and out_level == PUBLIC:
            # nothing tainted flows: only writes into tainted storage
            # keep what they had, which max() leaves as it is
            return out

        def origin():
            return f"{func}@{source_line()}"

        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                val = args[i] if i < len(args) else kwargs.get(a.name)
                for t in tensors_in(val):
                    self._write(t, level, origin, overwrite=False)
                    # a written share buffer is no longer a protect
                    # output's layout: zeroing or overwriting institutions
                    # must not pass for Algorithm 2
                    self._shares.discard(_key(t))
        for t in tensors_in(out):
            self._write(t, out_level, origin, overwrite=False)
        return out

    def host_read(self, kind: str, args, kwargs) -> None:
        ts = list(tensors_in((args, kwargs)))
        level = self.join(ts)
        path, line = next(_frames(), ("?", 0))
        where = f"host-read({kind})@{_loc(path, line)}"
        self.trace.host_reads.append(HostRead(kind, where, level, path,
                                              line))
        if level > PUBLIC:
            self.add("error", where,
                     f"{TAINT_NAMES[level]} data reaches the host through "
                     f"'{kind}': a read leaves the protocol (logs, "
                     "telemetry, debuggers)")

    # -- the hooks (obs/gate.py) ---------------------------------------------
    def scan_slot(self, executed: bool) -> None:
        self._slot = len(self.trace.slots) if executed else None
        self.trace.slots.append(executed)

    def call(self, kind: str, name: str, fn, args, kwargs):
        if self._opaque:
            # inside a declared body the rule decides the taint, but the
            # trace still counts every collective (the mesh-axis lint)
            # and every kernel call
            if kind == "collective":
                self.trace.collectives.append(_collective_event(
                    name, args, kwargs, f"{name}@{_call_chain()}"))
            elif kind == "kernel":
                self.trace.kernels[name] += 1
            return fn(*args, **kwargs)
        ins = list(tensors_in((args, kwargs)))
        level = self.join(ins)
        where = f"{name}@{_call_chain()}"
        if kind == "boundary":
            self.trace.boundaries.append(BoundaryEvent(
                name, tuple(ins[0].shape), where, self._slot))
        elif kind == "collective":
            event = _collective_event(name, args, kwargs, where)
            self.trace.collectives.append(event)
        else:
            self.trace.kernels[name] += 1
        self._opaque += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._opaque -= 1
        if kind == "boundary":
            out_level = _BOUNDARY_RULES[name](self, args, kwargs, ins,
                                              level, where)
        elif kind == "collective":
            out_level = _collective_rule(self, event, level)
        else:
            out_level = level
        for t in _results(out):
            self._write(t, out_level, where, overwrite=True)
            if name == "_protect_flat":
                self._shares.add(_key(t))
        return out


def _results(out):
    """The tensors a declared call produced; a pending collective's is
    the buffer its ``wait()`` hands back."""
    from ..distributed.compat import Pending

    if isinstance(out, Pending):
        return [out._result]
    return list(tensors_in(out))


# -- the boundary rules ----------------------------------------------------


def _rule_protect_flat(g, args, kwargs, ins, level, where):
    return PROTECTED


def _check_reveal_input(g, level, where, what):
    if level == SECRET:
        g.add("error", where,
              f"{what} of UNPROTECTED institution-local data (the operand "
              "never went through the encode+share boundary)")
    elif level == PROTECTED:
        g.add("error", where,
              f"{what} of a PER-INSTITUTION share buffer: Algorithm 2 (the "
              "institution-axis aggregation) never ran, so this "
              "reconstructs a single institution's summary")
    return level == PROTECTED_AGG


def _rule_reveal_flat(g, args, kwargs, ins, level, where):
    k, t = ins[0].shape[0], g.threshold
    if k < t:
        g.add("error", where,
              f"reveal from {k} share slices < threshold t={t}: "
              "below-threshold reconstruction")
    if _check_reveal_input(g, level, where, "reveal"):
        g.declassified(
            where, "threshold Lagrange reveal of the aggregated share buffer")
    return PUBLIC


def _rule_distributed_reveal(g, args, kwargs, ins, level, where):
    from ..distributed import compat
    from ..distributed.sharding import SHARE_AXIS

    axis = args[4] if len(args) > 4 else kwargs.get("share_axis", SHARE_AXIS)
    size = _axis_size(compat, axis)
    t = g.threshold
    if size is None:
        g.add("warning", where,
              f"distributed reveal outside a mesh with a '{axis}' axis: "
              "cannot prove the center count >= t")
    elif size < t:
        g.add("error", where,
              f"distributed reveal over a share axis of {size} centers < "
              f"threshold t={t}")
    if _check_reveal_input(g, level, where, "distributed reveal"):
        g.declassified(
            where, "distributed (share-axis collective) Lagrange reveal")
    return PUBLIC


def _rule_declassify_sum(g, args, kwargs, ins, level, where):
    x = ins[0]
    axis = args[1] if len(args) > 1 else kwargs.get("axis", 0)
    addends = x.shape[axis] if x.dim() else 1
    in_elems = x.numel()
    out_elems = max(in_elems // max(addends, 1), 1)
    if level in (PROTECTED, PROTECTED_AGG):
        g.add("error", where,
              "declassify_sum applied to SHARE material — shares must go "
              "through the threshold reveal, never a plaintext sum")
    elif in_elems < 2 * out_elems:
        g.add("error", where,
              f"declassify_sum does not aggregate ({in_elems} -> "
              f"{out_elems} elements): a non-reducing 'sum' would "
              "declassify an individual contribution")
    elif level == SECRET:
        g.declassified(
            where, "annotated plaintext aggregation over the institution "
            f"axis ({in_elems // out_elems} addends)")
    return PUBLIC


_BOUNDARY_RULES = {
    "_protect_flat": _rule_protect_flat,
    "_reveal_flat": _rule_reveal_flat,
    "_distributed_reveal": _rule_distributed_reveal,
    "declassify_sum": _rule_declassify_sum,
}


# -- the collectives -------------------------------------------------------


def _axis_size(compat, axis: str):
    try:
        return compat.axis_size(axis)
    except (RuntimeError, ValueError):
        return None


def _collective_event(kind, args, kwargs, where) -> CollectiveEvent:
    from ..distributed import compat

    axis = args[1] if len(args) > 1 else kwargs["axis_name"]
    try:
        mesh_axes = tuple(compat.current_mesh().mesh_dim_names or ())
    except RuntimeError:
        mesh_axes = None
    return CollectiveEvent(kind, axis, _axis_size(compat, axis), mesh_axes,
                           where)


def _collective_rule(g, event: CollectiveEvent, level: int) -> int:
    if event.kind not in _SUM_COLLECTIVES or level != PROTECTED:
        return level
    if event.size is None:
        g.add("warning", event.where,
              f"'{event.kind}' over a mesh axis of unknown size on a share "
              "buffer: cannot prove it aggregates >= 2 institutions")
        return PROTECTED
    return PROTECTED_AGG if event.size >= 2 else PROTECTED


# -- the two interpreters --------------------------------------------------


class _Ops(TorchDispatchMode):
    def __init__(self, gate: _Gate):
        super().__init__()
        self.gate = gate

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.gate._opaque:
            return func(*args, **kwargs)
        return self.gate.op(func, args, kwargs)


class _HostReads(TorchFunctionMode):
    def __init__(self, gate: _Gate):
        super().__init__()
        self.gate = gate

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.gate._opaque:
            name = getattr(func, "__name__", "")
            if name in HOST_READS or (name in ("to", "copy_") and
                                      _to_host(name, args, kwargs)):
                self.gate.host_read(name, args, kwargs)
        return func(*args, **kwargs)


# -- entry point -----------------------------------------------------------


def verify_run(fn, args, in_taints, threshold: int, *, target: str = "run",
               report: AnalysisReport | None = None):
    """Run ``fn(*args)`` under the taint interpreters; return
    ``(report, trace, out)``.

    ``in_taints`` aligns with ``args``: every tensor inside an argument
    (a tuple, a dict, a dataclass such as ``PackedPartitions``) starts at
    that argument's taint.  Tensors of the result carrying taint above
    PUBLIC are violations: driver outputs feed ``RoundReport`` telemetry,
    host convergence checks and checkpoints.
    """
    if len(in_taints) != len(args):
        raise ValueError(f"{target}: got {len(in_taints)} taints for "
                         f"{len(args)} arguments")
    rep = report or AnalysisReport(target=target)
    g = _Gate(threshold, rep)
    for a, level in zip(args, in_taints):
        for t in tensors_in(a):
            g._write(t, level, f"{target}/input", overwrite=True)
    _gate.install(g)
    try:
        with _HostReads(g), _Ops(g):
            out = fn(*args)
    finally:
        _gate.uninstall()
    for i, t in enumerate(tensors_in(out)):
        level = g.level(t)
        made = g.origin(t)
        made = f" (made by {made})" if made else ""
        if level == SECRET:
            rep.add(Finding(
                "taint", "error", f"{target}/outputs[{i}]",
                "output carries SECRET taint: institution-local data "
                f"reaches a revealed/telemetry output{made}"))
        elif level in (PROTECTED, PROTECTED_AGG):
            rep.add(Finding(
                "taint", "error", f"{target}/outputs[{i}]",
                f"output carries {TAINT_NAMES[level]} share material: "
                f"share buffers must never leave the round{made}"))
    _, _, consistent = g.trace.round_census()
    if not consistent:
        rep.add(Finding(
            "taint", "error", target,
            "the executed rounds of one scan block made different "
            "boundary calls: no single certified round covers them"))
    if not rep.declassifications and rep.ok and SECRET in in_taints:
        rep.add(Finding(
            "taint", "warning", target,
            "SECRET inputs but no declassification site found: the run "
            "never reveals (vacuously safe — check the spec)"))
    return rep, g.trace, out
