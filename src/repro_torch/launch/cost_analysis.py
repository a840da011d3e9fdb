"""A FLOP, byte and memory counter over the aten ops a program runs: the
port's counterpart of the JAX package's ``launch/hlo_analysis.py``.

JAX's dry run reads its numbers off the compiled HLO.  The port has no
compiler between the program and the card, so :class:`CostCounter` is a
``TorchDispatchMode`` that watches the program run: on ``meta`` tensors
(the shape dry run, ``launch/dryrun.py``), on the CPU or on the card
alike.  It keeps ``hlo_analysis``'s conventions:

* **flops** — matrix products only (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, ``mv``, ``dot`` and convolutions, forward and backward):
  2 x the result's elements x the contracted elements, as ``hlo_analysis``
  counts each ``dot``; everything else is negligible at transformer
  scale;
* **bytes** — the operand and result bytes of each aten op, a
  top-level convention like ``hlo_analysis``'s fusion boundaries: every
  tensor argument once, every result that is not an alias of an argument
  once; views and ``empty`` move nothing;
* **collective bytes** — per kind, with the factors of ``obs/metrics.py``
  (all-reduce 2 x its result, reduce-scatter 1 x its operand, all-gather
  1 x its result, a permutation 1 x), declared by
  ``distributed/compat.py`` (``obs/cost.py``), so a reduce-scatter and an
  all-gather of one buffer sum to the all-reduce's figure.

Loops need no trip counts: eager execution runs every iteration.  What
a dispatch mode cannot see is declared to it (``obs/cost.py``): each
kernel wrapper charges its kernel's work (``kernels/work.py``) on every
device, and the ops of its plain version or ``meta`` branch are not
counted again, so the same program counts the same on ``meta``, the CPU
and the card.

Memory.  The counter tracks live storage bytes: each storage an op
creates is counted from its creation to its death (a weakref on the
storage), and :meth:`CostCounter.track` adds storages that existed
before (the arguments).  ``peak_bytes`` is the most that was live at
once: the dry run's predicted peak a rank.  It counts no allocator
rounding and no library workspace.

Probed loops.  With ``probe_loops`` set, a loop on ``meta`` whose steps
cost alike (the recurrences over time, the banded attention's query
blocks, a training step's microbatches) and whose trip count is larger
runs its first ``probe_loops`` steps only (``obs/cost.loop_steps``; at
least three).  Every step but the first and the last costs the same, so
what the middle steps count, their backward and recomputation included,
is multiplied by (trip - 2) / (steps - 2): the ops run while the loop
yields them, and the backward of every autograd node they created (found
by its sequence number); loops nest, their factors multiply.  The bytes
a middle step leaves alive (its saved tensors, its output) are likewise
counted for the skipped steps in the peak, until the last of them dies.
FLOPs come out exactly as a run of every step counts them; bytes do not
quite (the slicing and stacking around the loop differ).
``scaled_loops`` records each loop so probed.  ``distributed/compat.py``'s
``wire_stats`` counts the calls that ran, the counter's collective bytes
what every step would move.
"""
from __future__ import annotations

import bisect
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..obs import cost as _cost_hooks

__all__ = ["CostCounter"]

_aten = torch.ops.aten


def _mm_flops(args, out) -> int:
    """2 x the result's elements x the contracted dimension, whose size is
    the last dimension of the first product operand."""
    a = args[1] if len(args) == 3 else args[0]  # addmm, baddbmm: bias first
    return 2 * out.numel() * a.shape[-1]


def _conv_flops(args, out) -> int:
    w = args[1]
    per_out = w[0].numel()  # (C_in / groups) x the kernel's taps
    if args[6]:  # transposed: every input element meets C_out / groups taps
        return 2 * args[0].numel() * w.shape[1] * w[0, 0].numel()
    return 2 * out.numel() * per_out


def _conv_bwd_flops(args, out) -> int:
    grad_out, _, w = args[:3]
    mask = args[-1]
    per = 2 * grad_out.numel() * w[0].numel()
    return per * (int(mask[0]) + int(mask[1]))


_FLOPS = {
    _aten.mm.default: _mm_flops,
    _aten.addmm.default: _mm_flops,
    _aten.bmm.default: _mm_flops,
    _aten.baddbmm.default: _mm_flops,
    _aten.mv.default: _mm_flops,
    _aten.dot.default: _mm_flops,
    _aten.convolution.default: _conv_flops,
    _aten.convolution_backward.default: _conv_bwd_flops,
}
# ops that write no data
_NO_BYTES = {_aten.empty.memory_format, _aten.empty_strided.default,
             _aten.empty_like.default}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts what the code under ``with CostCounter():`` runs.

    Totals: ``flops``, ``bytes``, ``collective_bytes`` and
    ``collective_count`` by kind, ``kernel_calls`` and ``kernel_flops`` by
    kernel, ``live_bytes`` and ``peak_bytes``, ``scaled_loops``.
    ``probe_loops`` (0: run every step) is the most steps a loop runs on
    ``meta``.  One counter is installed at a time.
    """

    def __init__(self, *, probe_loops: int = 0):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collective_bytes: dict = defaultdict(float)
        self.collective_count: dict = defaultdict(int)
        self.kernel_calls: dict = defaultdict(int)
        self.kernel_flops: dict = defaultdict(int)
        self.live_bytes = 0
        self.peak_bytes = 0
        self.probe_loops = probe_loops
        self.scaled_loops: dict = {}
        self._storages: dict = {}  # storage key -> bytes, while alive
        self._paused = 0
        self._scale = 1.0  # the enclosing probed loops' factor
        self._ranges: list = []  # (first, end, factor) node sequence numbers
        self._new_keys = None  # storages a probed scope creates
        self._phantoms: dict = {}  # storage key -> its probed scope's record

    # -- installation -------------------------------------------------------
    def __enter__(self):
        _cost_hooks.install(self)
        try:
            return super().__enter__()
        except BaseException:
            _cost_hooks.uninstall()
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _cost_hooks.uninstall()

    # -- memory --------------------------------------------------------------
    def track(self, *trees) -> int:
        """Count the storages of the tensors in ``trees`` as live from now
        until they die (the arguments of what runs next); returns the bytes
        newly tracked."""
        before = self.live_bytes
        for t in _tensors(trees):
            self._note(t)
        return self.live_bytes - before

    def reserve(self, nbytes: int) -> None:
        """Count ``nbytes`` as live from now on: arguments that are not
        tensors of their own (a rank's rows of a batch it is handed
        whole)."""
        self._add_live(nbytes)

    def _note(self, t) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self._add_live(n)
        if self._new_keys is not None:
            self._new_keys.append(key)
        weakref.finalize(st, self._free, key)

    def _add_live(self, n: int) -> None:
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key) -> None:
        self.live_bytes -= self._storages.pop(key, 0)
        rec = self._phantoms.pop(key, None)
        if rec is not None:
            rec["alive"] -= 1
            if rec["alive"] == 0:
                self.live_bytes -= rec["bytes"]

    # -- the ops -------------------------------------------------------------
    def _factor(self) -> float:
        """What an op counts for now.  A forward op (a recomputation
        included) counts the enclosing probed loops' factor; an op a
        backward runs, the factor of the innermost probed loop that created
        the autograd node running it (found by its sequence number), which
        holds the enclosing loops' factors too.  An op run inside a node
        takes the larger of the two: a recomputation re-entering a probed
        loop is deeper than the node that asked for it, and a node's
        backward is deeper than the loop the backward runs in."""
        node = torch._C._current_autograd_node() if self._ranges else None
        if node is None:
            return self._scale
        seq = node._sequence_nr()
        i = bisect.bisect_right(self._ranges, (seq, float("inf"))) - 1
        while i >= 0 and not self._ranges[i][0] <= seq < self._ranges[i][1]:
            i -= 1  # ranges nest: the innermost that holds seq
        return max(self._scale, self._ranges[i][2] if i >= 0 else 1.0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        # a result on an argument's storage (a view, an in-place op) is no
        # new storage: one the counter does not track stays untracked
        held = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            if t.untyped_storage()._cdata not in held:
                self._note(t)
        if self._paused or func.is_view or func in _NO_BYTES:
            return out
        f = self._factor()
        flops = _FLOPS.get(func)
        if flops is not None:
            self.flops += f * flops(args, outs[0])
        ids = {id(t) for t in ins}
        nbytes = sum(_nbytes(t) for t in ins)
        nbytes += sum(_nbytes(t) for t in outs if id(t) not in ids)
        self.bytes += f * nbytes
        return out

    # -- the hooks of obs/cost.py --------------------------------------------
    def kernel_call(self, name, work, fn, args, kwargs):
        """A kernel wrapper's call: its declared work, and nothing of the
        plain version or ``meta`` branch it runs."""
        f = self._factor()
        self.kernel_calls[name] += 1
        self.kernel_flops[name] += f * work.ops
        self.flops += f * work.ops
        self.bytes += f * work.bytes
        self._paused += 1
        try:
            return fn(*args, **kwargs)
        finally:
            self._paused -= 1

    def collective(self, kind: str, nbytes: float) -> None:
        f = self._factor()
        self.collective_bytes[kind] += f * nbytes
        self.collective_count[kind] += 1

    def loop_steps(self, trip: int, tensor) -> int:
        if (self.probe_loops and tensor.device.type == "meta"
                and trip > self.probe_loops):
            return max(3, self.probe_loops)
        return trip

    def probed(self, items, trip: int, steps: int, what: str):
        """Yield ``items``, the ``steps`` (at least 3) run of a loop of
        ``trip``.  The first and the last step count once: they may differ
        from the rest (a carry that starts as a constant takes no
        gradient, and nothing reads the last step's carry), as the first
        and last of every step do; each middle one counts (trip - 2) /
        (steps - 2) times, its backward included.  The bytes a middle step
        leaves alive (its saved tensors and output: not the carry, which
        each step replaces) are counted for the skipped steps too, until
        the last of them dies."""
        factor = (trip - 2) / (steps - 2)
        prev_scale, prev_keys = self._scale, self._new_keys
        self._new_keys = []
        span = []  # sequence numbers of the middle steps' first node, end
        marks = []  # live bytes and storages made by the end of each step
        try:
            for i, item in enumerate(items):
                if i in (1, steps - 1):  # the middle steps start, or end
                    self._scale = prev_scale * (factor if i == 1 else 1.0)
                    span.append(torch.autograd._get_sequence_nr())
                yield item
                marks.append((self.live_bytes, len(self._new_keys)))
        finally:
            keys = self._new_keys
            self._scale, self._new_keys = prev_scale, prev_keys
            if len(span) == 2:  # the middle steps' nodes, their total factor
                bisect.insort(self._ranges, (*span, prev_scale * factor))
            rec = self.scaled_loops.setdefault(
                what, {"trip": trip, "steps_run": steps, "scopes": 0})
            rec["scopes"] += 1
            if len(marks) == steps:
                growth = (marks[-2][0] - marks[0][0]) // (steps - 2)
                alive = {k for k in keys[marks[0][1]:marks[-2][1]]
                         if k in self._storages}
                extra = growth * (trip - steps)
                if alive and extra > 0:
                    phantom = {"alive": len(alive), "bytes": extra}
                    for k in alive:
                        self._phantoms[k] = phantom
                    self._add_live(extra)
