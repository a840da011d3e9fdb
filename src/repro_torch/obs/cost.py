"""Hook points of the cost counter (``launch/cost_analysis.py``).

The counter is a ``TorchDispatchMode``: it sees every aten op, so it
counts matrix products, bytes and storages by itself.  Three things it
cannot see through are declared to it here, where they happen:

* :func:`kernel` — every kernel wrapper: a CUDA kernel runs through
  ``ctypes``, outside anything a dispatcher sees, so each call charges the
  kernel's declared work (``kernels/work.py``) on every device, and the
  ops of its plain version (on the CPU) or of its ``meta`` branch are not
  counted again;
* :func:`collective` — the named-axis collectives of
  ``distributed/compat.py``: the bytes each moves, by kind;
* :func:`loop_steps` and :func:`probed` — a Python loop over time whose
  every step costs the same (the recurrences of ``models/ssm.py``): on
  the ``meta`` device a counter may run its first steps only and scale
  what they count by the trip count.

Stdlib-only, like the gate's hooks (``obs/gate.py``): with no counter
installed each hook costs one global read and a branch.
"""
from __future__ import annotations

import functools

__all__ = ["collective", "install", "kernel", "loop_steps", "probed",
           "uninstall"]

_handler = None  # the installed counter, or None


def install(handler) -> None:
    """Route every hook to ``handler`` until :func:`uninstall`."""
    global _handler
    if _handler is not None:
        raise RuntimeError("a cost counter is already installed")
    _handler = handler


def uninstall() -> None:
    global _handler
    _handler = None


def kernel(name: str, work_of):
    """Declare a kernel wrapper: each call charges ``work_of(*args,
    **kwargs)`` (a ``kernels.work.Work``) to the counter under ``name``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _handler is None:
                return fn(*args, **kwargs)
            return _handler.kernel_call(name, work_of(*args, **kwargs), fn,
                                        args, kwargs)

        return wrapper

    return deco


def collective(kind: str, nbytes: float) -> None:
    """A collective of ``kind`` moved ``nbytes`` (its factor applied)."""
    if _handler is not None:
        _handler.collective(kind, nbytes)


def loop_steps(trip: int, tensor) -> int:
    """How many of a loop's ``trip`` steps to run on ``tensor``'s device:
    all of them, unless a counter that probes loops is installed and the
    tensor is on ``meta``."""
    if _handler is None:
        return trip
    return _handler.loop_steps(trip, tensor)


def probed(items, trip: int, steps: int, what: str):
    """Iterate ``items``, the ``steps`` of a loop of ``trip`` steps that
    :func:`loop_steps` chose to run: the counter scales what they count,
    their backward included, by ``trip / steps``."""
    if _handler is None or steps == trip:
        return items
    return _handler.probed(items, trip, steps, what)
