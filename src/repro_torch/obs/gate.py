"""Hook points of the privacy gate: boundaries, collectives, kernels, slots.

The static gate of the JAX package walks a traced graph.  The port runs
eagerly, so its gate (:mod:`repro_torch.analysis.taint`) runs a driver
round under a dispatch-level interpreter instead, and the calls that the
interpreter cannot see through are declared to it here, at their host
wrappers:

* :func:`boundary` — the four named boundaries of
  ``core/collective.py`` (``_protect_flat``, ``_reveal_flat``,
  ``_distributed_reveal``, ``declassify_sum``): the only places that
  encode, reveal or sum in the clear.  The ledger records the same calls
  (:mod:`repro_torch.obs.ledger`), so the gate's census and the ledger's
  counts share one key, ``(site, shape)``;
* :func:`collective` — the named-axis collectives of
  ``distributed/compat.py`` (a sum over a mesh axis is Algorithm 2 on
  the wire);
* :func:`kernel` — every kernel wrapper with a ``.launches`` counter: a
  CUDA kernel writes its outputs through ``ctypes``, outside anything a
  dispatcher sees, so each declared kernel's outputs take the join of its
  inputs;
* :func:`scan_slot` — one slot of ``core.scanfit.scan_rounds``, so the
  gate can fold a block's executed rounds into one round's census.

Stdlib-only, like the ledger: with no gate installed each hook costs one
global read and a branch.  The gate installs itself for the length of one
certified run (:func:`install` / :func:`uninstall`).
"""
from __future__ import annotations

import functools

__all__ = ["active", "boundary", "collective", "install", "kernel",
           "scan_slot", "uninstall"]

_handler = None  # the installed gate, or None


def active() -> bool:
    return _handler is not None


def install(handler) -> None:
    """Route every hook to ``handler`` until :func:`uninstall`."""
    global _handler
    if _handler is not None:
        raise RuntimeError("a privacy gate is already installed")
    _handler = handler


def uninstall() -> None:
    global _handler
    _handler = None


def _declare(kind: str, name: str | None):
    def deco(fn):
        label = name or fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _handler is None:
                return fn(*args, **kwargs)
            return _handler.call(kind, label, fn, args, kwargs)

        wrapper.gate_hook = (kind, label)
        return wrapper

    return deco


def boundary(site: str):
    """Declare one of the named protect/declassify boundaries."""
    return _declare("boundary", site)


def collective(kind: str):
    """Declare a named-axis collective (``psum``, ``pmax``,
    ``psum_scatter``, ``all_gather``); its second argument is the axis."""
    return _declare("collective", kind)


def kernel(fn):
    """Declare a kernel wrapper: its outputs join its inputs."""
    return _declare("kernel", None)(fn)


def scan_slot(executed: bool) -> None:
    """One slot of a scan block: its round runs (``executed``) or is
    skipped."""
    if _handler is not None:
        _handler.scan_slot(executed)
