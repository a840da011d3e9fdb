"""Deliberately leaky driver variants: the gate must FAIL on these.

Negative controls, the port's copies of the JAX package's
``analysis/fixtures.py``: each fixture is a small mutation of a real
driver round that commits one of the leak classes the taint interpreter
exists to catch.  If the gate ever certifies one of these, the gate
itself is broken, so ``python -m repro_torch.analysis`` runs them on
every invocation and fails unless every fixture produces an error.

* ``skip_protect``             — computes the summaries (kernel K3 on the
  card, whose outputs the dispatcher cannot see: the kernel declaration
  carries their taint) and sums them with a plain ``torch.sum``: SECRET
  data flows straight into the round's outputs.
* ``reveal_institution_slice`` — protects correctly, then reveals ONE
  institution's share slice instead of the Algorithm-2 aggregate.  The
  finding names the ``_reveal_flat`` boundary and its source lines.
* ``callback_leak``            — reads a per-institution deviance to the
  host (``.tolist()``, a print or telemetry hook): host code outside the
  protocol would observe institution-local data.
"""
from __future__ import annotations

import torch

from .drivers import DriverSpec, _aggregator, _generator, _packed
from .taint import PUBLIC, SECRET

__all__ = ["leak_fixture_specs"]


def _skip_protect_setup(device):
    from ..core.batched_summaries import batched_local_summaries
    from ..core.newton import newton_step, regularized_objective

    packed = _packed(device)

    def fn(beta, packed):
        sm = batched_local_summaries(beta, packed, backend="kernel")
        # LEAK: plain unannotated sums — no protect, no declassify_sum
        H = torch.sum(sm.hessian, dim=0)
        g = torch.sum(sm.gradient, dim=0)
        dev = torch.sum(sm.deviance)
        obj = regularized_objective(dev, beta, 1.0)
        return newton_step(beta, H, g, 1.0), obj

    beta = torch.zeros((packed.dim,), dtype=torch.float64, device=device)
    return fn, (beta, packed), (PUBLIC, SECRET)


def _reveal_slice_setup(device):
    from ..core.batched_summaries import batched_local_summaries
    from ..core.collective import FlatProtected

    agg = _aggregator()
    packed = _packed(device)
    t = agg.scheme.threshold

    def fn(beta, generator, packed):
        sm = batched_local_summaries(beta, packed, backend="kernel")
        tree = {"gradient": sm.gradient, "deviance": sm.deviance}
        prot = agg.protect_batched(generator, tree)
        # LEAK: slice institution 0's shares BEFORE Algorithm 2 — a
        # threshold reveal of this buffer reconstructs ONE institution's
        # summary, not the global aggregate
        inst0 = prot.buf[:t, :, 0]
        return agg.reveal(FlatProtected(inst0, prot.layout))

    beta = torch.zeros((packed.dim,), dtype=torch.float64, device=device)
    return fn, (beta, _generator(device), packed), (PUBLIC, PUBLIC, SECRET)


def _callback_leak_setup(device):
    from ..core.batched_summaries import batched_local_summaries
    from ..core.newton import _fused_secure_iteration

    agg = _aggregator()
    packed = _packed(device)

    def fn(beta, generator, packed):
        sm = batched_local_summaries(beta, packed, backend="kernel")
        # LEAK: per-institution deviances read to a host logging hook
        sm.deviance.tolist()
        return _fused_secure_iteration(beta, generator, packed, 1.0, agg,
                                       "both", 0.0,
                                       summaries_backend="kernel")

    beta = torch.zeros((packed.dim,), dtype=torch.float64, device=device)
    return fn, (beta, _generator(device), packed), (PUBLIC, PUBLIC, SECRET)


def leak_fixture_specs() -> list:
    """The negative controls, as DriverSpecs the same runner consumes."""
    t = _aggregator().scheme.threshold
    return [
        DriverSpec("LEAKY:skip_protect", _skip_protect_setup, t),
        DriverSpec("LEAKY:reveal_institution_slice", _reveal_slice_setup,
                   t),
        DriverSpec("LEAKY:callback_leak", _callback_leak_setup, t),
    ]
