"""Scan-block rounds: several secure rounds per host read-back.

The JAX package runs a block of rounds as one ``lax.scan`` with
``lax.cond`` skipping settled slots.  PyTorch has neither, so the port
runs the same shape as a host loop over the block's slots:

* :func:`scan_rounds` — the generic skeleton.  The carry stays on the
  device; each slot reads one public scalar, ``settled``, on the host (one
  sync per round, as the per-round driver already pays) and runs
  ``skip_fn`` or ``round_fn``.  A skipped slot still advances the slot
  counter and emits ``(obj_prev, False)``.  The emits are stacked once per
  block, so the traces come back in one read.
* :func:`fit_scan_block` — the single-configuration secure fit round
  under that skeleton: the fused iteration (K3 -> K1 -> int64 sum -> K2 ->
  Newton update) with round r's sharing polynomials drawn from
  ``SecureCollective.round_key(seed, r)``, and the per-round drivers'
  break-before-update and budget semantics.  ``selection/path.py`` runs
  its multi-configuration round through the same skeleton.
* :func:`run_fit_block` — one block for a driver that keeps the fit's
  carry (``SecureFitDriver`` and ``StudyCoordinator`` alike): the block,
  its one read-back, and the per-round ``RoundReport`` records.

Because every executed round r draws from ``round_key(seed, r)`` and
skipped slots advance the counter too, cutting a fit into blocks (or
resuming a checkpoint mid-fit) does not change any round's shares.
Capturing a block as a CUDA graph, which would remove the per-slot
``settled`` read, is later work (``ROADMAP.md``).
"""
from __future__ import annotations

import torch

from .._device import host_buffer
from ..obs import gate as _gate
from ..obs import metrics as _metrics
from .batched_summaries import PackedPartitions
from .collective import SecureCollective

__all__ = ["scan_rounds", "fit_scan_block", "run_fit_block"]


def _stack_emits(emits):
    return tuple(torch.stack([e[i] for e in emits])
                 for i in range(len(emits[0])))


def scan_rounds(round_fn, skip_fn, settled_fn, carry0, num_rounds: int,
                stream: str):
    """``num_rounds`` round slots with early skip.

    Each slot runs ``round_fn(carry)`` unless ``settled_fn(carry)`` (a
    boolean device scalar) is already True, in which case ``skip_fn``
    advances the slot for free.  Both return ``(carry, emit)`` with emit
    a tuple of device scalars or vectors of one structure.  Returns
    ``(carry, stacked emits)``, each emit stacked over the slots.  Each
    slot's read counts as one host read of the driver ``stream``.
    """
    carry, emits = carry0, []
    for _ in range(num_rounds):
        with _metrics.host_read(stream, "scan_rounds.settled"):
            # host-sync: one public scalar per slot
            settled = bool(settled_fn(carry))
        _gate.scan_slot(not settled)
        carry, emit = (skip_fn if settled else round_fn)(carry)
        emits.append(emit)
    return carry, _stack_emits(emits)


def fit_scan_block(beta, obj_prev, converged, iters, seed: int,
                   round_base: int, packed: PackedPartitions, lam,
                   agg: SecureCollective, protect: str, l1: float,
                   tol: float, points: tuple[int, ...] | None,
                   include_count: bool, summaries_backend: str,
                   num_rounds: int, num_parts: int, max_rounds: int,
                   stream: str = "secure_fit_scan"):
    """``num_rounds`` secure Newton rounds as one block (its host reads
    counted for the driver ``stream``).

    Returns ``(carry, objs, actives, grad_norms, step_norms)``: carry is
    ``(beta, obj_prev, converged, iters, slot)`` (device tensors, ``slot``
    a Python int), the traces are ``(num_rounds,)`` device tensors; the
    metric leaves are 0.0 on skipped slots.

    Semantics pinned to the per-round drivers:

    * a round that trips ``should_stop`` keeps the beta its objective was
      measured at (break-before-update) and flips ``converged``;
    * a round that spends the last budgeted slot (``iters`` reaching
      ``max_rounds``) without converging still applies its Newton update,
      as ``SecureFitDriver.run()`` leaves it when the limit ends the loop;
    * ``iters`` counts executed rounds, the stopping round included; the
      slot counter advances every slot, executed or skipped.
    """
    from .newton import _fused_secure_iteration, should_stop

    scale = agg.codec.scale
    device = packed.X.device

    def round_fn(carry):
        beta, obj_prev, converged, iters, slot = carry
        beta_new, obj, gnorm, snorm = _fused_secure_iteration(
            beta, agg.round_key(seed, slot, device), packed, lam, agg,
            protect, l1, points=points, include_count=include_count,
            summaries_backend=summaries_backend,
        )
        active = ~converged & (iters < max_rounds)
        stop = should_stop(obj_prev, obj, tol, num_parts, scale)
        conv_new = converged | (active & stop)
        freeze = conv_new | ~active
        beta = torch.where(freeze, beta, beta_new)
        obj_prev = torch.where(freeze, obj_prev, obj)
        iters = iters + active.to(iters.dtype)
        return ((beta, obj_prev, conv_new, iters, slot + 1),
                (obj, active, gnorm, snorm))

    def skip_fn(carry):
        beta, obj_prev, converged, iters, slot = carry
        zero = torch.zeros((), dtype=torch.float64, device=device)
        return ((beta, obj_prev, converged, iters, slot + 1),
                (obj_prev, torch.zeros((), dtype=torch.bool, device=device),
                 zero, zero))

    def settled(carry):
        return carry[2] | (carry[3] >= max_rounds)

    carry0 = (beta, obj_prev, converged, iters, int(round_base))
    carry, (objs, actives, gnorms, snorms) = scan_rounds(
        round_fn, skip_fn, settled, carry0, num_rounds, stream)
    return carry, objs, actives, gnorms, snorms


def run_fit_block(fit, packed: PackedPartitions, points, num_rounds: int,
                  l1: float, include_count: bool, nbytes: int,
                  report_fields: tuple[list, list, list], stream: str):
    """Run ``num_rounds`` rounds of :func:`fit_scan_block` from a driver's
    carry and advance the driver.

    ``fit`` holds the carry (``beta``, ``_obj_prev``, ``converged``,
    ``_round_base``), the round settings (``seed``, ``lam``, ``agg``,
    ``protect``, ``tol``, ``summaries_backend``) and the record
    (``iteration``, ``trace``, ``reports``).  ``report_fields`` are the
    (responders, stragglers, centers used) every round of the block
    shares; ``stream`` names the metrics stream.  Returns the block's
    executed rounds as ``RoundReport`` records.
    """
    from .newton import RoundReport

    device = packed.X.device
    carry, objs, actives, gnorms, snorms = fit_scan_block(
        fit.beta,
        torch.tensor(fit._obj_prev, dtype=torch.float64, device=device),
        torch.tensor(fit.converged, device=device),
        torch.zeros((), dtype=torch.int32, device=device),
        fit.seed, fit._round_base, packed, fit.lam, fit.agg, fit.protect,
        l1, float(fit.tol), points, include_count, fit.summaries_backend,
        num_rounds, packed.num_institutions, num_rounds, stream,
    )
    flat, unflatten = host_buffer(objs, actives, gnorms, snorms, carry[1],
                                  carry[2])
    with _metrics.host_read(stream, "run_fit_block"):
        # host-sync: the block's one read-back, one copy (beta stays on
        # the device)
        objs, actives, gnorms, snorms, obj_prev, conv = unflatten(
            flat.cpu().numpy())
    objs, gnorms, snorms = objs.tolist(), gnorms.tolist(), snorms.tolist()
    reports = []
    for r in range(num_rounds):
        if not actives[r]:
            break
        fit.iteration += 1
        fit.trace.append(objs[r])
        reports.append(RoundReport(
            fit.iteration, *report_fields, objs[r], nbytes,
            grad_norm=gnorms[r], step_norm=snorms[r],
        ))
        _metrics.observe_round(stream, nbytes, objective=objs[r],
                               grad_norm=gnorms[r], step_norm=snorms[r])
    fit.reports.extend(reports)
    fit.beta = carry[0]
    fit._obj_prev = float(obj_prev)
    fit.converged = bool(conv)
    fit._round_base = carry[4]
    return reports
