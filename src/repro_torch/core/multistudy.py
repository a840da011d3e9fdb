"""Slot-packed multi-study rounds: M independent studies, one secure round.

The port of the JAX package's ``core/multistudy.py``.  A study is one more
leading slot axis on the summary tree, exactly like the selection sweep's
(lambda x fold) configuration axis, so
:func:`fused_multistudy_iteration` advances M independent cohorts by ONE
collective round on a shared (study-slot, S, ...) batch:

* per-study batched summaries (one K3 launch per study — the studies have
  different betas, so the summaries cannot share a launch);
* ONE ``SecureCollective.secure_round_multiconfig`` with the study slot as
  the configuration axis: one encode+share launch (K1) over the M * S
  flat slices, one exact int64 reduction over the institution axis per
  slot, one Lagrange + CRT reveal (K2) of the M per-study aggregates;
* per-study Newton/prox updates on the revealed aggregates, as one
  batched ``torch.linalg.solve`` (``vmap`` in the JAX package).

Shamir reconstruction cancels the sharing polynomials exactly in the
field, so each slot's revealed aggregate is the same field decode an
independent per-study round gives: a slot-packed fit matches M
independent fits to fixed-point quantization.  Slots are independent
payload lanes; no cross-study term ever forms, and only per-study
cross-institution aggregates are revealed.

Studies with different cohort sizes pack by padding: extra institutions
enter with ``count=0`` (their masked summaries are exactly zero, which
encodes to the zero field element and drops out of the aggregate), and
shorter record axes zero-pad below the count mask.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from .._device import resolve_device
from .batched_summaries import (
    PackedPartitions,
    batched_local_summaries,
    pack_partitions,
)
from .collective import SecureCollective, declassify_sum
from .newton import (
    _as_f64,
    _protected_tree,
    batched_prox_newton_step,
    regularized_objective,
)

__all__ = ["stack_studies", "fused_multistudy_iteration",
           "run_multistudy_rounds"]


def stack_studies(studies) -> PackedPartitions:
    """Stack M studies' partition lists into one (M, S, N, d) batch.

    ``studies`` is a sequence of per-study lists of ``(X_j, y_j)`` tensors
    on one device, as :func:`pack_partitions` takes them.  Ragged studies
    are padded to the widest cohort and the longest record axis: padding
    institutions carry ``count=0`` and all-zero rows, so their masked
    summaries are exactly zero and vanish from every aggregate.
    """
    if not studies:
        raise ValueError("need at least one study")
    packs = [pack_partitions(list(parts)) for parts in studies]
    d = packs[0].dim
    if any(p.dim != d for p in packs):
        raise ValueError("all studies must share the feature dimension")
    s_max = max(p.num_institutions for p in packs)
    n_max = max(p.X.shape[1] for p in packs)

    def pad(t, n_dim=None):
        widths = [0, 0] * (t.dim() - (2 if n_dim is not None else 1))
        if n_dim is not None:
            widths += [0, n_dim - t.shape[1]]
        widths += [0, s_max - t.shape[0]]
        return F.pad(t, widths)

    return PackedPartitions(
        torch.stack([pad(p.X, n_max) for p in packs]),
        torch.stack([pad(p.X32, n_max) for p in packs]),
        torch.stack([pad(p.y, n_max) for p in packs]),
        torch.stack([pad(p.counts) for p in packs]),
    )


def fused_multistudy_iteration(betas, generator, X, X32, y, counts, lams,
                               agg: SecureCollective, protect: str,
                               l1: float):
    """M independent secure Newton rounds as ONE collective round.

    Tensors carry a leading study-slot axis: ``betas`` (M, d), ``lams``
    (M,), ``X``/``X32``/``y``/``counts`` as :func:`stack_studies` stacks
    them.  The per-study summaries stack into a (study-slot, S, ...) tree
    and advance through ONE ``secure_round_multiconfig``; then each study
    takes its own prox/Newton step on its revealed aggregate.  Returns
    ``(betas_new, objectives, grad_norms, step_norms)``, each with the
    leading M axis, on the device.

    ``protect``/``l1`` are shared across slots (one wire contract per
    deployment); per-study λ rides in ``lams``.  The summaries are K3's
    (its plain version for CPU tensors), the shares go to every holder
    and no count leaf rides along.  Unprotected leaves leave the round
    per slot only as cross-institution sums through ``declassify_sum``.
    """
    sms = [
        batched_local_summaries(
            betas[m], PackedPartitions(X[m], X32[m], y[m], counts[m]),
            backend="kernel",
        )
        for m in range(X.shape[0])
    ]
    hessian = torch.stack([sm.hessian for sm in sms])    # (M, S, d, d)
    gradient = torch.stack([sm.gradient for sm in sms])  # (M, S, d)
    dev = torch.stack([sm.deviance for sm in sms])       # (M, S)
    revealed = {}
    tree = _protected_tree(protect, hessian, gradient, dev)
    if tree:
        revealed = agg.secure_round_multiconfig(generator, tree)
    global_h = revealed["hessian"] if protect in ("hessian", "both") \
        else declassify_sum(hessian, axis=1)
    global_g = revealed["gradient"] if protect in ("gradient", "both") \
        else declassify_sum(gradient, axis=1)
    global_dev = revealed["deviance"] if protect != "none" \
        else declassify_sum(dev, axis=1)
    global_g = global_g.to(torch.float64)
    obj = regularized_objective(global_dev, betas, lams, l1)
    betas_new = batched_prox_newton_step(betas, global_h, global_g, lams, l1)
    grad_norm = torch.linalg.vector_norm(global_g, dim=-1)
    step_norm = torch.linalg.vector_norm(betas_new - betas, dim=-1)
    return betas_new, obj, grad_norm, step_norm


def run_multistudy_rounds(studies: Sequence, lams, num_rounds: int,
                          aggregator: SecureCollective | None = None,
                          protect: str = "both", l1: float = 0.0,
                          seed: int = 0, device=None):
    """Advance M studies ``num_rounds`` rounds, one collective round each.

    ``studies`` holds each study's list of ``(X_j, y_j)`` partitions
    (numpy or tensors; moved to ``device`` as float64, the CUDA card
    unless the caller passes ``device="cpu"``).  There is no convergence
    test yet — every study runs the full budget.  Returns ``(betas,
    objective_trace)``: ``betas`` (M, d) and ``objective_trace``
    (num_rounds, M), float64 on the device.  Round r draws its sharing
    polynomials from ``SecureCollective.round_key(seed, r)``, though the
    revealed aggregates (and so the betas) do not depend on them.
    """
    dev = resolve_device(device)
    agg = aggregator or SecureCollective(backend="kernel")
    packed = stack_studies([
        [(_as_f64(X, dev), _as_f64(y, dev)) for X, y in parts]
        for parts in studies])
    betas = torch.zeros((len(studies), packed.X.shape[-1]),
                        dtype=torch.float64, device=dev)
    lams = torch.as_tensor(lams, dtype=torch.float64, device=dev)
    trace = []
    for r in range(num_rounds):
        betas, objs, _, _ = fused_multistudy_iteration(
            betas, agg.round_key(seed, r, dev), packed.X, packed.X32,
            packed.y, packed.counts, lams, agg, protect, l1,
        )
        trace.append(objs)
    return betas, torch.stack(trace)
