"""Secure cross-validated regularization paths, many configurations a round.

The sweep advances C = (λ-chunk x K folds) path configurations at once
through the Shamir pipeline:

* **one pass over the data per round** — fold masks compose onto the
  packed batch's row masks (``batched_cv_summaries``, kernel K5 on the
  "kernel" rung), so every configuration's train-fold (H, g, dev) and
  held-out deviance/accuracy come out of one launch; X is never repacked
  per fold.
* **one launch per protocol phase per round** — the (C, S)-leading tree
  goes through ``SecureCollective.secure_round_multiconfig``: one
  encode+share (K1) over the C*S flat slices, one exact int64 sum over the
  institutions per configuration, one reveal (K2) of the C aggregates.
  Held-out metrics ride in the same protected buffer.
* **scan blocks** — ``rounds_per_sync`` rounds per block through
  ``core.scanfit.scan_rounds``, round r's sharing polynomials drawn from
  ``SecureCollective.round_key(seed, r)``.  Converged configurations
  freeze (break-before-update, as the sequential drivers); once the whole
  chunk has settled the remaining slots skip.  The (rounds_per_sync, C)
  objective trace comes back once per block.
* **warm starts along the path** — the λ grid (descending) runs in chunks
  of ``lam_block`` points; each chunk's fold iterates start from the
  previous chunk's converged fold betas.

The final refit runs through the same machinery: a trailing 1-config
chunk with ``fold == -1`` (no held-out rows) at the 1-SE λ, warm-started
from that λ's mean fold beta.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..core.batched_summaries import (
    BACKENDS as SUMMARY_BACKENDS,
    PackedPartitions,
    batched_cv_summaries,
    pack_partitions,
)
from ..core.collective import SecureCollective, declassify_sum
from ..core.newton import (
    batched_prox_newton_step,
    regularized_objective,
    should_stop,
)
from ..core.scanfit import scan_rounds
from ..obs import metrics as _metrics
from ..obs.trace import traced as _traced
from .folds import assign_folds, pack_fold_ids
from .report import PathReport, one_se_rule

__all__ = ["PathSettings", "PathDriver", "secure_cv_path"]

PROTECT_CHOICES = ("none", "gradient", "hessian", "both")
_VAL_LEAVES = ("val_deviance", "val_correct", "val_count")


def _cv_sweep_block(carry, seed: int, packed: PackedPartitions, fold_ids,
                    fold_of, lams, agg: SecureCollective, protect: str,
                    l1: float, tol: float, points: tuple[int, ...] | None,
                    summaries_backend: str, num_rounds: int,
                    num_parts: int, max_rounds: int):
    """``num_rounds`` secure sweep rounds as one block.

    Carry: per-configuration (betas, obj_prev, converged, iters, vdev,
    vcorr, vcnt) device tensors plus the global round slot (an int).
    Returns ``(carry, objs, actives)`` with (num_rounds, C) traces.  The
    ``max_rounds`` budget holds per configuration: a configuration
    spending its last budgeted round keeps the beta its revealed metrics
    were measured at, as convergence does.
    """
    scale = agg.codec.scale
    device = packed.X.device

    def round_fn(carry):
        betas, obj_prev, converged, iters, vdev, vcorr, vcnt, slot = carry
        sm = batched_cv_summaries(betas, packed, fold_ids, fold_of,
                                  backend=summaries_backend)
        revealed = {}
        if protect != "none":
            tree = {"deviance": sm.deviance, "count": sm.count}
            if protect in ("gradient", "both"):
                tree["gradient"] = sm.gradient
            if protect in ("hessian", "both"):
                tree["hessian"] = sm.hessian
            for k in _VAL_LEAVES:
                tree[k] = getattr(sm, k)
            revealed = agg.secure_round_multiconfig(
                agg.round_key(seed, slot, device), tree, points=points)
        else:
            # the plain exchange: only cross-institution sums leave
            for k in _VAL_LEAVES:
                revealed[k] = declassify_sum(getattr(sm, k), axis=1)
        # unprotected leaves leave the round ONLY as cross-institution
        # sums (axis 1 of the (C, S, ...) summaries)
        H = revealed["hessian"] if protect in ("hessian", "both") \
            else declassify_sum(sm.hessian, axis=1)
        g = revealed["gradient"] if protect in ("gradient", "both") \
            else declassify_sum(sm.gradient, axis=1)
        dev = revealed["deviance"] if protect != "none" \
            else declassify_sum(sm.deviance, axis=1)
        obj = regularized_objective(dev, betas, lams, l1)  # (C,)
        active = ~converged & (iters < max_rounds)
        stop = should_stop(obj_prev, obj, tol, num_parts, scale)
        conv_new = converged | (active & stop)
        beta_new = batched_prox_newton_step(betas, H, g, lams, l1)
        exhausting = active & (iters + 1 >= max_rounds)
        freeze = conv_new | exhausting | ~active
        betas = torch.where(freeze[:, None], betas, beta_new)
        obj_prev = torch.where(freeze, obj_prev, obj)
        iters = iters + active.to(iters.dtype)
        # held-out stats freeze at the stopping round's (= the reported
        # beta's) values and track while the configuration moves
        vdev = torch.where(active, revealed["val_deviance"], vdev)
        vcorr = torch.where(active, revealed["val_correct"], vcorr)
        vcnt = torch.where(active, revealed["val_count"], vcnt)
        return ((betas, obj_prev, conv_new, iters, vdev, vcorr, vcnt,
                 slot + 1), (obj, active))

    def skip_fn(carry):
        # the whole chunk settled: the remaining slots are free
        return (carry[:7] + (carry[7] + 1,),
                (carry[1], torch.zeros_like(carry[2])))

    def settled(carry):
        return torch.all(carry[2] | (carry[3] >= max_rounds))

    return scan_rounds(round_fn, skip_fn, settled, carry, num_rounds)


@dataclasses.dataclass(frozen=True)
class PathSettings:
    """Static configuration of one λ-path sweep."""

    lambdas: tuple[float, ...]  # DESCENDING
    num_folds: int = 5
    l1: float = 0.0
    protect: str = "gradient"
    tol: float = 1e-10
    summaries_backend: str = "kernel"
    lam_block: int = 1
    rounds_per_sync: int = 8
    max_rounds: int = 50
    warm_start: bool = True
    refit: bool = True
    seed: int = 0
    fold_seed: int = 0

    def __post_init__(self):
        if len(self.lambdas) == 0:
            raise ValueError("need at least one lambda")
        if any(a <= b for a, b in zip(self.lambdas, self.lambdas[1:])):
            raise ValueError(
                "lambdas must be strictly descending (duplicates would "
                "run identical configs through every secure round)"
            )
        if self.protect not in PROTECT_CHOICES:
            raise ValueError(f"protect must be one of {PROTECT_CHOICES}")
        if self.summaries_backend not in SUMMARY_BACKENDS:
            raise ValueError(
                f"summaries_backend must be one of {SUMMARY_BACKENDS}"
            )
        if not (1 <= self.lam_block <= len(self.lambdas)):
            raise ValueError("lam_block must be in 1..len(lambdas)")
        if self.rounds_per_sync < 1:
            raise ValueError("rounds_per_sync must be >= 1")
        if self.max_rounds < 1:
            raise ValueError(
                "max_rounds must be >= 1 (0 would 'run' the sweep without "
                "a single secure round and report all-zero betas)"
            )
        if self.num_folds < 2:
            raise ValueError("need at least 2 folds")


class PathDriver:
    """Chunked execution of a PathSettings sweep over caller-supplied parts.

    Each chunk takes the *current* partitions and per-institution fold
    ids (the ``SelectionCoordinator`` re-forms its cohort per chunk;
    ``secure_cv_path`` passes the same parts every time), on whatever
    device the parts live.  All cross-chunk state is a plain dict of
    numpy arrays — that dict IS the mid-path checkpoint.
    """

    def __init__(self, settings: PathSettings, agg: SecureCollective):
        if agg.backend != "kernel":
            raise ValueError(
                "the selection sweep requires the kernel backend (the flat "
                "share buffers ARE the batched multi-config wire format)"
            )
        self.settings = settings
        self.agg = agg

    # -- chunk schedule -------------------------------------------------------
    def chunks(self) -> list[tuple[int, ...]]:
        s = self.settings
        L = len(s.lambdas)
        return [tuple(range(i, min(i + s.lam_block, L)))
                for i in range(0, L, s.lam_block)]

    def num_chunks(self) -> int:
        # +1: the trailing full-data refit chunk at the selected λ
        return len(self.chunks()) + (1 if self.settings.refit else 0)

    # -- state ----------------------------------------------------------------
    def fresh_state(self) -> dict:
        s = self.settings
        L, K = len(s.lambdas), s.num_folds
        return {
            "next_chunk": np.asarray(0),
            "warm": np.zeros((0, 0)),  # (K, d) once known
            "fold_betas": np.zeros((0,)),  # (L, K, d) once d known
            "fold_rounds": np.zeros((L, K), np.int32),
            "fold_converged": np.zeros((L, K), bool),
            "val_deviance": np.zeros((L, K)),
            "val_correct": np.zeros((L, K)),
            "val_count": np.zeros((L, K)),
            "round_base": np.asarray(0),
            "rounds_total": np.asarray(0),
            "bytes_total": np.asarray(0, np.int64),
            "bytes_per_round": np.asarray(0, np.int64),
            "beta": np.zeros((0,)),  # refit result
            "refit_rounds": np.asarray(0),
            "refit_converged": np.asarray(False),
        }

    def finished(self, state: dict) -> bool:
        return int(state["next_chunk"]) >= self.num_chunks()

    # -- one chunk ------------------------------------------------------------
    @_traced("selection")
    def run_chunk(self, state: dict, parts: Sequence, fold_parts: Sequence,
                  points: Sequence[int] | None = None,
                  num_live_centers: int | None = None,
                  traces: list | None = None) -> dict:
        """Advance the sweep by one λ chunk (or the final refit chunk).

        ``parts``/``fold_parts`` describe the current cohort (float64
        tensors on one device; fold ids as anything ``torch.as_tensor``
        takes, e.g. the JAX package's as numpy); ``points`` and
        ``num_live_centers`` are the coordinator's live-center hooks.
        ``traces`` (optional list) receives the per-block objectives.
        """
        s = self.settings
        chunk_idx = int(state["next_chunk"])
        schedule = self.chunks()
        if chunk_idx >= self.num_chunks():
            return state
        is_refit = chunk_idx >= len(schedule)

        packed = pack_partitions(parts)
        device = packed.X.device
        fold_ids = pack_fold_ids(fold_parts, packed.X.shape[1], device)
        d, K = packed.dim, s.num_folds
        if state["fold_betas"].size == 0:
            state["fold_betas"] = np.zeros((len(s.lambdas), K, d))
        if state["warm"].size == 0:
            state["warm"] = np.zeros((K, d))

        if is_refit:
            lam_idx: tuple[int, ...] = ()
            pick = self._one_se_index(state)
            lams = np.asarray([s.lambdas[pick]])
            fold_of = np.asarray([-1], np.int32)
            # warm-start the full-data fit from that λ's mean fold beta
            betas0 = np.mean(state["fold_betas"][pick], axis=0,
                             keepdims=True)
        else:
            lam_idx = schedule[chunk_idx]
            lams = np.repeat(np.asarray(s.lambdas)[list(lam_idx)], K)
            fold_of = np.tile(np.arange(K, dtype=np.int32), len(lam_idx))
            betas0 = (np.tile(state["warm"][None], (len(lam_idx), 1, 1))
                      .reshape(-1, d) if s.warm_start
                      else np.zeros((len(lam_idx) * K, d)))
        cfg_rows = len(fold_of)

        bytes_per_round = self.agg.round_bytes(
            d, packed.num_institutions, s.protect,
            include_count=True, num_live_centers=num_live_centers,
            num_configs=cfg_rows, extra_scalars=3,
        )
        if not is_refit:
            # the report's wire figure: one round of a full (λ-chunk x
            # cohort) batch; the refit chunk counts into bytes_total only
            state["bytes_per_round"] = np.asarray(bytes_per_round,
                                                  np.int64)

        f64 = dict(dtype=torch.float64, device=device)
        zeros = torch.zeros((cfg_rows,), **f64)
        carry = (
            torch.as_tensor(betas0, **f64),
            torch.full((cfg_rows,), np.inf, **f64),
            torch.zeros((cfg_rows,), dtype=torch.bool, device=device),
            torch.zeros((cfg_rows,), dtype=torch.int32, device=device),
            zeros, zeros, zeros,
            int(state["round_base"]),
        )
        lams_t = torch.as_tensor(lams, **f64)
        fold_of_t = torch.as_tensor(fold_of, dtype=torch.int32,
                                    device=device)
        pts = (tuple(points) if points is not None and s.protect != "none"
               else None)
        chunk_trace = []
        executed = 0
        while True:
            carry, (objs, actives) = _cv_sweep_block(
                carry, s.seed, packed, fold_ids, fold_of_t, lams_t,
                self.agg, s.protect, float(s.l1), float(s.tol), pts,
                s.summaries_backend, s.rounds_per_sync,
                packed.num_institutions, s.max_rounds,
            )
            # host-sync: the block's read-back (the carry stays on the
            # device for the next block)
            objs, actives = objs.cpu().numpy(), actives.cpu().numpy()
            conv_f, iters_f = carry[2].cpu().numpy(), carry[3].cpu().numpy()
            chunk_trace.append(objs)
            executed += int(actives.any(axis=1).sum())
            if bool(conv_f.all()) or int(iters_f.max()) >= s.max_rounds:
                break
        betas_f, vdev_f, vcorr_f, vcnt_f = (
            carry[i].cpu().numpy() for i in (0, 4, 5, 6))

        state["round_base"] = np.asarray(carry[7])
        state["rounds_total"] = np.asarray(
            int(state["rounds_total"]) + executed)
        state["bytes_total"] = np.asarray(
            int(state["bytes_total"]) + executed * bytes_per_round,
            np.int64)
        if executed:
            _metrics.observe_round("selection_path", bytes_per_round,
                                   rounds=executed)
        if traces is not None:
            traces.append({
                "chunk": chunk_idx,
                "lambdas": lams.copy(),
                "objectives": np.concatenate(chunk_trace, axis=0),
            })
        if is_refit:
            state["beta"] = betas_f[0]
            state["refit_rounds"] = np.asarray(int(iters_f[0]))
            state["refit_converged"] = np.asarray(bool(conv_f[0]))
        else:
            by_lam = betas_f.reshape(len(lam_idx), K, d)
            for row, li in enumerate(lam_idx):
                state["fold_betas"][li] = by_lam[row]
                state["fold_rounds"][li] = iters_f.reshape(-1, K)[row]
                state["fold_converged"][li] = conv_f.reshape(-1, K)[row]
                state["val_deviance"][li] = vdev_f.reshape(-1, K)[row]
                state["val_correct"][li] = vcorr_f.reshape(-1, K)[row]
                state["val_count"][li] = vcnt_f.reshape(-1, K)[row]
            # warm-start source for the next chunk: this chunk's LAST
            # (smallest) λ, the path neighbour of the next chunk
            state["warm"] = by_lam[-1].copy()
        state["next_chunk"] = np.asarray(chunk_idx + 1)
        return state

    # -- reporting ------------------------------------------------------------
    def _cv_curve(self, state: dict):
        vcnt = np.maximum(state["val_count"], 1.0)
        per_rec = state["val_deviance"] / vcnt  # (L, K)
        cv_mean = per_rec.mean(axis=1)
        cv_se = per_rec.std(axis=1, ddof=1) / np.sqrt(per_rec.shape[1])
        cv_acc = (state["val_correct"].sum(axis=1)
                  / np.maximum(state["val_count"].sum(axis=1), 1.0))
        return cv_mean, cv_se, cv_acc

    def _one_se_index(self, state: dict) -> int:
        cv_mean, cv_se, _ = self._cv_curve(state)
        return one_se_rule(np.asarray(self.settings.lambdas), cv_mean,
                           cv_se)[1]

    def build_report(self, state: dict, traces: list | None = None
                     ) -> PathReport:
        s = self.settings
        cv_mean, cv_se, cv_acc = self._cv_curve(state)
        best, pick = one_se_rule(np.asarray(s.lambdas), cv_mean, cv_se)
        return PathReport(
            lambdas=np.asarray(s.lambdas),
            l1=s.l1,
            num_folds=s.num_folds,
            protect=s.protect,
            summaries_backend=s.summaries_backend,
            fold_betas=state["fold_betas"].copy(),
            fold_rounds=state["fold_rounds"].copy(),
            fold_converged=state["fold_converged"].copy(),
            val_deviance=state["val_deviance"].copy(),
            val_correct=state["val_correct"].copy(),
            val_count=state["val_count"].copy(),
            cv_mean=cv_mean,
            cv_se=cv_se,
            cv_accuracy=cv_acc,
            best_index=best,
            lambda_best=float(s.lambdas[best]),
            one_se_index=pick,
            lambda_1se=float(s.lambdas[pick]),
            beta=(state["beta"].copy() if state["beta"].size else None),
            refit_rounds=int(state["refit_rounds"]),
            rounds_total=int(state["rounds_total"]),
            bytes_per_round=int(state["bytes_per_round"]),
            bytes_total=int(state["bytes_total"]),
            traces=list(traces) if traces is not None else [],
        )


def secure_cv_path(
    parts: Sequence,
    lambdas: Sequence[float],
    num_folds: int = 5,
    l1: float = 0.0,
    protect: str = "gradient",
    aggregator: SecureCollective | None = None,
    tol: float = 1e-10,
    seed: int = 0,
    fold_seed: int = 0,
    summaries_backend: str = "kernel",
    lam_block: int = 1,
    rounds_per_sync: int = 8,
    max_rounds: int = 50,
    warm_start: bool = True,
    refit: bool = True,
    device=None,
) -> PathReport:
    """Run the whole secure CV λ-path over fixed (X_j, y_j) partitions.

    The in-process mirror of ``SelectionCoordinator.run_path``: K-fold
    cross-validated held-out deviance for every λ, all through the Shamir
    pipeline, the 1-SE-rule pick and a warm-started full-data refit.
    Partitions are indexed by position for the fold assignment, so the
    same parts always get the same folds.  ``device=None`` runs on the
    CUDA card (raising without one); parts move there once as float64.
    """
    dev = resolve_device(device)
    parts = [(torch.as_tensor(X, dtype=torch.float64, device=dev),
              torch.as_tensor(y, dtype=torch.float64, device=dev))
             for X, y in parts]
    settings = PathSettings(
        lambdas=tuple(sorted((float(l) for l in lambdas), reverse=True)),
        num_folds=num_folds, l1=float(l1), protect=protect, tol=tol,
        summaries_backend=summaries_backend, lam_block=lam_block,
        rounds_per_sync=rounds_per_sync, max_rounds=max_rounds,
        warm_start=warm_start, refit=refit, seed=seed, fold_seed=fold_seed,
    )
    driver = PathDriver(settings, aggregator
                        or SecureCollective(backend="kernel"))
    fold_parts = [assign_folds(Xj.shape[0], num_folds, j, fold_seed)
                  for j, (Xj, _) in enumerate(parts)]
    state = driver.fresh_state()
    traces: list = []
    while not driver.finished(state):
        state = driver.run_chunk(state, parts, fold_parts, traces=traces)
    return driver.build_report(state, traces)
