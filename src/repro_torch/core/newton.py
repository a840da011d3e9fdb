"""Newton-Raphson drivers: centralized gold standard + secure distributed.

``centralized_fit`` is the oracle the paper compares against (pooled
IRLS, no privacy).  ``secure_fit`` runs the paper's Algorithm 1:
per-institution summaries -> Shamir protection -> share-wise aggregation
at the Computation Centers -> reconstruction of the *global* aggregate
only -> Newton update (Eq. 3) -> deviance-based convergence check.

Two execution shapes for the secure loop, as in the JAX package:

* **fused** (default on the kernel backend) — one batched summaries call
  over all S (ragged) institutions (kernel K3), one batched protect over
  the S flat buffers (K1), one exact int64 reduction for Algorithm 2,
  one reveal (K2) and the Newton/prox update; the only host sync per
  iteration is the read of three public scalars.
* **loop** (reference backend, or ``fused=False``) — the paper-shaped
  Python loop over institutions, one protect per institution.  Kept as
  the correctness comparator.

``rounds="scan"`` runs the fused round in blocks of ``rounds_per_sync``
slots (``core/scanfit.py``): the carry stays on the device, round r's
sharing polynomials come from ``SecureCollective.round_key(seed, r)``, and
the block's traces come back in one read.  Entry points run on the CUDA
card unless the caller passes ``device="cpu"``; without a card they raise
instead of falling back to the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..obs import metrics as _metrics
from ..obs.trace import traced as _traced
from .batched_summaries import (
    BACKENDS as SUMMARY_BACKENDS,
    PackedPartitions,
    batched_local_summaries,
    pack_partitions,
)
from .collective import FlatProtected, SecureCollective, declassify_sum
from .flatbuf import tree_flatten, tree_unflatten
from .logreg import LocalSummaries, local_summaries

__all__ = ["FitResult", "RoundReport", "newton_step", "prox_newton_step",
           "batched_prox_newton_step",
           "centralized_fit", "secure_fit", "SecureFitDriver",
           "regularized_objective", "stop_threshold", "should_stop",
           "stop_threshold_host", "should_stop_host"]

PROTECT_CHOICES = ("none", "gradient", "hessian", "both")


# -- the one stopping rule ---------------------------------------------------
#
# Every secure driver terminates on the SAME deviance test, computed from
# identically formed objectives (tensor forms below, host twins for
# objectives already read back as Python floats).

def regularized_objective(dev, beta, lam, l1=0.0):
    """The convergence objective at beta: deviance + lam ||b||^2 (+ L1)."""
    beta = torch.as_tensor(beta, dtype=torch.float64)
    dev = torch.as_tensor(dev, dtype=torch.float64, device=beta.device)
    return (dev + lam * torch.sum(beta**2, dim=-1)
            + 2.0 * l1 * torch.sum(torch.abs(beta), dim=-1))


def stop_threshold(obj, tol: float, num_parts: int, scale: float):
    """max(relative tolerance, fixed-point quantization floor).

    The deviance travels through the fixed-point codec, so no driver may
    test convergence tighter than the aggregate quantization of S
    institution deviances plus the revealed sum ((S+1) half-ulps).
    """
    quant_floor = (num_parts + 1) * 0.5 / scale
    return torch.clamp(tol * (1.0 + torch.abs(obj)), min=quant_floor)


def should_stop(obj_prev, obj, tol: float, num_parts: int, scale: float):
    """True when |obj_prev - obj| clears the shared threshold."""
    return torch.abs(obj_prev - obj) < stop_threshold(obj, tol, num_parts,
                                                      scale)


def stop_threshold_host(obj: float, tol: float, num_parts: int,
                        scale: float) -> float:
    """Pure-host twin of ``stop_threshold`` (IEEE-identical for floats)."""
    quant_floor = (num_parts + 1) * 0.5 / scale
    return max(tol * (1.0 + abs(obj)), quant_floor)


def should_stop_host(obj_prev: float, obj: float, tol: float,
                     num_parts: int, scale: float) -> bool:
    """Pure-host twin of ``should_stop`` for already-synced objectives."""
    return abs(obj_prev - obj) < stop_threshold_host(obj, tol, num_parts,
                                                     scale)


@dataclasses.dataclass
class FitResult:
    beta: np.ndarray
    iterations: int
    converged: bool
    deviance_trace: list
    central_seconds: float = 0.0
    total_seconds: float = 0.0
    bytes_transmitted: int = 0


@dataclasses.dataclass
class RoundReport:
    """One secure round's audit record.

    The trailing fault-supervision fields keep their fault-free defaults
    unless a ``runtime.RoundSupervisor`` stamps the round's retries,
    simulated backoff, aborted attempts and degradation into them.
    """

    iteration: int
    responders: list
    stragglers: list
    centers_used: list
    objective: float
    bytes_transmitted: int
    retries: int = 0
    backoff_seconds: float = 0.0
    aborted_attempts: int = 0
    degraded: bool = False
    grad_norm: float = 0.0
    step_norm: float = 0.0


def newton_step(beta: torch.Tensor, hessian: torch.Tensor,
                gradient: torch.Tensor, lam: float) -> torch.Tensor:
    """Eq. 3: beta + (X^T W X + lam I)^{-1} (g - lam beta), in float64.

    Operates on revealed global aggregates plus public lambda/beta.
    """
    d = beta.shape[0]
    A = hessian + lam * torch.eye(d, dtype=hessian.dtype,
                                  device=hessian.device)
    return beta + torch.linalg.solve(A, gradient - lam * beta)


def _soft_threshold(x, t):
    return torch.sign(x) * torch.clamp(torch.abs(x) - t, min=0.0)


def prox_newton_step(beta: torch.Tensor, hessian: torch.Tensor,
                     gradient: torch.Tensor, lam: float, l1: float,
                     inner_steps: int = 200) -> torch.Tensor:
    """Proximal Newton step for elastic-net logistic regression.

    Minimizes the local quadratic model
    m(b) = -g^T (b - beta) + 1/2 (b - beta)^T H (b - beta)
           + lam/2 ||b||^2 + l1 ||b||_1
    with ``inner_steps`` FISTA iterations (a d x d problem at the center).
    l1 = 0 reduces exactly to the L2 Newton step.
    """
    if l1 == 0.0:
        return newton_step(beta, hessian, gradient, lam)
    d = beta.shape[0]
    A = hessian + lam * torch.eye(d, dtype=hessian.dtype,
                                  device=hessian.device)
    L = torch.linalg.matrix_norm(A, ord=2) + 1e-12
    b, z, t = beta, beta, torch.ones((), dtype=beta.dtype,
                                     device=beta.device)
    for _ in range(inner_steps):
        grad = -gradient + hessian @ (z - beta) + lam * z
        b_new = _soft_threshold(z - grad / L, l1 / L)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        z = b_new + ((t - 1.0) / t_new) * (b_new - b)
        b, t = b_new, t_new
    return b


def batched_prox_newton_step(betas, H, g, lams, l1: float,
                             inner_steps: int = 200):
    """The Newton (``l1 == 0``) or proximal Newton step of every slot at
    once, each with its own λ: ``newton_step`` and ``prox_newton_step``
    batched over the leading (C,) axis — the λ-path's configurations, the
    multi-study round's studies."""
    H = H.to(torch.float64)
    g = g.to(torch.float64)
    eye = torch.eye(betas.shape[1], dtype=H.dtype, device=H.device)
    A = H + lams[:, None, None] * eye
    if l1 == 0.0:
        return betas + torch.linalg.solve(A, g - lams[:, None] * betas)
    L = (torch.linalg.matrix_norm(A, ord=2) + 1e-12)[:, None]  # (C, 1)
    b, z = betas, betas
    t = torch.ones((), dtype=betas.dtype, device=betas.device)
    for _ in range(inner_steps):
        grad = (-g + torch.einsum("cij,cj->ci", H, z - betas)
                + lams[:, None] * z)
        b_new = _soft_threshold(z - grad / L, l1 / L)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        z = b_new + ((t - 1.0) / t_new) * (b_new - b)
        b, t = b_new, t_new
    return b


def _as_f64(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def centralized_fit(X, y, lam: float = 1.0, tol: float = 1e-10,
                    max_iter: int = 50, device=None) -> FitResult:
    """Gold-standard pooled IRLS (no privacy) for accuracy comparison."""
    dev_ = resolve_device(device)
    X, y = _as_f64(X, dev_), _as_f64(y, dev_)
    beta = torch.zeros((X.shape[1],), dtype=torch.float64, device=dev_)
    dev_prev = np.inf
    trace: list[float] = []
    converged = False
    it = 0
    for it in range(1, max_iter + 1):
        s = local_summaries(beta, X, y)
        obj = float(regularized_objective(s.deviance, beta, lam))
        trace.append(obj)
        if abs(dev_prev - obj) < tol * (1.0 + abs(obj)):
            converged = True
            break
        dev_prev = obj
        beta = newton_step(beta, s.hessian, s.gradient, lam)
    return FitResult(beta.cpu().numpy(), it, converged, trace)


def _protected_tree(protect: str, hessian, gradient, dev):
    """The leaves Algorithm 1 secret-shares under a given protect mode."""
    tree = {}
    if protect in ("gradient", "both"):
        tree["gradient"] = gradient
    if protect in ("hessian", "both"):
        tree["hessian"] = hessian
    if protect != "none":
        tree["deviance"] = dev
    return tree


def _fused_secure_iteration(beta, generator, packed: PackedPartitions, lam,
                            agg: SecureCollective, protect: str, l1: float,
                            points: tuple[int, ...] | None = None,
                            include_count: bool = False,
                            summaries_backend: str = "kernel"):
    """One whole secure Newton iteration, every phase one batched call.

    batched summaries -> batched protect (ONE encode+share launch over
    the S flat buffers) -> one exact int64 reduction over the institution
    axis (Algorithm 2) -> reveal of the *global* aggregate only ->
    prox/Newton update.  Returns ``(beta_new, objective, grad_norm,
    step_norm)`` as device scalars; the caller reads the three public
    scalars back in the round's one host sync.
    """
    sm = batched_local_summaries(beta, packed, backend=summaries_backend)
    hessian, gradient, dev = sm.hessian, sm.gradient, sm.deviance
    revealed = {}
    tree = _protected_tree(protect, hessian, gradient, dev)
    if tree and include_count:
        tree["count"] = packed.counts.to(torch.float64)
    if tree:
        revealed = agg.secure_round_batched(generator, tree, points=points)
    # unprotected leaves still only ever leave as cross-institution sums
    global_h = revealed["hessian"] if protect in ("hessian", "both") \
        else declassify_sum(hessian, axis=0)
    global_g = revealed["gradient"] if protect in ("gradient", "both") \
        else declassify_sum(gradient, axis=0)
    global_dev = revealed["deviance"] if protect != "none" \
        else declassify_sum(dev, axis=0)
    obj = regularized_objective(global_dev, beta, lam, l1)
    beta_new = prox_newton_step(beta, global_h.to(torch.float64),
                                global_g.to(torch.float64), lam, l1)
    grad_norm = torch.linalg.vector_norm(global_g.to(torch.float64))
    step_norm = torch.linalg.vector_norm(beta_new - beta)
    return beta_new, obj, grad_norm, step_norm


class SecureFitDriver:
    """Stepwise Algorithm 1 with membership, liveness and crash-resume.

    * ``step()`` — one secure Newton round over the currently-responding
      institutions (online and under ``deadline``), revealed from the
      live centers' evaluation points.  An unrunnable round raises
      ``RuntimeError`` and leaves the fit state untouched.
    * ``state_dict()``/``load_state_dict()`` — resume after a crash; the
      generator state takes the place of the JAX key.
    * liveness hooks — ``set_online``/``set_latency``/``get_latency``
      per institution name, ``set_center_online`` per evaluation point, and
      ``_midround_hooks`` (one-shot callables fired between protect and
      reveal): >= t surviving centers reveal bit-identically, fewer abort
      the round.

    ``device=None`` runs on the CUDA card (raising without one); parts
    are moved there once, without a copy when they already live there.
    """

    def __init__(
        self,
        parts: Sequence[tuple],
        lam: float = 1.0,
        tol: float = 1e-10,
        max_iter: int = 50,
        protect: str = "gradient",
        aggregator: SecureCollective | None = None,
        seed: int = 0,
        l1: float = 0.0,
        fused: bool | None = None,
        names: Sequence[str] | None = None,
        deadline: float | None = None,
        min_responders: int = 1,
        rounds: str = "step",
        rounds_per_sync: int | None = None,
        summaries_backend: str | None = None,
        device=None,
    ):
        if protect not in PROTECT_CHOICES:
            raise ValueError(f"protect must be one of {PROTECT_CHOICES}")
        if rounds not in ("step", "scan"):
            raise ValueError("rounds must be 'step' or 'scan'")
        self.device = resolve_device(device)
        self.agg = aggregator or SecureCollective()
        if fused is None:
            fused = self.agg.backend == "kernel"
        if fused and self.agg.backend != "kernel":
            raise ValueError(
                "fused secure_fit requires the kernel backend (the flat "
                "share buffers ARE its wire format); use fused=False with "
                "backend='reference'"
            )
        if rounds == "scan" and not fused:
            raise ValueError(
                "rounds='scan' requires the fused kernel path (a scan slot "
                "IS the fused iteration); use rounds='step' with "
                "fused=False for the loop oracle"
            )
        if rounds_per_sync is not None and rounds_per_sync < 1:
            raise ValueError("rounds_per_sync must be >= 1 (or None for "
                             "one scan block per fit)")
        self.fused = fused
        self.rounds = rounds
        self.rounds_per_sync = rounds_per_sync
        if summaries_backend is None:
            summaries_backend = "kernel"
        if summaries_backend not in SUMMARY_BACKENDS:
            raise ValueError(
                f"summaries_backend must be one of {SUMMARY_BACKENDS}"
            )
        self.summaries_backend = summaries_backend
        self.parts = [(_as_f64(X, self.device), _as_f64(y, self.device))
                      for X, y in parts]
        self.names = (list(names) if names is not None
                      else [f"inst{j}" for j in range(len(self.parts))])
        if len(self.names) != len(self.parts):
            raise ValueError("names must match parts 1:1")
        self.lam = lam
        self.tol = tol
        self.max_iter = max_iter
        self.protect = protect
        self.l1 = float(l1)
        self.seed = seed
        self.deadline = deadline
        self.min_responders = min_responders
        self.dim = self.parts[0][0].shape[1]
        self.online = [True] * len(self.parts)
        self.latency = [0.0] * len(self.parts)
        self.centers_online = [True] * self.agg.scheme.num_shares
        self._midround_hooks: list[Callable[[], None]] = []
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.beta = torch.zeros((self.dim,), dtype=torch.float64,
                                device=self.device)
        self._round_base = 0
        self.iteration = 0
        self.trace: list[float] = []
        self.reports: list[RoundReport] = []
        self._obj_prev = np.inf
        self.converged = False
        self._last_round_metrics: tuple[float, float] | None = None
        self.central_seconds = 0.0
        self.total_seconds = 0.0
        self.bytes_transmitted = 0

    # -- liveness hooks -----------------------------------------------------
    def _idx(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError(f"unknown institution {name!r}") from None

    def set_online(self, name: str, up: bool):
        self.online[self._idx(name)] = bool(up)

    def set_latency(self, name: str, latency: float):
        self.latency[self._idx(name)] = float(latency)

    def get_latency(self, name: str) -> float:
        return self.latency[self._idx(name)]

    def set_center_online(self, index: int, up: bool):
        if not (1 <= index <= len(self.centers_online)):
            raise ValueError(f"no center at evaluation point {index}")
        self.centers_online[index - 1] = bool(up)

    def cohort_indices(self) -> list[int]:
        """Current-round responders: online and under the deadline."""
        ok = [
            j for j in range(len(self.parts))
            if self.online[j]
            and (self.deadline is None or self.latency[j] <= self.deadline)
        ]
        if len(ok) < self.min_responders:
            raise RuntimeError(
                f"only {len(ok)} responders < min {self.min_responders}"
            )
        return ok

    def live_points(self) -> tuple[int, ...] | None:
        """Live centers' evaluation points (None when nothing is shared)."""
        if self.protect == "none":
            return None
        pts = tuple(i + 1 for i, up in enumerate(self.centers_online) if up)
        t = self.agg.scheme.threshold
        if len(pts) < t:
            raise RuntimeError(
                f"{len(pts)} centers < threshold {t}; "
                "aggregate unrecoverable this round"
            )
        return pts

    def _post_protect_points(self, points):
        """Fire the one-shot mid-round hooks, then re-derive the reveal
        points from the centers STILL online (below t raises)."""
        hooks, self._midround_hooks = self._midround_hooks, []
        for h in hooks:
            h()
        if points is None:
            return None
        return self.live_points()

    # -- one Newton round ---------------------------------------------------
    @_traced("newton")
    def step(self) -> RoundReport:
        if self.rounds == "scan":
            # in scan mode a supervised "round" is one block; a raise inside
            # leaves all fit state unmutated, as a failed step does
            reports = self.step_block()
            if reports:
                return reports[-1]
            if self.reports:  # stepped past convergence: nothing executed
                return self.reports[-1]
            raise RuntimeError("scan block executed no rounds")
        # validate the round BEFORE mutating any fit state
        cohort = self.cohort_indices()
        points = self.live_points()
        parts = [self.parts[j] for j in cohort]
        in_cohort = set(cohort)
        stragglers = [
            self.names[j] for j in range(len(self.parts))
            if self.online[j] and j not in in_cohort
        ]
        num_live = None if points is None else len(points)
        nbytes = self.agg.round_bytes(
            self.dim, len(parts), self.protect, num_live_centers=num_live,
        )
        if self.fused:
            obj, make_beta_new = self._round_fused(parts, points)
        else:
            obj, make_beta_new = self._round_loop(parts, points)
        # ---- the round is known-good: mutate state
        self.iteration += 1
        self.trace.append(obj)
        self.bytes_transmitted += nbytes
        if should_stop_host(self._obj_prev, obj, self.tol, len(parts),
                            self.agg.codec.scale):
            self.converged = True
        else:
            self._obj_prev = obj
            self.beta = make_beta_new()
        gn, sn = self._last_round_metrics or (0.0, 0.0)
        report = RoundReport(
            self.iteration,
            [self.names[j] for j in cohort],
            stragglers,
            list(points or ()),
            obj,
            nbytes,
            grad_norm=gn,
            step_norm=sn,
        )
        self.reports.append(report)
        _metrics.observe_round(
            "secure_fit", nbytes, objective=obj,
            grad_norm=gn if self._last_round_metrics else None,
            step_norm=sn if self._last_round_metrics else None,
        )
        return report

    def _round_loop(self, parts, points):
        """The per-institution oracle walk (Algorithm 1 steps 3-16)."""
        self._last_round_metrics = None
        locals_: list[LocalSummaries] = [
            local_summaries(self.beta, Xj, yj) for Xj, yj in parts
        ]
        protected, plain = [], []
        for s in locals_:
            tree = _protected_tree(self.protect, s.hessian, s.gradient,
                                   s.deviance)
            protected.append(self.agg.protect(self.generator, tree)
                             if tree else {})
            plain.append({
                k: v for k, v in s._asdict().items()
                if k not in tree and k != "count"
            })

        # ---- centralized phase (Computation Centers, steps 11-16)
        t0 = time.perf_counter()
        revealed = {}
        if self.protect != "none":
            agg_protected = self.agg.aggregate(protected)
            pts = self._post_protect_points(points)
            if len(pts) < self.agg.scheme.num_shares:
                # non-contiguous survivor subset: slice the share axis to
                # the live points and reveal from them explicitly
                sel = torch.tensor([p - 1 for p in pts], device=self.device)
                revealed = self.agg.reveal(_select_holders(agg_protected,
                                                           sel),
                                           points=list(pts))
            else:
                revealed = self.agg.reveal(agg_protected)
        else:
            self._post_protect_points(points)
        summed_plain = {
            k: sum(pl[k] for pl in plain) for k in plain[0]
        } if plain and plain[0] else {}
        global_h = revealed.get("hessian", summed_plain.get("hessian"))
        global_g = revealed.get("gradient", summed_plain.get("gradient"))
        global_dev = revealed.get("deviance", summed_plain.get("deviance"))
        obj = float(regularized_objective(global_dev, self.beta, self.lam,
                                          self.l1))
        self.central_seconds += time.perf_counter() - t0

        def make_beta_new():
            t1 = time.perf_counter()
            beta_new = prox_newton_step(
                self.beta, global_h.to(torch.float64),
                global_g.to(torch.float64), self.lam, self.l1,
            )
            self.central_seconds += time.perf_counter() - t1
            return beta_new

        return obj, make_beta_new

    def _round_fused(self, parts, points):
        """One fused iteration: one launch per phase, one host sync.

        The fused round has no host point between protect and reveal, so
        the mid-round hooks fire (and the reveal points re-derive) just
        before it — exact for the revealed values, since reconstruction
        from any >= t points is the same field arithmetic.
        """
        packed = pack_partitions(parts)
        pts = self._post_protect_points(points)
        if pts is not None and len(pts) == self.agg.scheme.num_shares:
            pts = None  # all centers live: the default first-t reveal
        beta_new, obj, grad_norm, step_norm = _fused_secure_iteration(
            self.beta, self.generator, packed, self.lam, self.agg,
            self.protect, self.l1, points=pts,
            summaries_backend=self.summaries_backend,
        )
        # host-sync: the one readback per fused iteration
        obj, grad_norm, step_norm = torch.stack(
            [obj, grad_norm, step_norm]).tolist()
        self._last_round_metrics = (grad_norm, step_norm)
        return obj, lambda: beta_new

    # -- scan blocks -------------------------------------------------------
    @_traced("newton")
    def step_block(self, num_rounds: int | None = None
                   ) -> list[RoundReport]:
        """Up to ``num_rounds`` fused rounds as one block with one trace
        read-back (``core/scanfit.py``), from which the per-round
        ``RoundReport`` records are rebuilt.

        The cohort and live reveal points are frozen for the block; the
        mid-round hooks fire before it runs, and a below-threshold block
        raises with all fit state unmutated.  Default length:
        ``rounds_per_sync``, or the fit's remaining ``max_iter`` budget.
        """
        if self.rounds != "scan":
            raise RuntimeError("step_block requires rounds='scan'")
        from .scanfit import run_fit_block

        cohort = self.cohort_indices()
        points = self.live_points()
        parts = [self.parts[j] for j in cohort]
        in_cohort = set(cohort)
        stragglers = [
            self.names[j] for j in range(len(self.parts))
            if self.online[j] and j not in in_cohort
        ]
        num_live = None if points is None else len(points)
        nbytes = self.agg.round_bytes(
            self.dim, len(parts), self.protect, num_live_centers=num_live,
        )
        if num_rounds is None:
            num_rounds = self.rounds_per_sync or max(
                self.max_iter - self.iteration, 1)
        pts = self._post_protect_points(points)
        if pts is not None and len(pts) == self.agg.scheme.num_shares:
            pts = None  # all centers live: the default first-t reveal
        reports = run_fit_block(
            self, pack_partitions(parts), pts, num_rounds, self.l1, False,
            nbytes, ([self.names[j] for j in cohort], stragglers,
                     list(points or ())), "secure_fit_scan",
        )
        self.bytes_transmitted += nbytes * len(reports)
        return reports

    def run(self, max_iter: int | None = None) -> FitResult:
        limit = self.max_iter if max_iter is None else max_iter
        t_total = time.perf_counter()
        while not self.converged and self.iteration < limit:
            if self.rounds == "scan":
                block = self.rounds_per_sync or (limit - self.iteration)
                self.step_block(min(block, limit - self.iteration))
            else:
                self.step()
        self.total_seconds += time.perf_counter() - t_total
        return self.result()

    def result(self) -> FitResult:
        return FitResult(
            self.beta.cpu().numpy(), self.iteration, self.converged,
            list(self.trace), central_seconds=self.central_seconds,
            total_seconds=self.total_seconds,
            bytes_transmitted=self.bytes_transmitted,
        )

    # -- checkpointing ------------------------------------------------------
    def state_dict(self) -> dict:
        """Everything needed to resume after a crash (numpy values)."""
        return {
            "beta": self.beta.cpu().numpy(),
            "iteration": np.asarray(self.iteration),
            "obj_prev": np.asarray(self._obj_prev),
            "trace": np.asarray(self.trace),
            "rng_state": self.generator.get_state().numpy(),
            "converged": np.asarray(self.converged),
            "bytes": np.asarray(self.bytes_transmitted),
            "online": np.asarray(self.online),
            "latency": np.asarray(self.latency),
            "centers_online": np.asarray(self.centers_online),
            "round_base": np.asarray(self._round_base),
            "seed": np.asarray(self.seed),
        }

    def load_state_dict(self, state: dict):
        """Restore a ``state_dict``.  Without ``rng_state`` (a state
        carried over from the JAX package) the generator is reseeded from
        the driver's seed: reveals do not depend on the sharing
        randomness, so the fit continues on the same trajectory.  The
        saved ``seed``, where present, replaces the driver's, so scan
        rounds draw from the same ``round_key`` stream."""
        if "seed" in state:
            self.seed = int(state["seed"])
        self.beta = torch.tensor(np.asarray(state["beta"]),
                                 dtype=torch.float64, device=self.device)
        self.iteration = int(state["iteration"])
        self._obj_prev = float(state["obj_prev"])
        self.trace = [float(x) for x in state["trace"]]
        if "rng_state" in state:
            self.generator.set_state(
                torch.as_tensor(state["rng_state"], dtype=torch.uint8))
        else:
            self.generator.manual_seed(self.seed)
        self.converged = bool(state["converged"])
        self.bytes_transmitted = int(state.get("bytes", 0))
        if "online" in state:
            self.online = [bool(v) for v in state["online"]]
        if "latency" in state:
            self.latency = [float(v) for v in state["latency"]]
        if "centers_online" in state:
            self.centers_online = [bool(v) for v in state["centers_online"]]
        self._round_base = int(state.get("round_base", state["iteration"]))


def _select_holders(protected, sel: torch.Tensor):
    """Slice the holder (leading) axis of a protected tree or buffer."""
    if isinstance(protected, FlatProtected):
        return FlatProtected(protected.buf[sel], protected.layout)
    leaves, treedef = tree_flatten(protected)
    return tree_unflatten(treedef, [l[sel] for l in leaves])


def secure_fit(
    parts: Sequence[tuple],
    lam: float = 1.0,
    tol: float = 1e-10,
    max_iter: int = 50,
    protect: str = "gradient",
    aggregator: SecureCollective | None = None,
    seed: int = 0,
    l1: float = 0.0,
    fused: bool | None = None,
    rounds: str = "step",
    rounds_per_sync: int | None = None,
    summaries_backend: str | None = None,
    device=None,
) -> FitResult:
    """Paper Algorithm 1 over S institutions' (X_j, y_j) partitions.

    ``protect`` selects the paper's pragmatic mode: "both" is the fully
    encrypted setting, "gradient"/"hessian" protect one of the two
    summaries known attacks need, "none" is the plain-exchange baseline.

    ``fused=None`` auto-selects: the kernel backend runs the batched
    iteration (one kernel launch per phase, one host sync per iteration);
    the reference backend runs the per-institution loop (the oracle).
    ``rounds="scan"`` runs the fused rounds in blocks of
    ``rounds_per_sync`` (None: the whole fit as one block).  This is the
    one-call form of :class:`SecureFitDriver`.
    """
    driver = SecureFitDriver(
        parts, lam=lam, tol=tol, max_iter=max_iter, protect=protect,
        aggregator=aggregator, seed=seed, l1=l1, fused=fused, rounds=rounds,
        rounds_per_sync=rounds_per_sync, summaries_backend=summaries_backend,
        device=device,
    )
    return driver.run()
