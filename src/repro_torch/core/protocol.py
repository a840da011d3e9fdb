"""Algorithm 1 as an explicit multi-party protocol with failure handling.

``newton.secure_fit`` is the compact in-process form; this module models
the *deployment* shape: Institution and ComputationCenter objects
exchanging messages through a coordinator, with the fault tolerance a
large fleet needs:

* **Straggler mitigation** — each round has a deadline; institutions that
  miss it are left out of that round's aggregate and rejoin next round.
* **Center failure tolerance** — Shamir t-of-w: any t of the w centers
  reconstruct, so up to w - t centers may be down in a round.
* **Elastic membership** — institutions join and leave between rounds;
  the coordinator re-forms the cohort each round.
* **Checkpoint/restart** — protocol state serializes to a dict of numpy
  values.

Timing is simulated (per-institution latencies), so straggler logic is
deterministic and testable without sleeps.

Three execution shapes for a round:

* **loop** (default) — the paper-shaped walk over Institution /
  ComputationCenter objects: one ``local_summaries`` and one protect per
  institution, explicit share slices at each center.  The oracle.
* **fused** (kernel backend) — the cohort's partitions pack once into
  the (S, N_max, d) layout and the round runs as the fused ``secure_fit``
  iteration (K3 or the reference summaries, K1, one int64 sum, K2,
  Newton update), revealed from the *live* centers' points.
* **scan** (``rounds="scan"`` with ``fused=True``) — blocks of fused
  rounds through ``core/scanfit.py``, one trace read-back per block.

Every shape draws its sharing polynomials from ``torch.Generator`` s on
the coordinator's device; reveals do not depend on them.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..obs import metrics as _metrics
from ..obs.trace import traced as _traced
from .batched_summaries import (
    BACKENDS as SUMMARY_BACKENDS,
    pack_cache_evict,
    pack_partitions,
)
from .collective import FlatProtected, SecureCollective, _fold_sum_streaming
from .flatbuf import tree_flatten, tree_unflatten
from .logreg import local_summaries
from .newton import (
    RoundReport,
    _fused_secure_iteration,
    newton_step,
    regularized_objective,
    should_stop_host,
)

__all__ = ["Institution", "ComputationCenter", "StudyCoordinator",
           "RoundReport"]


def _map_shares(fn, *trees):
    """Apply ``fn`` leafwise across share trees or ``FlatProtected``s."""
    if isinstance(trees[0], FlatProtected):
        return FlatProtected(fn(*(t.buf for t in trees)), trees[0].layout)
    flat = [tree_flatten(t)[0] for t in trees]
    treedef = tree_flatten(trees[0])[1]
    return tree_unflatten(treedef, [fn(*ls) for ls in zip(*flat)])


@dataclasses.dataclass(eq=False)
class Institution:
    """One data-holding party.  Owns (X, y); never exports them."""

    name: str
    X: torch.Tensor
    y: torch.Tensor
    # simulated response latency (seconds) used for straggler decisions
    latency: float = 0.0
    online: bool = True

    def compute_and_protect(self, beta, protect: str, agg: SecureCollective,
                            generator: torch.Generator):
        s = local_summaries(beta, self.X, self.y)
        count = torch.as_tensor(s.count, dtype=torch.float64,
                                device=beta.device)
        tree = {"deviance": s.deviance, "count": count}
        if protect in ("gradient", "both"):
            tree["gradient"] = s.gradient
        if protect in ("hessian", "both"):
            tree["hessian"] = s.hessian
        plain = {}
        if protect in ("none", "gradient"):
            plain["hessian"] = s.hessian
        if protect in ("none", "hessian"):
            plain["gradient"] = s.gradient
        if protect == "none":
            plain["deviance"] = s.deviance
            plain["count"] = count
            return {}, plain
        return agg.protect(generator, tree), plain


@dataclasses.dataclass(eq=False)
class ComputationCenter:
    """Holds one share slice of every protected submission."""

    index: int  # 1-based Shamir evaluation point
    online: bool = True
    _stash: list = dataclasses.field(default_factory=list)

    def receive(self, share_slice):
        self._stash.append(share_slice)

    @_traced("aggregate")
    def aggregate_local(self, field):
        """Algorithm 2 at this center: share-wise sum of its slices with a
        running int64 accumulator and one trailing mod."""
        if len(self._stash) == 1:
            return self._stash[0]
        acc = _map_shares(
            lambda *xs: _fold_sum_streaming(xs, field, residue_axis=0),
            *self._stash)
        self._stash = [acc]
        return acc

    def clear(self):
        self._stash = []


@functools.lru_cache(maxsize=64)
def _round_bytes(d: int, cohort_size: int, protect: str,
                 agg: SecureCollective, num_live_centers: int) -> int:
    """Per-round wire bytes from static shapes alone: the one
    ``SecureCollective.round_bytes`` model with the coordinator's two
    deltas — the protected tree carries the ``count`` leaf, and each
    online center receives a 1/w slice of the share buffer."""
    return agg.round_bytes(
        d, cohort_size, protect, include_count=True,
        num_live_centers=num_live_centers,
    )


class StudyCoordinator:
    """Drives Algorithm 1 across institutions + centers, fault-tolerantly.

    ``device=None`` runs on the CUDA card (raising without one); each
    institution's (X, y) moves there once, as float64.
    """

    def __init__(
        self,
        institutions: Sequence[Institution],
        lam: float = 1.0,
        protect: str = "gradient",
        aggregator: SecureCollective | None = None,
        num_centers: int | None = None,
        deadline: float | None = None,
        min_responders: int = 1,
        tol: float = 1e-10,
        seed: int = 0,
        fused: bool = False,
        summaries_backend: str | None = None,
        rounds: str = "step",
        rounds_per_sync: int | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.institutions = [self._on_device(i) for i in institutions]
        self.lam = lam
        self.protect = protect
        self.agg = aggregator or SecureCollective()
        if fused and self.agg.backend != "kernel":
            raise ValueError(
                "fused coordinator rounds require the kernel backend (the "
                "flat share buffers ARE the batched wire format); use "
                "fused=False with backend='reference'"
            )
        self.fused = fused
        if rounds not in ("step", "scan"):
            raise ValueError("rounds must be 'step' or 'scan'")
        if rounds == "scan" and not fused:
            raise ValueError(
                "rounds='scan' requires fused=True (a scan slot IS the "
                "fused cohort round); the loop path stays per-round"
            )
        if rounds_per_sync is not None and rounds_per_sync < 1:
            raise ValueError("rounds_per_sync must be >= 1 (or None for "
                             "one scan block per run)")
        self.rounds = rounds
        self.rounds_per_sync = rounds_per_sync
        # "reference" (default): float64 summaries, per-round beta parity
        # with the loop oracle; "kernel"/"mixed": the float32-Gram rungs,
        # converged-beta parity only (the fused secure_fit contract)
        if summaries_backend is None:
            summaries_backend = "reference"
        if summaries_backend not in SUMMARY_BACKENDS:
            raise ValueError(
                f"summaries_backend must be one of {SUMMARY_BACKENDS}"
            )
        self.summaries_backend = summaries_backend
        # Fewer centers than shares is allowed: the remaining evaluation
        # points stay FREE for ``provision_center``.  More centers than
        # shares is impossible, and fewer than t never reconstruct.
        w = self.agg.scheme.num_shares
        n_centers = w if num_centers is None else num_centers
        if not (self.agg.scheme.threshold <= n_centers <= w):
            raise ValueError(
                f"num_centers must lie in [threshold="
                f"{self.agg.scheme.threshold}, num_shares={w}] (points "
                "beyond num_centers stay free for re-provisioning)"
            )
        self.centers = [ComputationCenter(i + 1) for i in range(n_centers)]
        # one-shot callables fired between protect and reveal of the next
        # round: center death inside a round
        self._midround_hooks: list[Callable[[], None]] = []
        self.deadline = deadline
        self.min_responders = min_responders
        self.tol = tol
        self.seed = seed
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        d = self.institutions[0].X.shape[1]
        self.beta = torch.zeros((d,), dtype=torch.float64,
                                device=self.device)
        # scan-mode round slot counter (executed and skipped slots both
        # advance it): checkpointed for mid-block resume
        self._round_base = 0
        self.iteration = 0
        self.trace: list[float] = []
        self.reports: list[RoundReport] = []
        self._obj_prev = np.inf
        self.converged = False
        # (grad_norm, step_norm) from the last fused round's read-back;
        # None on the loop path
        self._last_round_metrics: tuple[float, float] | None = None

    def _on_device(self, inst: Institution) -> Institution:
        inst.X = torch.as_tensor(inst.X, dtype=torch.float64,
                                 device=self.device)
        inst.y = torch.as_tensor(inst.y, dtype=torch.float64,
                                 device=self.device)
        return inst

    # -- fault/elasticity hooks ----------------------------------------------
    def cohort(self) -> list[Institution]:
        """Current-round responders: online and under the deadline."""
        ok = [i for i in self.institutions if i.online
              and (self.deadline is None or i.latency <= self.deadline)]
        if len(ok) < self.min_responders:
            raise RuntimeError(
                f"only {len(ok)} responders < min {self.min_responders}"
            )
        return ok

    def live_centers(self) -> list[ComputationCenter]:
        up = [c for c in self.centers if c.online]
        if len(up) < self.agg.scheme.threshold:
            raise RuntimeError(
                f"{len(up)} centers < threshold {self.agg.scheme.threshold}; "
                "aggregate unrecoverable this round"
            )
        return up

    def add_institution(self, inst: Institution):
        # churn invalidation: no later cohort may reuse a padded batch
        # built around this institution's tensors
        self._on_device(inst)
        pack_cache_evict([(inst.X, inst.y)])
        self.institutions.append(inst)

    def remove_institution(self, name: str):
        gone = [i for i in self.institutions if i.name == name]
        self.institutions = [i for i in self.institutions if i.name != name]
        pack_cache_evict([(i.X, i.y) for i in gone])

    def provision_center(self, index: int | None = None) -> ComputationCenter:
        """Bring up a replacement or additional Computation Center.

        With no ``index``, prefer a FRESH evaluation point (one of 1..w not
        assigned to any center), whose share slice was never sent to a
        failed node; else replace the lowest-indexed dead center in place.
        Every round shares fresh polynomials, so a replacement learns
        nothing about earlier rounds.
        """
        w = self.agg.scheme.num_shares
        used = {c.index for c in self.centers}
        if index is None:
            free = [p for p in range(1, w + 1) if p not in used]
            if free:
                index = free[0]
            else:
                dead = [c.index for c in self.centers if not c.online]
                if not dead:
                    raise RuntimeError(
                        "no free evaluation point and no dead center to "
                        "replace"
                    )
                index = min(dead)
        if not (1 <= index <= w):
            raise ValueError(f"evaluation point must be in 1..{w}")
        fresh = ComputationCenter(index)
        if index in used:
            old = next(c for c in self.centers if c.index == index)
            if old.online:
                raise RuntimeError(
                    f"center at point {index} is still online; refusing to "
                    "replace it"
                )
            self.centers[self.centers.index(old)] = fresh
        else:
            self.centers.append(fresh)
            self.centers.sort(key=lambda c: c.index)
        return fresh

    def _fire_midround_hooks(self):
        hooks, self._midround_hooks = self._midround_hooks, []
        for h in hooks:
            h()

    # -- one Newton round -----------------------------------------------------
    @_traced("newton")
    def step(self, fused: bool | None = None) -> RoundReport:
        """One secure Newton round.  ``fused=None`` uses the constructor
        setting; an explicit value overrides it for this round only."""
        use_fused = self.fused if fused is None else fused
        if use_fused and self.agg.backend != "kernel":
            raise ValueError(
                "fused coordinator rounds require the kernel backend"
            )
        if self.rounds == "scan" and use_fused:
            # a supervised "round" in scan mode is one block; a raise
            # inside leaves all round state unmutated
            reports = self.step_block()
            if reports:
                return reports[-1]
            if self.reports:  # stepped past convergence
                return self.reports[-1]
            raise RuntimeError("scan block executed no rounds")
        # validate the round BEFORE mutating any state, so a failed round
        # leaves iteration/trace/beta exactly as they were
        cohort = self.cohort()
        if self.protect != "none":
            self.live_centers()
        stragglers = [i.name for i in self.institutions
                      if i.online and i not in cohort]
        # bytes are accounted at protect time: a center that dies between
        # protect and reveal already received its slice this round
        num_live = sum(1 for c in self.centers if c.online)
        nbytes = _round_bytes(cohort[0].X.shape[1], len(cohort),
                              self.protect, self.agg, num_live)
        if use_fused:
            obj, make_beta_new = self._round_fused(cohort)
        else:
            obj, make_beta_new = self._round_loop(cohort)
        return self._finish_round(obj, make_beta_new, cohort, stragglers,
                                  nbytes)

    def _round_loop(self, cohort):
        """The per-institution oracle walk (paper-shaped deployment)."""
        self._last_round_metrics = None
        for c in self.centers:
            c.clear()
        plains, submissions = [], []
        for inst in cohort:
            shares, plain = inst.compute_and_protect(
                self.beta, self.protect, self.agg, self.generator)
            plains.append(plain)
            if shares:
                submissions.append(shares)
                for center in self.centers:
                    if not center.online:
                        continue  # lost share slice; t-of-w absorbs it
                    # slice by the center's own evaluation point: after
                    # re-provisioning the point set may be non-contiguous
                    center.receive(_map_shares(
                        lambda s, i=center.index - 1: s[i], shares))

        # center death BETWEEN protect and reveal: the hooks flip liveness
        # after the slices went out; >= t survivors reveal bit-identically
        self._fire_midround_hooks()

        revealed = {}
        if self.protect != "none" and submissions:
            up = self.live_centers()
            agg_slices = [c.aggregate_local(self.agg.scheme.field)
                          for c in up]
            stacked = _map_shares(lambda *xs: torch.stack(xs), *agg_slices)
            revealed = self.agg.reveal(stacked, points=[c.index for c in up])

        plain_sum = {
            k: sum(pl[k] for pl in plains) for k in plains[0]
        } if plains and plains[0] else {}
        merged = {**plain_sum, **revealed}
        H = merged["hessian"].to(torch.float64)
        g = merged["gradient"].to(torch.float64)
        # the fused graph's objective expression: the loop and fused
        # drivers compare bit-identical floats in the stopping rule
        obj = float(regularized_objective(merged["deviance"], self.beta,
                                          self.lam))
        return obj, lambda: newton_step(self.beta, H, g, self.lam)

    def _round_fused(self, cohort):
        """Cohort-level batched round: one launch per phase, one sync.

        The fused round has no host point between protect and reveal, so
        the mid-round hooks fire first and the reveal points come from the
        survivors; below threshold it raises the loop path's error.
        """
        self._fire_midround_hooks()
        points = (tuple(c.index for c in self.live_centers())
                  if self.protect != "none" else None)
        packed = pack_partitions([(i.X, i.y) for i in cohort])
        beta_new, obj, grad_norm, step_norm = _fused_secure_iteration(
            self.beta, self.generator, packed, self.lam, self.agg,
            self.protect, 0.0, points=points, include_count=True,
            summaries_backend=self.summaries_backend,
        )
        with _metrics.host_read("coordinator",
                                "StudyCoordinator._round_fused"):
            # host-sync: the round's one read-back
            obj, grad_norm, step_norm = torch.stack(
                [obj, grad_norm, step_norm]).tolist()
        self._last_round_metrics = (grad_norm, step_norm)
        return obj, lambda: beta_new

    # -- scan blocks ----------------------------------------------------------
    @_traced("newton")
    def step_block(self, num_rounds: int | None = None
                   ) -> list[RoundReport]:
        """Up to ``num_rounds`` fused cohort rounds as one block.

        One trace read-back through ``scanfit.run_fit_block``, as
        ``SecureFitDriver.step_block`` does.  The cohort and live
        centers are frozen for the block; mid-round hooks fire before it
        runs, and a below-threshold block raises with all round state
        unmutated.  Default length: ``rounds_per_sync``, or what is left
        of ``run()``'s default budget of 50.
        """
        if self.rounds != "scan":
            raise RuntimeError("step_block requires rounds='scan'")
        from .scanfit import run_fit_block

        cohort = self.cohort()
        if self.protect != "none":
            self.live_centers()
        stragglers = [i.name for i in self.institutions
                      if i.online and i not in cohort]
        num_live = sum(1 for c in self.centers if c.online)
        nbytes = _round_bytes(cohort[0].X.shape[1], len(cohort),
                              self.protect, self.agg, num_live)
        if num_rounds is None:
            num_rounds = self.rounds_per_sync or max(50 - self.iteration, 1)
        self._fire_midround_hooks()
        points = (tuple(c.index for c in self.live_centers())
                  if self.protect != "none" else None)
        return run_fit_block(
            self, pack_partitions([(i.X, i.y) for i in cohort]), points,
            num_rounds, 0.0, True, nbytes,
            ([i.name for i in cohort], stragglers,
             [c.index for c in self.centers if c.online]),
            "coordinator_scan",
        )

    def _finish_round(self, obj, make_beta_new, cohort, stragglers,
                      nbytes) -> RoundReport:
        """Convergence bookkeeping shared by the loop and fused rounds:
        the ONLY place round state mutates."""
        self.iteration += 1
        self.trace.append(obj)
        if should_stop_host(self._obj_prev, obj, self.tol, len(cohort),
                            self.agg.codec.scale):
            self.converged = True
        else:
            self._obj_prev = obj
            self.beta = make_beta_new()
        gn, sn = self._last_round_metrics or (0.0, 0.0)
        report = RoundReport(
            self.iteration, [i.name for i in cohort], stragglers,
            [c.index for c in self.centers if c.online], obj, nbytes,
            grad_norm=gn, step_norm=sn,
        )
        self.reports.append(report)
        _metrics.observe_round(
            "coordinator", nbytes, objective=obj,
            grad_norm=gn if self._last_round_metrics else None,
            step_norm=sn if self._last_round_metrics else None,
        )
        return report

    def run(self, max_iter: int = 50) -> np.ndarray:
        while not self.converged and self.iteration < max_iter:
            if self.rounds == "scan" and self.fused:
                block = self.rounds_per_sync or (max_iter - self.iteration)
                self.step_block(min(block, max_iter - self.iteration))
            else:
                self.step()
        return self.beta.cpu().numpy()

    # -- checkpointing --------------------------------------------------------
    def state_dict(self) -> dict:
        """Everything needed to resume (numpy values); the generator state
        and seed take the place of the JAX key."""
        return {
            "beta": self.beta.cpu().numpy(),
            "iteration": np.asarray(self.iteration),
            "obj_prev": np.asarray(self._obj_prev),
            "trace": np.asarray(self.trace),
            "rng_state": self.generator.get_state().numpy(),
            "seed": np.asarray(self.seed),
            "converged": np.asarray(self.converged),
            "round_base": np.asarray(self._round_base),
        }

    def load_state_dict(self, state: dict):
        """Restore a ``state_dict``.  A state carried over from the JAX
        package has no ``rng_state``; the generator is then reseeded (the
        reveals, and so the trajectory, do not depend on it)."""
        self.beta = torch.tensor(np.asarray(state["beta"]),
                                 dtype=torch.float64, device=self.device)
        self.iteration = int(state["iteration"])
        self._obj_prev = float(state["obj_prev"])
        self.trace = [float(x) for x in state["trace"]]
        if "seed" in state:
            self.seed = int(state["seed"])
        if "rng_state" in state:
            self.generator.set_state(
                torch.as_tensor(state["rng_state"], dtype=torch.uint8))
        else:
            self.generator.manual_seed(self.seed)
        self.converged = bool(state["converged"])
        # pre-scan checkpoints: slots == executed rounds in step mode
        self._round_base = int(state.get("round_base", state["iteration"]))
