"""Deployment-shaped driver for the secure model-selection sweep.

``SelectionCoordinator`` wraps a ``StudyCoordinator`` — its cohort
formation (stragglers, elastic membership), live-center accounting, churn
hooks and checkpoint conventions — and drives the chunked λ-path sweep
(``PathDriver``) across whatever cohort is present at each chunk boundary:

* **churn-safe folds** — fold membership is a function of the
  institution's *name* (``selection.folds``), so institutions that join,
  leave or straggle between chunks never perturb anyone else's folds.
  Each institution's fold ids are drawn once, when it first joins a
  chunk, and kept by name for the rest of the path.
* **mid-path resume** — ``state_dict``/``load_state_dict`` round-trip the
  whole sweep state (chunk cursor, warm-start betas, accumulated CV
  aggregates, round slot counter) and the fold ids (``folds_<name>``),
  so a continued path stays on the folds it started on.  Round r's
  shares come from ``round_key(seed, r)``, so a resumed sweep replays
  bit-identically.
* **secure CV metrics end to end** — per-institution held-out deviance
  and accuracy travel only as Shamir shares inside the multi-config
  buffer; the coordinator learns the cross-institution sums only.
* **telemetry from static shapes** — bytes per round from the one size
  model the round protocols use.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.collective import SecureCollective
from ..core.protocol import Institution, StudyCoordinator
from ..obs.trace import traced as _traced
from .folds import assign_folds
from .path import PathDriver, PathSettings
from .report import PathReport

__all__ = ["SelectionCoordinator"]


class SelectionCoordinator:
    """Cross-validated λ selection over a fault-tolerant consortium.

    ``device=None`` runs on the CUDA card (raising without one).
    """

    def __init__(
        self,
        institutions: Sequence[Institution],
        lambdas: Sequence[float],
        num_folds: int = 5,
        l1: float = 0.0,
        protect: str = "gradient",
        aggregator: SecureCollective | None = None,
        num_centers: int | None = None,
        deadline: float | None = None,
        min_responders: int = 1,
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
    ):
        agg = aggregator or SecureCollective(backend="kernel")
        self.settings = PathSettings(
            lambdas=tuple(sorted((float(l) for l in lambdas),
                                 reverse=True)),
            num_folds=num_folds, l1=float(l1), protect=protect, tol=tol,
            summaries_backend=summaries_backend, lam_block=lam_block,
            rounds_per_sync=rounds_per_sync, max_rounds=max_rounds,
            warm_start=warm_start, refit=refit, seed=seed,
            fold_seed=fold_seed,
        )
        # the wrapped deployment shape: cohort, straggler, center and
        # churn management all come from the StudyCoordinator
        self.study = StudyCoordinator(
            institutions, lam=self.settings.lambdas[0], protect=protect,
            aggregator=agg, num_centers=num_centers, deadline=deadline,
            min_responders=min_responders, tol=tol, seed=seed, fused=True,
            summaries_backend=summaries_backend, device=device,
        )
        # name -> (rows,) int32 CPU fold ids the path has used
        self.folds: dict[str, torch.Tensor] = {}
        self.driver = PathDriver(self.settings, self.study.agg)
        self.state = self.driver.fresh_state()
        self.traces: list = []
        self.report: PathReport | None = None

    # -- membership passthrough (fold-safe by construction) -------------------
    def add_institution(self, inst: Institution):
        self.study.add_institution(inst)

    def remove_institution(self, name: str):
        self.study.remove_institution(name)

    def provision_center(self, index: int | None = None):
        return self.study.provision_center(index)

    @property
    def num_chunks(self) -> int:
        return self.driver.num_chunks()

    @property
    def next_chunk(self) -> int:
        return int(self.state["next_chunk"])

    def finished(self) -> bool:
        return self.driver.finished(self.state)

    # -- the sweep ------------------------------------------------------------
    @_traced("selection")
    def step_chunk(self):
        """Advance the path by one λ chunk on the CURRENT cohort.

        Cohort and live centers are re-formed at every chunk boundary:
        stragglers and offline institutions sit out every round of this
        chunk (their folds untouched for when they return), and a
        below-threshold center set raises before any computation.  Armed
        mid-round center-death hooks fire at the same boundary.
        """
        cohort = self.study.cohort()
        self.study._fire_midround_hooks()
        if self.settings.protect != "none":
            points = tuple(c.index for c in self.study.live_centers())
            num_live = len(points)
        else:
            points, num_live = None, None
        fold_parts = [self._fold_ids(inst) for inst in cohort]
        self.state = self.driver.run_chunk(
            self.state, [(i.X, i.y) for i in cohort], fold_parts,
            points=points, num_live_centers=num_live, traces=self.traces,
        )

    def _fold_ids(self, inst: Institution) -> torch.Tensor:
        """The institution's fold ids: the ones the path already used for
        it, else a fresh ``assign_folds`` draw, kept from then on."""
        rows = inst.X.shape[0]
        ids = self.folds.get(str(inst.name))
        if ids is None:
            ids = assign_folds(rows, self.settings.num_folds, inst.name,
                               self.settings.fold_seed)
            self.folds[str(inst.name)] = ids
        elif len(ids) != rows:
            raise ValueError(
                f"institution {inst.name!r} has {rows} rows, but the "
                f"path's fold ids for it cover {len(ids)}")
        return ids

    def run_path(self) -> PathReport:
        """Run (or resume) the sweep to completion and build the report."""
        while not self.finished():
            self.step_chunk()
        self.report = self.driver.build_report(self.state, self.traces)
        # the selected model becomes the wrapped study's current iterate
        if self.report.beta is not None:
            self.study.beta = torch.as_tensor(
                self.report.beta, dtype=torch.float64,
                device=self.study.device)
            self.study.lam = self.report.lambda_1se
        return self.report

    # -- checkpoint/restart ---------------------------------------------------
    def state_dict(self) -> dict:
        # snapshot by copy: run_chunk mutates the sweep arrays in place
        out = {f"path_{k}": np.array(v) for k, v in self.state.items()}
        out.update(
            {f"study_{k}": v for k, v in self.study.state_dict().items()}
        )
        out.update({f"folds_{name}": ids.numpy().copy()
                    for name, ids in self.folds.items()})
        return out

    def load_state_dict(self, state: dict):
        """Restore a mid-path checkpoint.  The sweep state and the fold
        ids round-trip exactly; the per-block objective ``traces`` restart
        empty.  A checkpoint past its first chunk must carry the fold ids
        its finished chunks were measured on."""
        folds = {
            k[len("folds_"):]: torch.from_numpy(np.array(v, dtype=np.int32))
            for k, v in state.items() if k.startswith("folds_")
        }
        if int(state["path_next_chunk"]) > 0 and not folds:
            raise ValueError(
                "mid-path checkpoint without fold ids (folds_<name>): its "
                "finished chunks were measured on folds this run cannot "
                "redraw")
        self.folds = folds
        self.state = {
            k[len("path_"):]: np.array(v) for k, v in state.items()
            if k.startswith("path_")
        }
        self.study.load_state_dict({
            k[len("study_"):]: v for k, v in state.items()
            if k.startswith("study_")
        })
        self.traces = []
        self.report = None
