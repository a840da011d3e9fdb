"""The ``secure_cv_path`` entry: one whole secure cross-validated λ path a
job (the CV sweep, the 1-SE pick and its refit),
``repro_torch.secure_cv_path`` on the cell's institutions' rows.

The inputs are the institutions' rows drawn on the card from the seed
(``pbench/data.py``).  Every job runs the mix's whole λ grid with fold
and protocol seeds of its own, drawn from the seed.  A sample of the
window's paths is compared with the plain float64 reference
(``pbench/compare.py``'s path numbers).
"""
from __future__ import annotations

import itertools
import types

import numpy as np

from pbench import categories, compare, data, logreg, reference, traffic

CATEGORIES = categories.CATEGORIES
NUMBERS = compare.PATH_NUMBERS
COUNTS = compare.COUNTS
# the entry's keyword arguments (a mix's ``args``) whose answer the
# reference works out: settings of how the rounds run, not of what is
# fitted
MODELLED_ARGS = {"num_folds", "lam_block", "rounds_per_sync", "max_rounds",
                 "warm_start", "refit"}

make_inputs = data.make_parts
Program = logreg.Program


def jobs(mix: dict, seed: int, stream: int = 1):
    """Endless path jobs from ``seed``, each with its own protocol and
    fold seeds.  ``stream`` separates the warm-up's jobs from the
    window's."""
    grid = traffic.lambda_grid(mix)
    rng = np.random.default_rng(data.derive_seed(seed, stream))
    for i in itertools.count():
        yield {"index": i, "lambdas": grid,
               "seed": int(rng.integers(0, 2**62)),
               "fold_seed": int(rng.integers(0, 2**31))}


class Control(logreg.Control):
    """The reference path and refit in float32 with TF32 on."""

    def __call__(self, parts, job):
        low = self._low(parts)
        with reference.precision(self.dtype):
            cv = reference.cv_path(low, job["lambdas"],
                                   self.mix["args"]["num_folds"],
                                   job["fold_seed"], dtype=self.dtype)
            refit = reference.irls(low, job["lambdas"][cv.one_se_index],
                                   dtype=self.dtype)
        L, K = cv.val_deviance.shape
        kw = dict(include_count=True, extra_scalars=3)
        return types.SimpleNamespace(
            val_deviance=cv.val_deviance, val_count=cv.val_count,
            best_index=cv.best_index, one_se_index=cv.one_se_index,
            beta=refit.beta.double().cpu().numpy(),
            fold_rounds=np.ones((L, K), np.int32), refit_rounds=1,
            rounds_total=L + 1,
            bytes_total=L * reference.round_bytes(self.config, configs=K,
                                                  **kw)
            + reference.round_bytes(self.config, configs=1, **kw))


def control_jobs(mix: dict) -> int:
    """Paths a control runs for its readings: as many as a run compares."""
    return mix["sample_answers"]


def job_record(answer, seconds: float) -> dict:
    return {"seconds": seconds, "rounds": int(answer.rounds_total),
            "sweep_rounds": int(answer.rounds_total - answer.refit_rounds),
            "refit_rounds": int(answer.refit_rounds)}


def modelled(mix: dict) -> None:
    """Raise if the mix passes the entry an argument the reference does
    not model: its answers could not be judged."""
    extra = set(mix["args"]) - MODELLED_ARGS
    if extra:
        raise ValueError(f"the reference does not model {sorted(extra)} "
                         f"of {mix['entry']}")


def sample(answers: list, mix: dict, seed: int) -> list[int]:
    """The window's paths compared with the reference, ``sample_answers``
    of them drawn from the seed."""
    rng = np.random.default_rng(data.derive_seed(seed, 3))
    pool = list(range(len(answers)))
    return sorted(int(i) for i in rng.choice(
        pool, size=min(mix["sample_answers"], len(pool)), replace=False))


def check(cell, parts, warm: list, answers: list, seed: int):
    """(correct, checks, failed) of the window's paths; the warm-up's are
    not judged."""
    picked = sample(answers, cell.traffic, seed)
    per_job = compare.path_checks(cell.config, cell.traffic, parts, answers,
                                  picked, cell.limits["vdev_gap"]["limit"])
    return compare.judge(per_job, cell.limits, COUNTS)
