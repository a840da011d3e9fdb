"""The ``secure_fit`` entry: one secure L2-regularized logistic-regression
fit a job, ``repro_torch.secure_fit`` on the cell's institutions' rows.

The inputs are the institutions' rows drawn on the card from the seed
(``pbench/data.py``).  The jobs run the mix's λ grid in blocks of as many
fits as it has points, every point once a block in an order drawn from
the seed, each fit with a protocol seed of its own.  A sample of the
window's fits, one for each λ drawn, is compared with the plain float64
reference (``pbench/compare.py``'s fit numbers).
"""
from __future__ import annotations

import collections
import itertools
import types

import numpy as np

from pbench import categories, compare, data, logreg, reference, traffic

CATEGORIES = categories.CATEGORIES
NUMBERS = compare.FIT_NUMBERS
COUNTS = compare.COUNTS
# the entry's keyword arguments (a mix's ``args``) whose answer the
# reference works out: settings of how the rounds run, not of what is
# fitted.  An argument outside these (an L1 penalty, say) needs a
# reference of its own first.
MODELLED_ARGS = {"rounds", "rounds_per_sync", "max_iter", "fused"}

make_inputs = data.make_parts
Program = logreg.Program


def jobs(mix: dict, seed: int, stream: int = 1):
    """Endless fit jobs from ``seed``: each block of as many fits as the
    grid has points runs every λ once, in an order drawn from the seed.
    ``stream`` separates the warm-up's jobs from the window's."""
    grid = traffic.lambda_grid(mix)
    rng = np.random.default_rng(data.derive_seed(seed, stream))
    for i in itertools.count():
        if i % len(grid) == 0:
            order = rng.permutation(len(grid))
        yield {"index": i, "lam": grid[order[i % len(grid)]],
               "seed": int(rng.integers(0, 2**62))}


class Control(logreg.Control):
    """The reference fit in float32 with TF32 on."""

    def __call__(self, parts, job):
        low = self._low(parts)
        with reference.precision(self.dtype):
            fit = reference.irls(low, job["lam"], dtype=self.dtype)
        return types.SimpleNamespace(
            beta=fit.beta.double().cpu().numpy(),
            iterations=fit.iterations, converged=True,
            deviance_trace=[fit.objective],
            bytes_transmitted=fit.iterations
            * reference.round_bytes(self.config))


def control_jobs(mix: dict) -> int:
    """Fits a control runs for its readings: one for each λ."""
    return len(traffic.lambda_grid(mix))


def job_record(answer, seconds: float) -> dict:
    return {"seconds": seconds, "rounds": int(answer.iterations)}


def modelled(mix: dict) -> None:
    """Raise if the mix passes the entry an argument the reference does
    not model: its answers could not be judged."""
    extra = set(mix["args"]) - MODELLED_ARGS
    if extra:
        raise ValueError(f"the reference does not model {sorted(extra)} "
                         f"of {mix['entry']}")


def sample(answers: list, mix: dict, seed: int) -> list[int]:
    """The window's fits compared with the reference, drawn from the
    seed: one for each λ drawn, as many λs as ``sample_answers``."""
    rng = np.random.default_rng(data.derive_seed(seed, 3))
    by_lam = collections.defaultdict(list)
    for i, (job, _) in enumerate(answers):
        by_lam[job["lam"]].append(i)
    pool = [int(rng.choice(v)) for _, v in sorted(by_lam.items())]
    return sorted(int(i) for i in rng.choice(
        pool, size=min(mix["sample_answers"], len(pool)), replace=False))


def check(cell, parts, warm: list, answers: list, seed: int):
    """(correct, checks, failed) of the window's fits; the warm-up's are
    not judged."""
    picked = sample(answers, cell.traffic, seed)
    per_job = compare.fit_checks(cell.config, parts, answers, picked)
    return compare.judge(per_job, cell.limits, COUNTS)
