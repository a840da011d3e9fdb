"""The comparison that decides ``correct``: the numbers a run compares,
each held to its limit from ``port_bench/limits/<cell>.json``; ``judge``
holds any entry's numbers to their limits, the rest are the two
logistic-regression entries' numbers.

Fits (``secure_fit``), for a sample of the window's fits, one for each λ
the sample reaches:

* ``beta_gap``: max |β - β_ref| / max |β_ref| over the sample;
* ``obj_gap``: |objective - objective_ref| / objective_ref, the revealed
  deviance aggregate of the last round plus λ ||β||², over the sample;
* ``wire_mismatch``: fits of the window whose wire bytes differ from
  rounds x the protocol's count (exact);
* ``unconverged``: fits of the window that stopped without converging.

Paths (``secure_cv_path``), for a sample of the window's paths:

* ``vdev_gap``: max over (λ, fold) of the revealed held-out deviance's
  |gap| / reference;
* ``count_mismatch``: (λ, fold) whose held-out row count differs (exact);
* ``pick_mismatch``: the best and the 1-SE picks that differ from the
  reference's (exact), save where the reference's CV means at the two λs
  lie within ``vdev_gap``'s limit of each other: a tie at the resolution
  the held-out deviances are compared to, where either pick is right;
* ``refit_gap``: max |β - β_ref| / max |β_ref| of the refit, the
  reference refit at the λ the program picked;
* ``wire_mismatch``: paths of the window whose rounds or wire bytes
  differ from the protocol's count for the rounds their folds report.
"""
from __future__ import annotations

import numpy as np
import torch

from . import reference as ref

FIT_NUMBERS = ("beta_gap", "obj_gap", "wire_mismatch", "unconverged")
PATH_NUMBERS = ("vdev_gap", "count_mismatch", "pick_mismatch", "refit_gap",
                "wire_mismatch")
# the logistic-regression numbers that count jobs or entries (summed over
# the jobs); the others are gaps (their largest counts)
COUNTS = ("wire_mismatch", "count_mismatch", "pick_mismatch", "unconverged")


def _rel_beta_gap(beta, beta_ref) -> float:
    beta = torch.as_tensor(np.asarray(beta), dtype=torch.float64)
    beta_ref = beta_ref.detach().to("cpu", torch.float64)
    return float((beta - beta_ref).abs().max()
                 / beta_ref.abs().max().clamp_min(1e-300))


def fit_checks(config: dict, parts, answers: list, sample: list) -> dict:
    """Each fit's numbers, by its index in the window: ``answers`` holds
    (job, result) of every fit, ``sample`` the indices compared with the
    reference (the others' gaps are not read)."""
    per_round = ref.round_bytes(config)
    per_job = {
        i: {"wire_mismatch": int(res.bytes_transmitted
                                 != res.iterations * per_round),
            "unconverged": int(not res.converged)}
        for i, (_, res) in enumerate(answers)}
    with ref.precision(torch.float64):
        for i in sample:
            job, res = answers[i]
            fit = ref.irls(parts, job["lam"])
            per_job[i]["beta_gap"] = _rel_beta_gap(res.beta, fit.beta)
            per_job[i]["obj_gap"] = (abs(float(res.deviance_trace[-1])
                                         - fit.objective)
                                     / abs(fit.objective))
    return per_job


def path_wire_ok(config: dict, traffic: dict, rep) -> bool:
    """The path's rounds and bytes against the protocol's count: a λ chunk
    runs as many rounds as its slowest fold, the refit its own."""
    block, K = traffic["args"]["lam_block"], traffic["args"]["num_folds"]
    kw = dict(include_count=True, extra_scalars=3)
    rounds = np.asarray(rep.fold_rounds).max(axis=1)
    chunks = [rounds[i:i + block] for i in range(0, len(rounds), block)]
    want_bytes = sum(int(c.max()) * ref.round_bytes(
        config, configs=K * len(c), **kw) for c in chunks)
    want_bytes += rep.refit_rounds * ref.round_bytes(config, configs=1, **kw)
    want_rounds = sum(int(c.max()) for c in chunks) + rep.refit_rounds
    return rep.bytes_total == want_bytes and rep.rounds_total == want_rounds


def path_checks(config: dict, traffic: dict, parts, answers: list,
                sample: list, tie: float) -> dict:
    """Each path's numbers, as ``fit_checks``; ``tie`` is the relative
    gap of CV means under which two picks are a tie."""
    per_job = {i: {"wire_mismatch": int(not path_wire_ok(config, traffic,
                                                           rep))}
               for i, (_, rep) in enumerate(answers)}
    with ref.precision(torch.float64):
        for i in sample:
            job, rep = answers[i]
            cv = ref.cv_path(parts, job["lambdas"],
                             traffic["args"]["num_folds"], job["fold_seed"])
            vdev = np.asarray(rep.val_deviance)
            picks = ((rep.best_index, cv.best_index),
                     (rep.one_se_index, cv.one_se_index))
            refit = ref.irls(parts, job["lambdas"][rep.one_se_index])
            per_job[i].update(
                vdev_gap=float(np.max(np.abs(vdev - cv.val_deviance)
                                      / np.abs(cv.val_deviance))),
                count_mismatch=int(np.sum(np.asarray(rep.val_count)
                                          != cv.val_count)),
                pick_mismatch=sum(
                    int(abs(cv.cv_mean[mine] - cv.cv_mean[theirs])
                        > tie * abs(cv.cv_mean[theirs]))
                    for mine, theirs in picks),
                refit_gap=_rel_beta_gap(rep.beta, refit.beta))
    return per_job


def judge(per_job: dict, limits: dict,
          counts=COUNTS) -> tuple[bool, dict, int]:
    """(correct, checks, failed): every number at or under its limit
    (a NaN is over any), and the jobs with some number over its limit.
    The numbers named in ``counts`` (the entry's) are summed over the
    jobs, the others are gaps, whose largest counts.  A number without a
    limit, or a limit without a number, is a fault of the benchmark's
    files and raises."""
    names = {k for nums in per_job.values() for k in nums}
    if names != set(limits):
        raise ValueError(f"numbers {sorted(names)} and limits "
                         f"{sorted(limits)} differ")
    checks = {}
    for k in sorted(names):
        values = [nums[k] for nums in per_job.values() if k in nums]
        value = sum(values) if k in counts else max(
            values, key=lambda v: float("inf") if v != v else v)
        checks[k] = {"value": value, "limit": limits[k]["limit"]}
    failed = sum(any(not v <= limits[k]["limit"] for k, v in nums.items())
                 for nums in per_job.values())
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks, failed
