"""What the metric readers under ``port_bench/metrics/`` share: the run's
context and the work of one secure round at the cell's shapes.

A reader returns a number, or None where it finds nothing to read: no
traced window, no device, no kernel of its kind in the trace.  A share of
a roofline or of a peak is never 0 for want of data.
"""
from __future__ import annotations

import dataclasses
import statistics

from . import reference as ref
from . import work


@dataclasses.dataclass
class Context:
    """A finished run as the readers see it.

    ``jobs``: one dict a job of the measured window (the entry's
    ``job_record``: ``seconds``, and for fits and paths ``rounds``, for
    paths ``sweep_rounds`` and ``refit_rounds``); ``trace``:
    ``trace.capture``'s summary of the traced part, with that part's
    ``jobs`` and the program's counters (the entry's: ``k3_launches``,
    ``k5_launches``; ``K7``, ``K8a``, ``K8b`` launches), or None;
    ``entry``: the cell's entry module, whose work counts a reader of its
    kind of job may take."""

    config: dict
    traffic: dict
    on_card: bool
    setup_s: float
    window_s: float
    jobs: list
    trace: dict | None = None
    entry: object = None


def mean_rounds(ctx: Context):
    return statistics.fmean(j["rounds"] for j in ctx.jobs) if ctx.jobs \
        else None


def traced_rounds(ctx: Context) -> int:
    return sum(j["rounds"] for j in ctx.trace["jobs"])


def device_ms_per_round(ctx: Context, us):
    """Device ms a round of the traced part, or None off the card."""
    if not ctx.on_card or ctx.trace is None or us is None:
        return None
    rounds = traced_rounds(ctx)
    return us / 1e3 / rounds if rounds else None


def category_us(ctx: Context, name: str):
    if ctx.trace is None:
        return None
    return ctx.trace["by_category_us"].get(name)


def idle_share(ctx: Context):
    if not ctx.on_card or ctx.trace is None:
        return None
    t = ctx.trace
    return 100.0 * (1.0 - t["busy_us"] / t["window_us"])


# -- the work of one round --------------------------------------------------

def _collective(config: dict, configs: int, **kw) -> list:
    """K1 over every institution's buffers, K2 over the aggregates."""
    n = configs * ref.wire_elements(config, **kw)
    s, r = config["institutions"], len(config["moduli"])
    return [work.k1_encode_share(s * n, 8, r, config["threshold"] - 1,
                                 config["centers"]),
            work.k2_reconstruct(n, config["threshold"], r, True)]


def fit_round(config: dict) -> list:
    """K3 over every valid row, the collective, one Newton solve."""
    d = config["features"]
    return ([work.k3_fused_irls(config["rows"], d, config["institutions"])]
            + _collective(config, 1) + [work.lu_solve(d)])


def path_round(config: dict, configs: int, train_rows: int) -> list:
    """K5 with ``configs`` configurations training on ``train_rows`` rows
    in all, the collective over them, ``configs`` Newton solves."""
    d = config["features"]
    return ([work.k5_fused_irls_cv(config["rows"], train_rows, d, configs,
                                   config["institutions"])]
            + _collective(config, configs, include_count=True,
                          extra_scalars=3)
            + [work.lu_solve(d, configs)])


def sweep_round(ctx: Context) -> list:
    """A λ chunk's round: each fold trains on the rows of the others."""
    k = ctx.traffic["args"]["num_folds"]
    block = ctx.traffic["args"]["lam_block"]
    rows = ctx.config["rows"]
    return path_round(ctx.config, k * block, block * (k - 1) * rows)


def refit_round(ctx: Context) -> list:
    return path_round(ctx.config, 1, ctx.config["rows"])


def ops_s(round_work: list) -> float:
    """The least seconds of a round's operations: its steps depend on each
    other, so their least times add."""
    return sum(w.ops_s() for w in round_work)
