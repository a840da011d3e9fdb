"""One run of one cell: set-up, the measured window, the traced part, the
check against the reference, the result line.

Set-up draws the cell's data on the card from the seed and runs the
traffic's warm-up jobs, which build or load the program's kernels and
touch every shape the window uses.  The window then runs the mix's jobs
back to back, one coordinator waiting on each (a closed loop), until
``seconds`` have passed; its time is all the time of the jobs it
completed.  With ``trace`` a few more jobs run under the profiler.  Only
then is the program's state freed and the reference run.
"""
from __future__ import annotations

import collections
import gc
import sys
import time
import types

import numpy as np
import torch

from . import compare, data, readers, reference, traffic
from . import trace as trace_mod
from .spec import Cell, Spec

# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the configuration's settings that every entry point takes; a mix's
# ``args`` (the entry's own keyword arguments) and a job's (its λ and
# seeds) are merged over them
ENTRY_SETTINGS = ("protect", "tol", "summaries_backend")


class NoCard(RuntimeError):
    """The machine lacks the cards the cell asks for."""


class Forbidden(RuntimeError):
    """A forbidden module was loaded in the run's process."""


def card(chips: int) -> torch.device:
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"{torch.cuda.device_count()} cards < {chips} asked")
    return torch.device("cuda", 0)


def forbidden_modules(modules=None) -> list[str]:
    """Forbidden top-level names in ``modules`` (``sys.modules``),
    compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The system under test: the port's entry points, configured as the
    cell's configuration states (and refusing to run where the program's
    protocol differs from it)."""

    def __init__(self, config: dict, mix: dict, device):
        from repro_torch.core.collective import SecureCollective

        self.config, self.mix, self.device = config, mix, device
        self.agg = SecureCollective(backend=config["backend"])
        scheme, codec = self.agg.scheme, self.agg.codec
        runs = {"threshold": scheme.threshold, "centers": scheme.num_shares,
                "moduli": list(scheme.field.moduli),
                "frac_bits": codec.frac_bits}
        stated = {k: config[k] for k in runs}
        if runs != stated:
            raise ValueError(f"the program's protocol {runs} is not the "
                             f"configuration's {stated}")

    def __call__(self, parts, job):
        import repro_torch

        kwargs = {k: self.config[k] for k in ENTRY_SETTINGS}
        kwargs.update(self.mix["args"])
        kwargs.update({k: v for k, v in job.items() if k != "index"})
        return getattr(repro_torch, self.mix["entry"])(
            parts, aggregator=self.agg, device=self.device, **kwargs)

    def load_kernels(self) -> None:
        """Build the program's kernels, or load the build the checkout
        already holds (on the card; off it the program runs none)."""
        if self.device.type == "cuda":
            from repro_torch.kernels import _build

            _build.library()

    @staticmethod
    def counters() -> dict:
        from repro_torch.kernels import fused_irls

        return {"k3_launches": fused_irls.fused_irls_kernel.launches,
                "k5_launches": fused_irls.fused_irls_cv_kernel.launches}

    def free(self) -> None:
        from repro_torch.core.batched_summaries import pack_cache_clear

        pack_cache_clear()
        self.agg = None


class Control:
    """The reference put in the program's place, in float32 with TF32 on:
    the control that the comparison has to reject.  Its answers carry the
    fields the comparison reads, with the wire and the rounds as the
    protocol counts them."""

    dtype = torch.float32

    def __init__(self, config: dict, mix: dict, device):
        self.config, self.mix, self.device = config, mix, device
        self._parts = None

    def _low(self, parts):
        if self._parts is None or self._parts[0] is not parts:
            self._parts = (parts, reference.as_dtype(parts, self.dtype))
        return self._parts[1]

    def load_kernels(self) -> None:
        pass

    def __call__(self, parts, job):
        low = self._low(parts)
        with reference.precision(self.dtype):
            if self.mix["entry"] == "secure_fit":
                fit = reference.irls(low, job["lam"], dtype=self.dtype)
                return types.SimpleNamespace(
                    beta=fit.beta.double().cpu().numpy(),
                    iterations=fit.iterations, converged=True,
                    deviance_trace=[fit.objective],
                    bytes_transmitted=fit.iterations
                    * reference.round_bytes(self.config))
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

    @staticmethod
    def counters() -> dict:
        return {"k3_launches": 0, "k5_launches": 0}

    def free(self) -> None:
        self._parts = None


def job_record(answer, seconds: float) -> dict:
    if hasattr(answer, "iterations"):
        return {"seconds": seconds, "rounds": int(answer.iterations)}
    return {"seconds": seconds, "rounds": int(answer.rounds_total),
            "sweep_rounds": int(answer.rounds_total - answer.refit_rounds),
            "refit_rounds": int(answer.refit_rounds)}


def sample(answers: list, mix: dict, seed: int) -> list[int]:
    """The window's jobs compared with the reference, drawn from the seed:
    fits one for each λ drawn (as many λs as ``sample_answers``), paths
    ``sample_answers`` of them."""
    rng = np.random.default_rng(data.derive_seed(seed, 3))
    n = mix["sample_answers"]
    if mix["entry"] == "secure_fit":
        by_lam = collections.defaultdict(list)
        for i, (job, _) in enumerate(answers):
            by_lam[job["lam"]].append(i)
        pool = [int(rng.choice(v)) for _, v in sorted(by_lam.items())]
    else:
        pool = list(range(len(answers)))
    return sorted(int(i) for i in rng.choice(pool, size=min(n, len(pool)),
                                             replace=False))


def check(cell: Cell, parts, answers: list, seed: int):
    """(correct, checks, failed) of the window's answers."""
    picked = sample(answers, cell.traffic, seed)
    if cell.traffic["entry"] == "secure_fit":
        per_job = compare.fit_checks(cell.config, parts, answers, picked)
    else:
        per_job = compare.path_checks(cell.config, cell.traffic, parts,
                                      answers, picked,
                                      cell.limits["vdev_gap"]["limit"])
    return compare.judge(per_job, cell.limits)


class Setup:
    """A cell's data, program and warmed-up shapes on ``device``.

    ``parts_s`` times each step of set-up apart (seconds): ``card`` the
    device's context, ``program`` the program's import and construction,
    ``kernels`` its kernels built (a fresh checkout's first run) or
    loaded, ``data`` the inputs drawn on the card, ``warmup`` the warm-up
    jobs."""

    def __init__(self, cell: Cell, seed: int, device, program_cls=Program):
        self.device = device
        self.parts_s = {}
        t = time.perf_counter()

        def lap(name):
            nonlocal t
            sync(device)
            now = time.perf_counter()
            self.parts_s[name] = now - t
            t = now

        torch.empty(1, device=device)
        lap("card")
        self.program = program_cls(cell.config, cell.traffic, device)
        lap("program")
        self.program.load_kernels()
        lap("kernels")
        self.parts = data.make_parts(cell.config, seed, device)
        lap("data")
        warm = traffic.jobs(cell.traffic, seed, stream=2)
        for _ in range(cell.traffic["warmup_jobs"]):
            self.program(self.parts, next(warm))
        lap("warmup")
        self.jobs = traffic.jobs(cell.traffic, seed, stream=1)

    def run_jobs(self, seconds: float | None = None, count: int | None = None):
        """(answers, records, seconds): jobs back to back until ``seconds``
        have passed or ``count`` jobs have run."""
        answers, records = [], []
        w0 = t1 = time.perf_counter()
        while True:
            job = next(self.jobs)
            t0 = time.perf_counter()
            answer = self.program(self.parts, job)
            sync(self.device)
            t1 = time.perf_counter()
            answers.append((job, answer))
            records.append(job_record(answer, t1 - t0))
            if (seconds is not None and t1 - w0 >= seconds) or \
                    (count is not None and len(answers) >= count):
                return answers, records, t1 - w0

    def free(self) -> None:
        """Drop the program's state; the inputs stay for the reference."""
        self.program.free()
        self.program = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run(cell: Cell, spec: Spec, seed: int, seconds: float, trace: bool,
        device, t_start: float, program_cls=Program, marks=()) -> dict:
    """The result line's object (``checks`` last), after one run.

    ``setup_parts_s`` splits ``setup_s``: the steps the caller timed
    before the run (``marks``, (name, clock) pairs after ``t_start``, in
    order), ``start`` the rest up to set-up, then ``Setup.parts_s``.  Raises
    ``Forbidden`` if a forbidden module is loaded at the end of the run,
    after the window, the traced part and the check."""
    compare.modelled(cell.traffic)  # before a run whose answers no one judges
    t_setup = time.perf_counter()
    setup = Setup(cell, seed, device, program_cls)
    setup_s = time.perf_counter() - t_start
    answers, records, window_s = setup.run_jobs(seconds=seconds)
    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    summary = None
    if trace:
        before = setup.program.counters()
        traced, summary = trace_mod.capture(
            lambda: setup.run_jobs(count=cell.traffic["traced_jobs"])[1],
            device)
        after = setup.program.counters()
        summary.update({k: after[k] - before[k] for k in after}, jobs=traced)
    setup.free()
    t_check = time.perf_counter()
    correct, checks, failed = check(cell, setup.parts, answers, seed)
    check_s = time.perf_counter() - t_check
    ctx = readers.Context(cell.config, cell.traffic, on_card, setup_s,
                          window_s, records, summary)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card
           else device.type,
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(answers),
              "failed": failed, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_us"] * 1e-6
        dev["window_s"] = summary["window_us"] * 1e-6
        result["breakdown"] = summary["breakdown"]
    parts, last = {}, t_start
    for name, at in marks:
        parts[name], last = at - last, at
    parts["start"] = t_setup - last
    result["setup_parts_s"] = dict(parts, **setup.parts_s)
    result["check_seconds"] = check_s
    result["checks"] = checks
    # the last step: whatever the window, the trace, the freeing and the
    # check loaded is in sys.modules by now
    leaked = forbidden_modules()
    if leaked:
        raise Forbidden(f"loaded in the run's process: {leaked}")
    return result
