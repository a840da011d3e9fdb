"""One run of one cell: set-up, the measured window, the traced part, the
check against the reference, the result line.

What depends on the kind of job (the inputs, the program's call, the
control, the jobs, their records and the check) is the cell's entry
module's (``port_bench/entries/<entry>.py``, ``spec.load_entry``); the
run's frame is the same for every kind.  Set-up draws the cell's inputs
on the card from the seed and runs the traffic's warm-up jobs, which
build or load the program's kernels and touch every shape the window
uses; their answers are kept for the check.  The window then runs the
mix's jobs back to back, one caller waiting on each (a closed loop),
until ``seconds`` have passed; its time is all the time of the jobs it
completed.  With ``trace`` a few more jobs run under the profiler.  Only
then is the program's state freed and the reference run.
"""
from __future__ import annotations

import gc
import sys
import time

import torch

from . import readers
from . import trace as trace_mod
from .spec import Cell, Spec

# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


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


def Program(cell: Cell, device):
    """The system under test, as the cell's entry builds it from the
    cell's configuration and mix."""
    return cell.entry.Program(cell.config, cell.traffic, device)


def Control(cell: Cell, device):
    """The entry's control: the reference in the program's place, one
    precision below what the configuration states; the comparison has to
    reject it."""
    return cell.entry.Control(cell.config, cell.traffic, device)


def check(cell: Cell, inputs, answers: list, seed: int, warm=()):
    """(correct, checks, failed) of the run's answers, by the cell's
    entry: ``answers`` the window's (job, answer) pairs, ``warm`` the
    warm-up's."""
    return cell.entry.check(cell, inputs, list(warm), answers, seed)


class Setup:
    """A cell's data, program and warmed-up shapes on ``device``.

    ``parts_s`` times each step of set-up apart (seconds): ``card`` the
    device's context, ``program`` the program's import and construction,
    ``kernels`` its kernels built (a fresh checkout's first run) or
    loaded, ``data`` the inputs drawn on the card, ``warmup`` the warm-up
    jobs, whose (job, answer) pairs ``warm`` keeps."""

    def __init__(self, cell: Cell, seed: int, device, program_cls=Program):
        self.device = device
        self.entry = cell.entry
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
        self.program = program_cls(cell, device)
        lap("program")
        self.program.load_kernels()
        lap("kernels")
        self.inputs = self.entry.make_inputs(cell.config, seed, device)
        lap("data")
        warm = self.entry.jobs(cell.traffic, seed, stream=2)
        self.warm = []
        for _ in range(cell.traffic["warmup_jobs"]):
            job = next(warm)
            self.warm.append((job, self.program(self.inputs, job)))
        lap("warmup")
        self.jobs = self.entry.jobs(cell.traffic, seed, stream=1)

    def run_jobs(self, seconds: float | None = None, count: int | None = None):
        """(answers, records, seconds): jobs back to back until ``seconds``
        have passed or ``count`` jobs have run."""
        answers, records = [], []
        w0 = t1 = time.perf_counter()
        while True:
            job = next(self.jobs)
            t0 = time.perf_counter()
            answer = self.program(self.inputs, job)
            sync(self.device)
            t1 = time.perf_counter()
            answers.append((job, answer))
            records.append(self.entry.job_record(answer, t1 - t0))
            if (seconds is not None and t1 - w0 >= seconds) or \
                    (count is not None and len(answers) >= count):
                return answers, records, t1 - w0

    def free(self) -> None:
        """Drop the program's state; the inputs stay for the reference
        (an entry whose program takes its inputs over as its own state
        drops them with it)."""
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
    cell.entry.modelled(cell.traffic)  # before a run no one could judge
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
            device, cell.entry.CATEGORIES)
        after = setup.program.counters()
        summary.update({k: after[k] - before[k] for k in after}, jobs=traced)
    setup.free()
    t_check = time.perf_counter()
    correct, checks, failed = check(cell, setup.inputs, answers, seed,
                                    setup.warm)
    check_s = time.perf_counter() - t_check
    ctx = readers.Context(cell.config, cell.traffic, on_card, setup_s,
                          window_s, records, summary, cell.entry)
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
