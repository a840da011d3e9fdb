"""A whole run past the harness's look for a card, at a size the CPU holds:
the result line's schema, the control and each fault a cell can have
coming out as not correct, and the check that no JAX is loaded."""
import ast
import json
import subprocess
import sys

import pytest
import torch

import bench_testutil as tu
from pbench import harness

CPU = torch.device("cpu")
SECONDS = 0.2
FIT, PATH = "pascal_alpha_s8.fit", "pascal_alpha_s8.path"
LOOK = harness.forbidden_modules


@pytest.fixture(autouse=True)
def no_jax_look(monkeypatch):
    """The test process also runs the JAX package's tests, so the run's own
    look for JAX is left out here; a fresh process makes it below."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])


def _run(name, trace=False, program_cls=harness.Program, seed=20260001,
         seconds=SECONDS):
    cell = tu.tiny_cell(name)
    return harness.run(cell, tu.spec(), seed, seconds, trace, CPU, 0.0,
                       program_cls)


@pytest.mark.parametrize("name", [FIT, PATH])
def test_result_line_schema(name):
    res = _run(name, trace=True)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
            "window_s"} <= set(dev)
    for key in ("device_ops", "idle_gaps"):
        assert len(res["breakdown"][key]) <= 10
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    assert set(res["setup_parts_s"]) == {"start", "card", "program",
                                         "kernels", "data", "warmup"}
    assert all(v >= 0 for v in res["setup_parts_s"].values())
    json.loads(json.dumps(res))  # one JSON line
    res0 = _run(name, seconds=3.0)  # jobs enough for a percentile
    cell = tu.tiny_cell(name)
    assert set(res0["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        assert res0["metrics"][m["name"]]["unit"] == m["unit"]
        assert res0["metrics"][m["name"]]["value"] > 0


@pytest.mark.parametrize("name", [FIT, PATH])
def test_the_control_is_not_correct(name):
    """The reference in float32 with TF32 on, in the program's place."""
    res = _run(name, program_cls=harness.Control)
    assert res["correct"] is False


def _halve(t, axis):
    """The first half of the institutions in place of the second: the sum
    becomes S x the mean over the half kept."""
    t = t.clone()
    h = t.shape[axis] // 2
    t.narrow(axis, h, h).copy_(t.narrow(axis, 0, h))
    return t


def _fault_step(monkeypatch):
    import repro_torch.core.newton as newton
    import repro_torch.selection.path as path

    monkeypatch.setattr(newton, "prox_newton_step",
                        lambda beta, *a, **k: beta)
    monkeypatch.setattr(path, "batched_prox_newton_step",
                        lambda betas, *a, **k: betas)


def _fault_half_batch(monkeypatch):
    import repro_torch.core.newton as newton
    import repro_torch.selection.path as path

    fit_sm, cv_sm = newton.batched_local_summaries, path.batched_cv_summaries

    def fit_half(*a, **k):
        sm = fit_sm(*a, **k)
        return type(sm)(*(_halve(t, 0) for t in sm))

    def cv_half(*a, **k):
        sm = cv_sm(*a, **k)
        return type(sm)(*(_halve(t, 1) for t in sm))

    monkeypatch.setattr(newton, "batched_local_summaries", fit_half)
    monkeypatch.setattr(path, "batched_cv_summaries", cv_half)


def _fault_exchange(monkeypatch):
    """The centers' share-wise sum over the institutions left out: the
    aggregate is the first institution's shares alone."""
    import repro_torch.core.collective as collective

    monkeypatch.setattr(collective, "fsum",
                        lambda stacked, field, axis=0, residue_axis=1:
                        stacked.select(axis, 0))


def _fault_answer(monkeypatch):
    """A revealed answer altered where it is produced: the fit's beta and
    one held-out deviance of the path, by a part in 10^6."""
    import repro_torch.core.newton as newton
    import repro_torch.selection.path as path

    result = newton.SecureFitDriver.result
    report = path.PathDriver.build_report

    def bad_result(self):
        res = result(self)
        res.beta = res.beta * (1 + 1e-6)
        return res

    def bad_report(self, *a, **k):
        rep = report(self, *a, **k)
        rep.val_deviance[0, 0] *= 1 + 1e-6
        return rep

    monkeypatch.setattr(newton.SecureFitDriver, "result", bad_result)
    monkeypatch.setattr(path.PathDriver, "build_report", bad_report)


@pytest.mark.parametrize("name", [FIT, PATH])
@pytest.mark.parametrize("fault", [_fault_step, _fault_half_batch,
                                   _fault_exchange, _fault_answer])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    res = _run(name)
    assert res["correct"] is False and res["failed"] >= 1


def test_forbidden_modules_compare_whole_top_level_names():
    mods = dict.fromkeys(("torch", "repro_torch", "repro_torch.core",
                          "repro_torch_extra", "jaxtyping", "reproducible"))
    assert LOOK(mods) == []
    mods.update(dict.fromkeys(("repro.core", "jaxlib.xla_client")))
    assert LOOK(mods) == ["jaxlib", "repro"]


def _load_in_trace(monkeypatch, load):
    capture = harness.trace_mod.capture

    def loading(*a, **k):
        out = capture(*a, **k)
        load()
        return out

    monkeypatch.setattr(harness.trace_mod, "capture", loading)


def _load_in_free(monkeypatch, load):
    free = harness.Setup.free

    def loading(self):
        free(self)
        load()

    monkeypatch.setattr(harness.Setup, "free", loading)


def _load_in_check(monkeypatch, load):
    check = harness.check

    def loading(*a, **k):
        load()
        return check(*a, **k)

    monkeypatch.setattr(harness, "check", loading)


@pytest.mark.parametrize("phase, name", [(_load_in_trace, "jax"),
                                         (_load_in_free, "repro.core.newton"),
                                         (_load_in_check, "flax")])
def test_a_forbidden_module_loaded_after_the_window_is_caught(
        monkeypatch, phase, name):
    """The run's look for JAX comes last: a module that the traced part,
    the freeing or the check loads is caught, and no result comes."""
    modules = dict.fromkeys(("torch", "repro_torch", "numpy"))
    monkeypatch.setattr(harness, "forbidden_modules",
                        lambda: LOOK(modules))
    phase(monkeypatch, lambda: modules.setdefault(name))
    with pytest.raises(harness.Forbidden, match=name.split(".")[0]):
        _run(FIT, trace=True)


def test_a_forbidden_module_in_sys_modules_stops_the_command():
    """In a fresh process, a real ``sys.modules`` entry made by the check:
    the run exits non-zero and prints no result line."""
    code = ("import sys, types, torch, bench_testutil as tu\n"
            "from pbench import harness\n"
            "check = harness.check\n"
            "def loading(*a, **k):\n"
            "    sys.modules['jax'] = types.ModuleType('jax')\n"
            "    return check(*a, **k)\n"
            "harness.check = loading\n"
            f"harness.run(tu.tiny_cell({FIT!r}), tu.spec(), 5, 0.1, False,"
            " torch.device('cpu'), 0.0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tu.BENCH,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "Forbidden" in proc.stderr and "jax" in proc.stderr


def test_a_run_of_the_port_loads_no_jax():
    """A whole run in a fresh process, the run's own look included."""
    code = ("import torch, bench_testutil as tu\n"
            "from pbench import harness\n"
            f"res = harness.run(tu.tiny_cell({FIT!r}), tu.spec(), 5, 0.1,"
            " False, torch.device('cpu'), 0.0)\n"
            "print(res['correct'], harness.forbidden_modules())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tu.BENCH,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split("\n")[-2] == "True []"


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for path in tu.BENCH.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = [node.module.split(".")[0]]
            else:
                continue
            assert not set(tops) & set(harness.FORBIDDEN), (path, tops)


def test_without_a_card_the_command_prints_no_result():
    proc = subprocess.run(
        [sys.executable, str(tu.BENCH / "run.py"), "--workload", FIT,
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tu.ROOT)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "cuda" in proc.stderr


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", [FIT, PATH])
def test_a_short_run_on_the_card_is_correct(card, name):
    """The cell at its own size (its limits hold there), a short window."""
    res = harness.run(tu.spec().cell(name), tu.spec(), 31, 2.0, True, card,
                      0.0)
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
