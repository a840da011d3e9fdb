"""The port stands alone: no JAX, nothing of the JAX package, and entry
points that run on the CUDA card unless the caller asks for the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_import_leaves_jax_and_the_jax_package_out():
    code = (
        "import sys, repro_torch, repro_torch.core, repro_torch.kernels.ops, "
        "repro_torch.convert, repro_torch.data, repro_torch.runtime, "
        "repro_torch.core.multistudy, repro_torch.selection, "
        "repro_torch.models, repro_torch.configs, repro_torch.launch.serve, "
        "repro_torch.launch.train, repro_torch.optim, repro_torch.checkpoint, "
        "repro_torch.data.datasets, repro_torch.kernels.flash_attention_bwd, "
        "repro_torch.distributed, repro_torch.distributed.compat, "
        "repro_torch.distributed.multihost, "
        "repro_torch.distributed.sharding, repro_torch.distributed._tp, "
        "repro_torch.models.transformer, repro_torch.analysis, "
        "repro_torch.analysis.drivers, repro_torch.analysis.fixtures, "
        "repro_torch.analysis.lints, repro_torch.analysis.__main__, "
        "repro_torch.obs.audit, repro_torch.obs.__main__, "
        "repro_torch.obs.cost, repro_torch.kernels.work, "
        "repro_torch.kernels.tuning, repro_torch.configs.perf_presets, "
        "repro_torch.launch.cost_analysis, repro_torch.launch.dryrun, "
        "repro_torch.launch.mesh, repro_torch.launch.specs\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py",
] + sorted((ROOT / "examples").glob("torch_*.py")),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    """Every module of the port, the ``runtime`` copies and
    ``core/multistudy.py`` included, ``chip_smoke.py`` and the port's
    examples."""
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


def test_entry_points_raise_without_a_card(monkeypatch):
    """No card: ``device=None`` raises instead of running on the CPU."""
    import numpy as np

    from repro_torch import centralized_fit, generate_synthetic, secure_fit
    from repro_torch.core.newton import SecureFitDriver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    parts = [(np.ones((4, 2)), np.zeros(4))]
    for call in (lambda: secure_fit(parts),
                 lambda: SecureFitDriver(parts),
                 lambda: centralized_fit(*parts[0]),
                 lambda: generate_synthetic(0, 1, 4, 2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert secure_fit(parts, device="cpu", max_iter=1).iterations == 1


def test_slice_c_entry_points_raise_without_a_card(monkeypatch):
    """The deployment and selection entry points: ``device=None`` raises
    without a card, ``device="cpu"`` runs."""
    import numpy as np

    from repro_torch import (
        Institution,
        SelectionCoordinator,
        StudyCoordinator,
        secure_cv_path,
    )
    from repro_torch.core.collective import SecureCollective

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    X = np.concatenate([np.ones((40, 1)), rng.normal(size=(40, 2))], 1)
    y = (rng.random(40) < 0.5).astype(np.float64)

    def insts():
        return [Institution("a", torch.as_tensor(X[:20]),
                            torch.as_tensor(y[:20])),
                Institution("b", torch.as_tensor(X[20:]),
                            torch.as_tensor(y[20:]))]

    agg = SecureCollective(backend="kernel")
    for call in (lambda: StudyCoordinator(insts()),
                 lambda: SelectionCoordinator(insts(), [1.0, 0.1]),
                 lambda: secure_cv_path([(X, y)], [1.0, 0.1], num_folds=2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert StudyCoordinator(insts(), device="cpu").step().iteration == 1
    rep = secure_cv_path([(X, y)], [1.0, 0.1], num_folds=2, aggregator=agg,
                         max_rounds=2, device="cpu")
    assert rep.fold_rounds.max() <= 2


def test_the_walk_reaches_the_slice_b_modules():
    walked = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"runtime/__init__.py", "runtime/managers.py",
            "runtime/supervisor.py", "core/multistudy.py"} <= walked


def test_slice_b_entry_points_raise_without_a_card(monkeypatch):
    """The multi-study round: ``device=None`` raises without a card,
    ``device="cpu"`` runs."""
    import numpy as np

    from repro_torch.core import run_multistudy_rounds

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    X = np.concatenate([np.ones((30, 1)), rng.normal(size=(30, 2))], 1)
    y = (rng.random(30) < 0.5).astype(np.float64)
    studies = [[(X[:15], y[:15]), (X[15:], y[15:])]]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_multistudy_rounds(studies, [1.0], 1)
    betas, trace = run_multistudy_rounds(studies, [1.0], 2, device="cpu")
    assert tuple(betas.shape) == (1, 3) and tuple(trace.shape) == (2, 1)


def test_the_walk_reaches_the_lm_modules():
    walked = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"models/transformer.py", "models/attention.py",
            "configs/registry.py", "configs/qwen2_5_32b.py",
            "launch/serve.py", "kernels/flash_attention.py"} <= walked


def test_lm_entry_points_raise_without_a_card(monkeypatch):
    """``serve.main`` and ``init_params`` default to the card: without one
    they raise; ``--device cpu`` serves."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--arch", "qwen2_5_32b", "--requests", "2", "--batch", "2",
            "--prompt-len", "8", "--new-tokens", "2"]
    for call in (lambda: serve.main(argv),
                 lambda: T.init_params(smoke_config("qwen2_5_32b"))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert serve.main(argv + ["--device", "cpu"])["tokens_generated"] == 4


def test_the_walk_reaches_the_training_modules():
    walked = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"launch/train.py", "optim/adamw.py", "optim/compression.py",
            "checkpoint/checkpointer.py", "data/datasets.py",
            "kernels/flash_attention_bwd.py"} <= walked


def test_train_entry_points_raise_without_a_card(monkeypatch):
    """``train.main`` and ``run_lm`` (and the logreg pipeline) default to
    the card: without one they raise; ``--device cpu`` trains."""
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--arch", "qwen2_5_32b", "--smoke", "--steps", "1", "--batch",
            "2", "--seq-len", "8", "--institutions", "2"]
    logreg = ["--arch", "logreg_paper", "--study", "parkinsons.total",
              "--scale", "0.02"]
    for call in (lambda: train.main(argv),
                 lambda: train.run_lm(train.parse_args(argv)),
                 lambda: train.main(logreg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert train.main(argv + ["--device", "cpu"])["steps"] == 1


def test_the_walk_reaches_the_distributed_modules():
    walked = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"distributed/__init__.py", "distributed/compat.py",
            "distributed/multihost.py",
            "distributed/sharding.py"} <= walked


def test_wire_entry_points_raise_without_a_card(monkeypatch):
    """``run_scanned_rounds`` (the host-level entry of the wires) defaults
    to the card: without one it raises; ``device="cpu"`` spawns its ranks
    on the CPU."""
    from repro_torch.distributed import run_scanned_rounds

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = {"w": torch.linspace(-1.0, 1.0, 40)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_scanned_rounds(2, tree, 0, 1)
    final, trace = run_scanned_rounds(2, tree, 0, 2, device="cpu")
    assert tuple(trace.shape) == (2,)
    assert torch.allclose(final["w"], tree["w"], atol=1e-6)


def test_the_walk_reaches_the_privacy_gate_modules():
    walked = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"analysis/__init__.py", "analysis/__main__.py",
            "analysis/drivers.py", "analysis/fixtures.py",
            "analysis/lints.py", "analysis/report.py", "analysis/taint.py",
            "obs/audit.py", "obs/__main__.py", "obs/gate.py"} <= walked


def test_gate_entry_points_raise_without_a_card(monkeypatch):
    """``certify``, ``run_audit`` and both CLIs default to the card:
    without one they raise; ``device="cpu"`` runs."""
    from repro_torch.analysis import __main__ as gate_cli
    from repro_torch.analysis.drivers import all_driver_specs, certify
    from repro_torch.obs import __main__ as obs_cli
    from repro_torch.obs import audit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = all_driver_specs()[0]
    for call in (lambda: certify(spec),
                 lambda: audit.run_audit(drivers=[spec.name]),
                 lambda: gate_cli.main(["--drivers", spec.name]),
                 lambda: obs_cli.main(["audit", "--drivers", spec.name])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert certify(spec, "cpu")[0].ok


TWINS = ("torch_quickstart", "torch_fault_tolerant_consortium",
         "torch_smart_grid_selection", "torch_secure_lm_training")


def test_the_walk_reaches_the_example_twins():
    assert sorted(p.stem for p in (ROOT / "examples").glob("torch_*.py")) \
        == sorted(TWINS)


@pytest.mark.parametrize("name", TWINS)
def test_example_twins_raise_without_a_card(monkeypatch, name):
    """Each twin's ``main`` (and ``run(device=None)``) runs on the card:
    without one it raises before any work; ``--device cpu`` runs it (the
    ``tests/test_torch_example_*.py`` files)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: mod.main([]), lambda: mod.run()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    if name == "torch_quickstart":
        assert mod.main(["--device", "cpu"])["device"] == "cpu"
