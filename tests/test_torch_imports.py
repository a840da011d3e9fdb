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
        "repro_torch.core.multistudy, repro_torch.selection\n"
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
], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    """Every module of the port, the ``runtime`` copies and
    ``core/multistudy.py`` included, and ``chip_smoke.py``."""
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
