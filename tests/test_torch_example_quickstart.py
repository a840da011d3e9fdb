"""The port's quickstart twin (``examples/torch_quickstart.py``) against the
JAX package's ``examples/quickstart.py``.

The JAX example runs as it stands (``runpy``); its study, drawn by
``generate_synthetic(PRNGKey(0), 5, 2000, 8)``, goes through numpy into
the twin's ``run``.  On the same data the two fits take the same
iterations and wire bytes, and their betas agree within the fixed-point
quantization (S+1)/2^28; the twin prints the JAX example's lines.
"""
import importlib.util
import os
import pathlib
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
S = 5
QUANT_TOL = (S + 1) / 2**28


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's runs: the suite's parallel
    workers share the cores, and several processes each running a full
    OpenMP team stall each other (six copies of the smart-grid twin took
    486 s each with 8 threads, 1.1-1.7 s with one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _twin(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_run():
    """The JAX example's globals and the lines it printed."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        g = runpy.run_path(str(ROOT / "examples" / "quickstart.py"),
                           run_name="__main__")
    return g, out.getvalue().splitlines()


def test_twin_on_the_jax_study_matches_jax(jax_run, capsys):
    g, jax_lines = jax_run
    parts = [(np.array(X), np.array(y)) for X, y in g["study"].parts]
    got = _twin("torch_quickstart").run("cpu", parts=parts)
    secure, want = got["secure"], g["secure"]
    assert secure.iterations == want.iterations
    assert secure.converged and want.converged
    assert secure.bytes_transmitted == want.bytes_transmitted == 28_320
    np.testing.assert_allclose(secure.beta, np.asarray(want.beta), rtol=0,
                               atol=QUANT_TOL)
    assert got["gold"].iterations == g["gold"].iterations
    np.testing.assert_allclose(got["gold"].beta, np.asarray(g["gold"].beta),
                               rtol=0, atol=1e-10)
    # the same lines: all but the max|beta| line (float noise) verbatim
    assert got["lines"][-1] == jax_lines[-1] == "OK"
    assert len(got["lines"]) == len(jax_lines)
    for mine, theirs in zip(got["lines"], jax_lines):
        if mine.startswith("max |beta_sec"):
            assert theirs.startswith("max |beta_sec")
        else:
            assert mine == theirs
    assert capsys.readouterr().out.splitlines() == got["lines"]


def test_twin_on_its_own_draw():
    got = _twin("torch_quickstart").run("cpu")
    assert got["secure"].iterations == got["gold"].iterations == 6
    assert got["secure"].bytes_transmitted == 28_320
    assert got["r2"] > 0.999999 and got["device"] == "cpu"


def test_twin_runs_as_a_user_types_it():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_quickstart.py"),
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == "OK"
