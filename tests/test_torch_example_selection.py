"""The port's smart-grid twin (``examples/torch_smart_grid_selection.py``)
against the JAX package's ``examples/smart_grid_selection.py``.

The JAX example runs as it stands (``runpy``); its ``PRNGKey(11)`` X and
y go through numpy into the twin's ``run``, with the fold ids the JAX
run drew for each utility carried over in a converted chunk-0
checkpoint (``convert.selection_state_from_jax``): the port draws its
folds from another generator.  The two paths must pick the same λs and
features in the same rounds and bytes, their CV curves within 1e-9
relative.
"""
import contextlib
import importlib.util
import io
import pathlib
import runpy

import numpy as np
import pytest
import torch

from repro.selection import SelectionCoordinator as JSelection
from repro.selection import assign_folds as j_assign_folds
from repro_torch.convert import selection_state_from_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]


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
def runs():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        g = runpy.run_path(str(ROOT / "examples" / "smart_grid_selection.py"),
                           run_name="__main__")
    # the JAX coordinator's chunk-0 checkpoint and the folds its run drew
    fresh = JSelection(g["utilities"], g["lambdas"], num_folds=5, l1=100.0,
                       protect="gradient", seed=0)
    folds = {u.name: np.asarray(j_assign_folds(u.X.shape[0], 5, u.name, 0))
             for u in g["utilities"]}
    state = selection_state_from_jax(
        {k: np.asarray(v) for k, v in fresh.state_dict().items()}, folds)
    mine = _twin("torch_smart_grid_selection").run(
        "cpu", X=np.array(g["X"]), y=np.array(g["y"]), state=state)
    return g, out.getvalue().splitlines(), mine


def test_the_report_matches_jax(runs):
    g, _, mine = runs
    rep, want = mine["report"], g["report"]
    assert rep.lambda_best == want.lambda_best
    assert rep.lambda_1se == want.lambda_1se
    assert rep.rounds_total == want.rounds_total
    assert rep.bytes_per_round == want.bytes_per_round
    assert rep.bytes_total == want.bytes_total
    np.testing.assert_array_equal(rep.fold_rounds, np.asarray(want.fold_rounds))
    np.testing.assert_allclose(rep.cv_mean, np.asarray(want.cv_mean),
                               rtol=1e-9, atol=0)
    assert mine["selected"] == sorted(g["selected"].tolist())


def test_the_printed_lines_match_jax(runs):
    """Every line, the CV table's included, is the JAX example's."""
    _, jax_lines, mine = runs
    assert len(mine["lines"]) == len(jax_lines)
    for ours, theirs in zip(mine["lines"], jax_lines):
        assert ours == theirs


def test_twin_on_its_own_draw():
    got = _twin("torch_smart_grid_selection").run("cpu")
    rep = got["report"]
    assert rep.lambda_1se >= rep.lambda_best
    assert got["selected"] == list(range(7))
    assert rep.bytes_per_round == 1_459_200
