"""The port's consortium twin (``examples/torch_fault_tolerant_consortium.py``)
against the JAX package's ``examples/fault_tolerant_consortium.py``.

The JAX example runs as it stands (``runpy``): a ``RoundSupervisor`` over
the fused ``StudyCoordinator`` on its ``PRNGKey(3)`` study, through the
chaos schedule and the join at round 4.  Its nine parts go through numpy
into the twin's ``run``.  Round by round the two supervised runs must
agree on everything the schedule decides (responders, stragglers, the
centers used, degraded, retries, backoff, events, suspected-dead), and at
the end on the iteration, the online centers, and beta within the
fixed-point quantization (S+1)/2^28 of the final cohort's S = 8.
"""
import contextlib
import importlib.util
import io
import pathlib
import runpy

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
QUANT_TOL = (8 + 1) / 2**28


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
        g = runpy.run_path(
            str(ROOT / "examples" / "fault_tolerant_consortium.py"),
            run_name="__main__")
    parts = [(np.array(X), np.array(y)) for X, y in g["parts"]]
    mine = _twin("torch_fault_tolerant_consortium").run("cpu", parts=parts)
    return g, out.getvalue().splitlines(), mine


def _round(rec):
    rep = rec.report
    return {
        "round_no": rec.round_no, "attempts": rec.attempts,
        "responders": list(rep.responders),
        "stragglers": list(rep.stragglers),
        "centers_used": list(rep.centers_used),
        "degraded": rec.degraded, "retries": rec.retries,
        "aborted_attempts": rec.aborted_attempts,
        "backoff_seconds": rec.backoff_seconds,
        "events": [tuple(e) for e in rec.events],
        "suspected_dead": list(rec.suspected_dead),
        "iteration": rep.iteration,
    }


def test_every_supervised_round_matches_jax(runs):
    g, _, mine = runs
    theirs = [_round(r) for r in g["sup"].rounds]
    ours = [_round(r) for r in mine["supervisor"].rounds]
    assert len(ours) == len(theirs) == 9
    for a, b in zip(ours, theirs):
        assert a == b


def test_the_end_state_matches_jax(runs):
    g, _, mine = runs
    coord, jcoord = mine["coord"], g["coord"]
    assert coord.converged and jcoord.converged
    assert coord.iteration == jcoord.iteration
    assert sorted(c.index for c in coord.centers if c.online) == sorted(
        c.index for c in jcoord.centers if c.online) == [1, 3, 4]
    np.testing.assert_allclose(coord.beta.numpy(), np.asarray(jcoord.beta),
                               rtol=0, atol=QUANT_TOL)
    sup, jsup = mine["supervisor"], g["sup"]
    assert (sup.total_retries, sup.total_backoff) == (jsup.total_retries,
                                                      jsup.total_backoff)
    assert mine["r2"] > 0.999


def test_the_printed_lines_match_jax(runs):
    """The round lines carry the same schedule decisions; the objective
    and |g| columns agree to their printed precision, bar the last digit
    of |g| where the two reveals round apart."""
    _, jax_lines, mine = runs
    ours = mine["lines"]
    assert ours[-1] == jax_lines[-1] == "OK"

    def fields(line):
        return [f for f in line.split() if not f.startswith(("obj=", "|g|="))]

    rounds = [ln for ln in jax_lines if ln.startswith(("round", ">>"))]
    assert [fields(ln) for ln in ours[:len(rounds)]] == [
        fields(ln) for ln in rounds]
    for mine_ln, jax_ln in zip(ours[:len(rounds)], rounds):
        if mine_ln.startswith("round"):
            obj = float(mine_ln.split("obj=")[1].split()[0])
            jobj = float(jax_ln.split("obj=")[1].split()[0])
            assert obj == pytest.approx(jobj, rel=1e-9)
    tail = ours[len(rounds):]
    jtail = jax_lines[len(rounds):]
    assert tail[:4] == jtail[:4]  # the converged / centers / R^2 lines
    assert "per-round span summary (repro_torch.obs.trace):" in tail
    kinds = {ln.split()[0] for ln in tail if ln.startswith("  ")}
    assert {"round", "newton", "protect", "reveal"} <= kinds


def test_twin_on_its_own_draw():
    got = _twin("torch_fault_tolerant_consortium").run("cpu")
    assert got["coord"].converged and got["r2"] > 0.999
    assert [r.report.centers_used for r in got["supervisor"].rounds][:2] \
        == [[1, 2, 3], [1, 3]]
