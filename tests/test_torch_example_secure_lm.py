"""The port's secure LM twin (``examples/torch_secure_lm_training.py``)
against the JAX package's ``examples/secure_lm_training.py``.

Both run the same command lines (deepseek_7b's smoke config, batch 8,
sequence 64, Shamir-secure aggregation over 4 institutions, a checkpoint
every 5 steps: 10 steps, then ``--resume`` to 15) through their
``launch.train.main``.  The draws differ (threefry against a torch
generator), so the reports must agree on what does not depend on them:
the steps, institutions, parameter count, wire bytes a step (the JAX
package's from its own flat layout) and the checkpoints written, with the
same npz keys.  The port's resumed steps 10-14 must equal an
uninterrupted 15-step run's, losses and final state, bit for bit.
"""
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

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
def twin():
    return _twin("torch_secure_lm_training")


@pytest.fixture(scope="module")
def runs(twin, tmp_path_factory):
    from repro.launch import train as jtrain

    root = tmp_path_factory.mktemp("secure_lm")
    jdir, pdir = root / "jax", root / "port"
    common = [a for a in twin.argv(str(jdir), "cpu")
              if a not in ("--device", "cpu")]
    jax_out = []
    for i, extra in enumerate((["--steps", "10"],
                               ["--steps", "15", "--resume"])):
        out = root / f"jax{i}.json"
        jtrain.main(common + extra + ["--out", str(out)])
        jax_out.append(json.loads(out.read_text()))
    mine = twin.run("cpu", ckpt_dir=str(pdir))
    return jax_out, mine, jdir, pdir


def _jax_wire_bytes(arch, institutions, w=3, num_residues=2):
    """Share bytes of a secure step on the JAX package's flat wire: every
    institution's gradient tree packed into (rows, 128) uint32 slices,
    w shares of each residue."""
    import jax

    from repro.configs import smoke_config
    from repro.core.flatbuf import LANES, ROW_ALIGN, _rows_for
    from repro.models import transformer as JT

    params = JT.init_params(jax.random.PRNGKey(0), smoke_config(arch))
    n = sum(x.size for x in jax.tree_util.tree_leaves(params))
    return institutions * w * num_residues * _rows_for(n, ROW_ALIGN) \
        * LANES * 4


def test_reports_match_jax(runs):
    jax_out, mine, _, _ = runs
    for want, got in zip(jax_out, (mine["phase1"], mine["phase2"])):
        assert set(want) <= set(got)
        for k in ("pipeline", "params", "steps", "secure_agg",
                  "secure_backend", "institutions"):
            assert got[k] == want[k], k
        assert got["arch"] == want["arch"] == "deepseek-7b_smoke"
        assert got["device"] == "cpu"
        assert np.isfinite(got["losses"]).all()
    assert [mine["phase1"]["steps"], mine["phase2"]["steps"]] == [10, 5]
    wire = _jax_wire_bytes("deepseek_7b", 4)
    assert mine["phase1"]["bytes_per_step"] == [wire] * 10
    assert mine["phase2"]["bytes_per_step"] == [wire] * 5


def test_checkpoints_match_jax(runs):
    _, _, jdir, pdir = runs
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in pdir.iterdir())
    assert names == [f"ckpt_{s:010d}.npz" for s in (5, 10, 15)]
    with np.load(jdir / names[-1]) as a, np.load(pdir / names[-1]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k


def test_resume_equals_an_uninterrupted_run(twin, tmp_path):
    got = twin.resume_against_uninterrupted("cpu", root=tmp_path)
    assert got["resumed"]["steps"] == 5 and got["whole"]["steps"] == 15
    assert got["losses_equal"] and got["state_equal"]
