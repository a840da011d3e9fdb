"""The port's command lines against the JAX package's: ``launch.train`` in
every logreg mode the paper's studies run (fused rounds on each study,
scan rounds, λ selection, L1, checkpoint and resume), the LM trainer
with a failure and compression, and ``launch.serve`` on three archs.

Each mode runs at ``--scale 0.02`` through both packages' ``main``.  The
port's JSON report has every key of the JAX package's and ``device``.
The fields that do not depend on the draw are equal (samples, features,
folds, λs, protect, wire bytes a round, parameters); the rest hold their
contracts.  JAX seeds a study with ``hash(name)`` and the port with
crc32, so the draws themselves differ.
"""
import json
import shutil

import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro_torch.core.collective import SecureCollective
from repro_torch.core.shamir import ShamirScheme
from repro_torch.launch import serve, train

SCALE = "0.02"
LOGREG = ["--arch", "logreg_paper", "--scale", SCALE]
FUSED = ["--fused", "--protect", "both"]
# the paper's four studies: (name, features, institutions)
STUDIES = {"insurance": (84, 5), "parkinsons.motor": (20, 5),
           "parkinsons.total": (20, 5), "synthetic": (6, 6)}


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


def _jax(argv, tmp_path, name="jax.json"):
    """The JAX package's report (its ``main`` returns nothing)."""
    out = tmp_path / name
    jtrain.main(argv + ["--out", str(out)])
    return json.loads(out.read_text())


def _both(argv, tmp_path):
    want = _jax(argv, tmp_path)
    got = train.main(argv + ["--device", "cpu"])
    assert set(want) | {"device"} <= set(got), set(want) - set(got)
    assert got["device"] == "cpu"
    return want, got


def _round_bytes(d, parts, centers=3):
    agg = SecureCollective(scheme=ShamirScheme(threshold=2,
                                               num_shares=centers,
                                               backend="kernel"))
    return agg.round_bytes(d, parts, "both", include_count=True,
                           num_live_centers=centers)


def _check_fit(want, got, study, rounds_bytes):
    d, parts = STUDIES[study]
    for k in ("pipeline", "study", "samples", "features", "protect"):
        assert got[k] == want[k], k
    assert got["features"] == d
    for rep in (want, got):
        assert rep["converged"] and rep["r2_vs_gold"] > 0.999999
        assert rep["iterations"] <= 10  # paper Fig. 3: 6-8
        assert rep["bytes_transmitted"] == rep["iterations"] * rounds_bytes


@pytest.mark.parametrize("study", sorted(STUDIES))
def test_fused_fit_on_each_study(study, tmp_path):
    want, got = _both(LOGREG + ["--study", study] + FUSED, tmp_path)
    _check_fit(want, got, study, _round_bytes(*STUDIES[study]))


def test_scan_rounds_on_synthetic(tmp_path):
    want, got = _both(LOGREG + ["--study", "synthetic", "--rounds", "scan"]
                      + FUSED, tmp_path)
    _check_fit(want, got, "synthetic", _round_bytes(6, 6))
    step = train.main(LOGREG + ["--study", "synthetic"] + FUSED
                      + ["--device", "cpu"])
    assert got["iterations"] == step["iterations"]
    assert got["bytes_transmitted"] == step["bytes_transmitted"]


def test_select_lambda_on_insurance(tmp_path):
    want, got = _both(LOGREG + ["--study", "insurance", "--select-lambda",
                                "10,3,1,0.3", "--folds", "3"], tmp_path)
    for k in ("pipeline", "study", "mode", "lambdas", "folds", "features",
              "protect", "bytes_per_round"):
        assert got[k] == want[k], k
    assert got["lambdas"] == [10.0, 3.0, 1.0, 0.3]
    for rep in (want, got):
        assert rep["lambda_1se"] >= rep["lambda_best"]
        assert rep["lambda_1se"] in rep["lambdas"]
        assert len(rep["cv_mean_deviance"]) == 4
        assert rep["bytes_transmitted"] >= (rep["secure_rounds"]
                                            * rep["bytes_per_round"] // 3)


def test_l1_on_parkinsons_total(tmp_path):
    want, got = _both(LOGREG + ["--study", "parkinsons.total", "--l1",
                                "0.1"], tmp_path)
    for k in ("pipeline", "study", "regularization", "features"):
        assert got[k] == want[k], k
    for rep in (want, got):
        assert rep["converged"] and rep["iterations"] <= 10
        assert 0 < rep["nonzero_coefs"] <= rep["features"]


def test_checkpoint_stop_and_resume(tmp_path):
    """A checkpointed run, then the same run stopped after its third
    round (the later checkpoints taken away) and resumed: the same
    iterations and the same beta, bit for bit (a reveal does not depend
    on the sharing draws)."""
    argv = LOGREG + ["--study", "parkinsons.total"] + FUSED
    want = _jax(argv + ["--checkpoint-dir", str(tmp_path / "jck")],
                tmp_path)
    whole = tmp_path / "whole"
    got = train.main(argv + ["--checkpoint-dir", str(whole), "--device",
                             "cpu"])
    assert set(want) | {"device"} <= set(got)
    # each package keeps its last three rounds' checkpoints (its own
    # iteration count: the draws differ)
    for d, rep in ((tmp_path / "jck", want), (whole, got)):
        n = rep["iterations"]
        assert sorted(p.name for p in d.iterdir()) == [
            f"ckpt_{s:010d}.npz" for s in (n - 2, n - 1, n)]
    n = got["iterations"]
    stopped = tmp_path / "stopped"
    shutil.copytree(whole, stopped)
    for p in stopped.iterdir():
        if int(p.name[5:15]) > n - 2:
            p.unlink()
    res = train.main(argv + ["--checkpoint-dir", str(stopped), "--resume",
                             "--device", "cpu"])
    assert res["iterations"] == n and res["converged"]
    assert res["bytes_transmitted"] == 2 * _round_bytes(20, 5)
    assert res["max_abs_err_vs_gold"] == got["max_abs_err_vs_gold"]
    final = f"ckpt_{n:010d}.npz"
    with np.load(whole / final) as a, np.load(stopped / final) as b:
        assert np.array_equal(a["beta"], b["beta"])


def test_lm_trainer_with_a_failure_and_compression(tmp_path):
    argv = ["--arch", "qwen2_5_32b", "--smoke", "--steps", "4", "--batch",
            "4", "--seq-len", "32", "--institutions", "4", "--fail-at", "2",
            "--compress"]
    want, got = _both(argv, tmp_path)
    for k in ("pipeline", "arch", "params", "steps", "secure_agg",
              "secure_backend", "institutions"):
        assert got[k] == want[k], k
    assert np.isfinite(got["losses"]).all() and len(got["losses"]) == 4


@pytest.mark.parametrize("arch", ["qwen2_5_32b", "deepseek_v2_lite",
                                  "rwkv6_3b"])
def test_serve(arch):
    argv = ["--arch", arch, "--requests", "3", "--batch", "2",
            "--prompt-len", "16", "--new-tokens", "4"]
    want = jserve.main(argv)
    got = serve.main(argv + ["--device", "cpu"])
    assert set(want) | {"device"} <= set(got)
    for k in ("arch", "requests", "batches", "new_tokens_per_request",
              "tokens_generated"):
        assert got[k] == want[k], k
    assert got["batches"] == 2 and got["tokens_generated"] == 12
    assert got["nonfinite_logits"] == 0 and got["device"] == "cpu"
