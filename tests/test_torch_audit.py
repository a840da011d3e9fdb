"""The runtime privacy audit of the port (``repro_torch.obs.audit``).

The ledger (``repro_torch.obs.ledger``) counts every call of a named
boundary; the audit reconciles an ungated run's counts against the census
of the gate's certified run of the same round, key ``(site, shape)``:
recorded = rounds x census, for every spec (the psum specs on every rank
of a spawned gloo world), with the deliberate extra reveal FLAGGED.  The
JAX package's counterpart is ``tests/test_obs.py``; its audit cannot run
under the installed jax, so the port is held to its documented
reconciliation rule (``src/repro/obs/audit.py``) and its fixture
(``extra_reveal_fixture``).  Everything runs on the CPU at the specs' toy
shapes; a fit of the fused driver stands in for ``chip_smoke.py``'s
full-size reconciliation.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.analysis.drivers import all_driver_specs, certify, run_world
from repro_torch.obs import audit, ledger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SPECS = {s.name: s for s in all_driver_specs()}
_LOCAL = [s.name for s in all_driver_specs() if not s.world]
_WORLD = [s.name for s in all_driver_specs() if s.world]


@pytest.fixture(autouse=True)
def _ledger_clean():
    ledger.disable()
    ledger.reset()
    yield
    ledger.disable()
    ledger.reset()


@pytest.mark.parametrize("name", _LOCAL)
def test_audit_spec_reconciles(name):
    a = audit.audit_spec(_SPECS[name], "cpu")
    assert a.ok, a.findings()
    assert a.recorded == {k: n * a.rounds for k, n in a.census.items()}
    assert a.rounds == (1 if "fused" in name else
                        3 if "fit_scan" in name else 2)


def test_psum_specs_reconcile_on_every_rank():
    results = run_world([_SPECS[n] for n in _WORLD], "cpu", audit=True)
    for name in _WORLD:
        for r in results[name]:
            a = r["audit"]
            assert a.ok and a.rounds == 1, a.findings()
        combined = audit._world_audit(name, results[name])
        assert combined.ok and combined.ranks == len(results[name])


def test_round_census_is_the_ledgers_key():
    """The gate's boundary calls and the ledger's counts of the same
    gated run agree key for key: the two hooks see the same calls."""
    spec = _SPECS["selection_scan[protect=gradient]"]
    with ledger.capture() as cap:
        _, trace = certify(spec, "cpu")
    census, rounds, _ = trace.round_census()
    assert audit.recorded_census(cap) == trace.counts() == \
        {k: n * rounds for k, n in census.items()}


def test_extra_reveal_is_flagged():
    a = audit.extra_reveal_fixture(_SPECS["secure_fit_fused[protect=both]"],
                                   "cpu")
    assert not a.ok
    findings = a.findings()
    assert any("UNCERTIFIED declassification" in f and "_reveal_flat" in f
               for f in findings)


def test_audit_result_needs_the_self_test_to_fire():
    spec = _SPECS["secure_fit_fused[protect=both]"]
    clean = audit.audit_spec(spec, "cpu")
    assert audit.AuditResult([clean], None).ok
    blind = audit.AuditResult([clean], clean)  # a "fixture" that passed
    assert not blind.ok
    assert any(line.startswith("BLIND") for line in blind.lines())


def test_a_missing_round_is_a_finding():
    spec = _SPECS["secure_fit_scan[protect=both]"]
    a = audit.audit_spec(spec, "cpu")
    short = audit.SpecAudit(a.name, a.census, a.rounds + 1, a.recorded)
    assert not short.ok
    assert all("certified site never executed" in f
               for f in short.findings())


def test_a_fit_records_iterations_times_the_certified_round():
    """``chip_smoke.py`` phase 15 (b) at toy size: certify one fused round
    of a fit's configuration, run the whole fit under the ledger, and
    every (site, shape) count is iterations x the certified census."""
    from repro_torch.analysis.drivers import DriverSpec
    from repro_torch.analysis.taint import PUBLIC, SECRET
    from repro_torch.core.batched_summaries import pack_partitions
    from repro_torch.core.collective import SecureCollective
    from repro_torch.core.newton import _fused_secure_iteration, secure_fit

    rng = np.random.default_rng(3)
    parts = []
    for n in (40, 37, 44):
        X = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, 4))], 1)
        y = (rng.random(n) < 0.4).astype(np.float64)
        parts.append((torch.as_tensor(X), torch.as_tensor(y)))
    agg = SecureCollective(backend="kernel")
    for protect in ("both", "gradient"):
        def setup(device, protect=protect):
            packed = pack_partitions(parts)

            def fn(beta, gen, packed):
                return _fused_secure_iteration(
                    beta, gen, packed, 1.0, agg, protect, 0.0,
                    summaries_backend="kernel")

            return fn, (torch.zeros(5, dtype=torch.float64),
                        torch.Generator().manual_seed(0), packed), \
                (PUBLIC, PUBLIC, SECRET)

        rep, trace = certify(DriverSpec(f"fit[{protect}]", setup, 2), "cpu")
        assert rep.ok, rep.format(verbose=True)
        census, rounds, _ = trace.round_census()
        assert rounds == 1
        with ledger.capture() as cap:
            res = secure_fit(parts, protect=protect, aggregator=agg,
                             summaries_backend="kernel", device="cpu")
        a = audit.reconcile(f"fit[{protect}]", census, res.iterations, cap)
        assert res.iterations >= 3 and a.ok, a.findings()


def test_audit_cli_subprocess(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    prom = tmp_path / "audit.prom"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "audit", "--device", "cpu",
         "--json", "--textfile", str(prom)],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    res = json.loads(out.stdout)
    assert res["ok"] and len(res["specs"]) == 12
    assert all(s["ok"] for s in res["specs"])
    assert not res["fixture"]["ok"]
    assert "_reveal_flat" in prom.read_text()


def test_summary_cli_reads_a_span_file(tmp_path):
    from repro_torch.obs import trace

    tr = trace.enable()
    try:
        with trace.span("protect", "p"):
            pass
        path = tmp_path / "spans.jsonl"
        tr.export_jsonl(path)
    finally:
        trace.disable()
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "summary", "--trace",
         str(path)], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "protect" in out.stdout
