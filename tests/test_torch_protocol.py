"""Port vs JAX package: the deployment drivers and the scan-block rounds.

The same study (numpy, from a seed: S=3 institutions, d=8, 600 ragged
rows) goes through the JAX ``StudyCoordinator`` / ``SecureFitDriver`` and
the port's on the CPU.  Held to: per-round objectives and betas equal to
the float64 rounding floor on the reference rung (1e-12), exactly equal
wire bytes, the same fault behaviour (stragglers, center dropout, churn,
re-provisioning), and for scan blocks the same iterations with beta
within the fixed-point quantization (S+1)/2**28.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import SecureAggregator as JAggregator
from repro.core.newton import SecureFitDriver as JDriver
from repro.core.protocol import Institution as JInstitution
from repro.core.protocol import StudyCoordinator as JCoordinator
from repro_torch.convert import coordinator_state_from_jax, parts_from_numpy
from repro_torch.core.collective import SecureCollective
from repro_torch.core.newton import SecureFitDriver, secure_fit
from repro_torch.core.protocol import Institution, StudyCoordinator

SIZES = (180, 200, 220)
QUANT_TOL = (len(SIZES) + 1) / 2**28
ROUND_TOL = 1e-12


@pytest.fixture(scope="module")
def parts():
    rng = np.random.default_rng(0)
    n, d = sum(SIZES), 8
    X = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, d - 1))], 1)
    beta = rng.uniform(-1.0, 1.0, size=d)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(np.float64)
    off = np.cumsum((0,) + SIZES)
    return [(X[a:b], y[a:b]) for a, b in zip(off[:-1], off[1:])]


def _pair(parts, backend="reference", names=None, **kw):
    names = names or [f"inst{j}" for j in range(len(parts))]
    port = StudyCoordinator(
        [Institution(nm, torch.as_tensor(X), torch.as_tensor(y))
         for nm, (X, y) in zip(names, parts)],
        aggregator=SecureCollective(backend=backend), device="cpu", **kw)
    jax_ = JCoordinator(
        [JInstitution(nm, jnp.asarray(X), jnp.asarray(y))
         for nm, (X, y) in zip(names, parts)],
        aggregator=JAggregator(backend="pallas" if backend == "kernel"
                               else "reference"), **kw)
    return port, jax_


def _lockstep(port, jax_, rounds):
    for _ in range(rounds):
        rp, rj = port.step(), jax_.step()
        assert rp.iteration == rj.iteration
        assert rp.responders == rj.responders
        assert rp.stragglers == rj.stragglers
        assert rp.centers_used == rj.centers_used
        assert rp.bytes_transmitted == rj.bytes_transmitted
        np.testing.assert_allclose(rp.objective, rj.objective, rtol=ROUND_TOL)
        np.testing.assert_allclose(port.beta.numpy(), np.asarray(jax_.beta),
                                   rtol=0, atol=ROUND_TOL)
        assert port.converged == jax_.converged


@pytest.mark.parametrize("protect", ["both", "gradient", "none"])
@pytest.mark.parametrize("backend,fused", [("reference", False),
                                           ("kernel", False),
                                           ("kernel", True)])
def test_coordinator_rounds_match_jax(parts, protect, backend, fused):
    port, jax_ = _pair(parts, backend, protect=protect, fused=fused)
    _lockstep(port, jax_, 7)
    assert port.converged


def test_stragglers_are_excluded(parts):
    port, jax_ = _pair(parts, protect="both", deadline=1.0)
    port.institutions[1].latency = 5.0
    jax_.institutions[1].latency = 5.0
    _lockstep(port, jax_, 2)
    assert port.reports[-1].stragglers == ["inst1"]
    assert port.reports[-1].responders == ["inst0", "inst2"]
    port.institutions[1].latency = 0.0
    jax_.institutions[1].latency = 0.0
    _lockstep(port, jax_, 2)  # the straggler rejoins
    assert port.reports[-1].stragglers == []


@pytest.mark.parametrize("fused", [False, True])
def test_center_dropout(parts, fused):
    """One center down: the round reveals from the other two, as JAX does
    and at the same bytes; two down: the same RuntimeError, with the
    round state untouched; a mid-round death below t aborts the round."""
    port, jax_ = _pair(parts, "kernel", protect="both", fused=fused)
    port.centers[1].online = False
    jax_.centers[1].online = False
    _lockstep(port, jax_, 2)
    assert port.reports[-1].centers_used == [1, 3]
    port.centers[2].online = False
    jax_.centers[2].online = False
    for c in (port, jax_):
        with pytest.raises(RuntimeError, match="threshold"):
            c.step()
    assert port.iteration == 2 and len(port.trace) == 2
    port.centers[1].online = True
    port._midround_hooks.append(lambda: setattr(port.centers[0], "online",
                                                False))
    with pytest.raises(RuntimeError, match="threshold"):
        port.step()
    assert port.iteration == 2


def test_membership_changes_between_rounds(parts):
    """remove_institution and add_institution between rounds move the
    port and the JAX package alike (the churned pack is evicted)."""
    port, jax_ = _pair(parts, "kernel", protect="both", fused=True)
    _lockstep(port, jax_, 1)
    port.remove_institution("inst2")
    jax_.remove_institution("inst2")
    _lockstep(port, jax_, 1)
    assert port.reports[-1].responders == ["inst0", "inst1"]
    X, y = parts[2]
    port.add_institution(Institution("late", torch.as_tensor(X),
                                     torch.as_tensor(y)))
    jax_.add_institution(JInstitution("late", jnp.asarray(X),
                                      jnp.asarray(y)))
    _lockstep(port, jax_, 2)
    assert port.reports[-1].responders == ["inst0", "inst1", "late"]


def test_provision_center_at_a_spare_point(parts):
    port, jax_ = _pair(parts, "kernel", protect="both", num_centers=2)
    assert [c.index for c in port.centers] == [1, 2]
    _lockstep(port, jax_, 1)
    port.centers[0].online = False
    jax_.centers[0].online = False
    for c in (port, jax_):
        with pytest.raises(RuntimeError, match="threshold"):
            c.step()
    assert port.provision_center().index == 3  # the fresh point first
    assert jax_.provision_center().index == 3
    _lockstep(port, jax_, 2)
    assert port.reports[-1].centers_used == [2, 3]
    with pytest.raises(RuntimeError, match="still online"):
        port.provision_center(2)
    with pytest.raises(ValueError, match="num_centers"):
        _pair(parts, num_centers=1)


def test_coordinator_scan_blocks_match_step_and_jax(parts):
    step, _ = _pair(parts, "kernel", protect="both", fused=True)
    step.run()
    port, jax_ = _pair(parts, "kernel", protect="both", fused=True,
                       rounds="scan", rounds_per_sync=3)
    port.run()
    jax_.run()
    assert port.iteration == step.iteration == jax_.iteration
    assert port.converged and jax_.converged
    assert [r.bytes_transmitted for r in port.reports] == \
        [r.bytes_transmitted for r in jax_.reports]
    np.testing.assert_allclose(port.beta.numpy(), step.beta.numpy(),
                               rtol=0, atol=QUANT_TOL)
    np.testing.assert_allclose(port.beta.numpy(), np.asarray(jax_.beta),
                               rtol=0, atol=QUANT_TOL)
    with pytest.raises(ValueError, match="fused"):
        _pair(parts, "kernel", rounds="scan")


def test_coordinator_resume(parts):
    """A port checkpoint taken mid-study resumes bit-identically, across
    step and scan blocks; a converted JAX checkpoint continues to the
    same beta as the uninterrupted JAX study."""
    whole, jax_ = _pair(parts, "kernel", protect="both", fused=True,
                        rounds="scan", rounds_per_sync=2)
    whole.run()
    a, _ = _pair(parts, "kernel", protect="both", fused=True,
                 rounds="scan", rounds_per_sync=2)
    a.step_block(3)
    b, _ = _pair(parts, "kernel", protect="both", fused=True, seed=7,
                 rounds="scan", rounds_per_sync=2)
    b.load_state_dict(a.state_dict())
    b.run()
    assert b.trace == whole.trace
    assert torch.equal(b.beta, whole.beta)

    jax_.step()
    jax_.step()
    state = coordinator_state_from_jax(
        {k: np.asarray(v) for k, v in jax_.state_dict().items()})
    assert "key" not in state
    jax_.run()
    c, _ = _pair(parts, "kernel", protect="both", fused=True)
    c.load_state_dict(state)
    c.run()
    assert c.iteration == jax_.iteration
    np.testing.assert_allclose(c.beta.numpy(), np.asarray(jax_.beta),
                               rtol=0, atol=QUANT_TOL)


def _tparts(parts):
    return parts_from_numpy(parts, "cpu")


@pytest.mark.parametrize("protect", ["both", "gradient", "none"])
@pytest.mark.parametrize("rung", ["kernel", "reference"])
def test_secure_fit_scan_matches_step_and_jax(parts, protect, rung):
    agg = SecureCollective(backend="kernel")
    kw = dict(protect=protect, aggregator=agg, summaries_backend=rung,
              device="cpu")
    step = secure_fit(_tparts(parts), **kw)
    scan = secure_fit(_tparts(parts), rounds="scan", **kw)
    jscan = JDriver([(jnp.asarray(X), jnp.asarray(y)) for X, y in parts],
                    protect=protect, aggregator=JAggregator(backend="pallas"),
                    rounds="scan", summaries_backend=(
                        "pallas" if rung == "kernel" else rung)).run()
    for other in (step, jscan):
        assert scan.converged and other.converged
        assert scan.iterations == other.iterations
        assert scan.bytes_transmitted == other.bytes_transmitted
        np.testing.assert_allclose(scan.beta, np.asarray(other.beta),
                                   rtol=0, atol=QUANT_TOL)


def test_scan_resume_cut_mid_block_is_bit_identical(parts):
    agg = SecureCollective(backend="kernel")
    kw = dict(protect="both", aggregator=agg, rounds="scan",
              rounds_per_sync=3, device="cpu")
    whole = SecureFitDriver(_tparts(parts), **kw).run()
    a = SecureFitDriver(_tparts(parts), **kw)
    a.step_block(2)  # cut inside the first block of 3
    assert a.iteration == 2 and a._round_base == 2
    b = SecureFitDriver(_tparts(parts), seed=99, **kw)
    b.load_state_dict(a.state_dict())
    res = b.run()
    assert res.iterations == whole.iterations
    assert res.deviance_trace == whole.deviance_trace
    assert res.bytes_transmitted == whole.bytes_transmitted
    np.testing.assert_array_equal(res.beta, whole.beta)


def test_scan_block_overshoot_skips_and_budget(parts):
    """A block longer than the fit skips its settled slots (the slot
    counter still advances); a max_iter budget ends the fit unconverged
    with the last round's update applied, as the step path does."""
    agg = SecureCollective(backend="kernel")
    drv = SecureFitDriver(_tparts(parts), protect="both", aggregator=agg,
                          rounds="scan", device="cpu")
    reports = drv.step_block(12)
    assert drv.converged and len(reports) == drv.iteration < 12
    assert drv._round_base == 12
    assert drv.step() is reports[-1]  # stepped past convergence
    kw = dict(protect="both", aggregator=agg, max_iter=3, device="cpu")
    short_step = secure_fit(_tparts(parts), **kw)
    short_scan = secure_fit(_tparts(parts), rounds="scan", **kw)
    assert not short_scan.converged and short_scan.iterations == 3
    np.testing.assert_allclose(short_scan.beta, short_step.beta, rtol=0,
                               atol=QUANT_TOL)
    with pytest.raises(ValueError, match="rounds_per_sync"):
        SecureFitDriver(_tparts(parts), aggregator=agg, rounds="scan",
                        rounds_per_sync=0, device="cpu")
    with pytest.raises(RuntimeError, match="rounds='scan'"):
        SecureFitDriver(_tparts(parts), aggregator=agg,
                        device="cpu").step_block()
