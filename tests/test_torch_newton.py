"""Port vs JAX package: the whole secure fit (the slice end to end).

The same study (made with numpy from a seed, S=3 institutions, d=8,
600 ragged rows) goes through the JAX ``secure_fit`` and the port's on
the CPU.  Held to: the same iteration count, exactly equal wire bytes,
and beta within the fixed-point quantization tolerance (S+1)/2**28 that
``benchmarks/e2e_secure_fit.py`` uses.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import SecureAggregator as JAggregator
from repro.core import centralized_fit as j_centralized_fit
from repro.core import secure_fit as j_secure_fit
from repro.core.newton import SecureFitDriver as JDriver
from repro.core.newton import should_stop_host as j_should_stop_host
from repro_torch.convert import parts_from_numpy, state_from_jax
from repro_torch.core.collective import SecureCollective
from repro_torch.core.newton import (
    SecureFitDriver,
    centralized_fit,
    prox_newton_step,
    secure_fit,
    should_stop,
    should_stop_host,
)

SIZES = (180, 200, 220)
QUANT_TOL = (len(SIZES) + 1) / 2**28


@pytest.fixture(scope="module")
def study():
    rng = np.random.default_rng(0)
    n, d = sum(SIZES), 8
    X = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, d - 1))], 1)
    beta = rng.uniform(-1.0, 1.0, size=d)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(np.float64)
    off = np.cumsum((0,) + SIZES)
    parts = [(X[a:b], y[a:b]) for a, b in zip(off[:-1], off[1:])]
    jparts = [(jnp.asarray(Xj), jnp.asarray(yj)) for Xj, yj in parts]
    return parts, jparts, (X, y)


def _check(port, jax_fit):
    assert port.converged and jax_fit.converged
    assert port.iterations == jax_fit.iterations
    assert port.bytes_transmitted == jax_fit.bytes_transmitted
    np.testing.assert_allclose(port.beta, np.asarray(jax_fit.beta),
                               rtol=0, atol=QUANT_TOL)


@pytest.mark.parametrize("protect", ["gradient", "both", "none"])
@pytest.mark.parametrize("rung,jrung", [("kernel", "pallas"),
                                        ("reference", "reference")])
def test_fused_secure_fit_matches_jax(study, protect, rung, jrung):
    parts, jparts, _ = study
    port = secure_fit(parts_from_numpy(parts, "cpu"), protect=protect,
                      aggregator=SecureCollective(backend="kernel"),
                      summaries_backend=rung, device="cpu")
    jax_fit = j_secure_fit(jparts, protect=protect,
                           aggregator=JAggregator(backend="pallas"),
                           summaries_backend=jrung)
    _check(port, jax_fit)


def test_loop_secure_fit_matches_jax(study):
    """``fused=False`` on the reference backend: the per-institution loop
    oracle, against the JAX default ``secure_fit(parts)``."""
    parts, jparts, _ = study
    port = secure_fit(parts_from_numpy(parts, "cpu"), protect="both",
                      device="cpu")
    _check(port, j_secure_fit(jparts, protect="both"))


def test_loop_on_kernel_backend_matches_fused(study):
    parts, _, _ = study
    tparts = parts_from_numpy(parts, "cpu")
    agg = SecureCollective(backend="kernel")
    loop = secure_fit(tparts, protect="both", aggregator=agg, fused=False,
                      summaries_backend="reference", device="cpu")
    fused = secure_fit(tparts, protect="both", aggregator=agg,
                       summaries_backend="reference", device="cpu")
    assert loop.iterations == fused.iterations
    assert loop.bytes_transmitted == fused.bytes_transmitted
    np.testing.assert_allclose(loop.beta, fused.beta, rtol=0,
                               atol=QUANT_TOL)


def test_centralized_fit_matches_jax(study):
    _, _, (X, y) = study
    port = centralized_fit(X, y, device="cpu")
    jax_fit = j_centralized_fit(jnp.asarray(X), jnp.asarray(y))
    assert port.iterations == jax_fit.iterations
    np.testing.assert_allclose(port.beta, np.asarray(jax_fit.beta),
                               rtol=0, atol=1e-12)


def test_resume_from_jax_state(study):
    """Two JAX rounds, then the port to convergence from the JAX state:
    the same beta and iteration count as one uninterrupted JAX fit."""
    parts, jparts, _ = study
    jagg = JAggregator(backend="pallas")
    whole = j_secure_fit(jparts, protect="both", aggregator=jagg)
    jd = JDriver(jparts, protect="both", aggregator=jagg)
    jd.step()
    jd.step()
    state = {k: np.asarray(v) for k, v in jd.state_dict().items()}
    port_state = state_from_jax(state)
    assert "key" not in port_state and port_state["iteration"] == 2
    drv = SecureFitDriver(parts_from_numpy(parts, "cpu"), protect="both",
                          aggregator=SecureCollective(backend="kernel"),
                          seed=123, device="cpu")
    drv.load_state_dict(port_state)
    _check(drv.run(), whole)


def test_port_state_dict_resume_is_bit_identical(study):
    parts, _, _ = study
    tparts = parts_from_numpy(parts, "cpu")
    agg = SecureCollective(backend="kernel")
    whole = secure_fit(tparts, protect="both", aggregator=agg, device="cpu")
    a = SecureFitDriver(tparts, protect="both", aggregator=agg, device="cpu")
    for _ in range(3):
        a.step()
    b = SecureFitDriver(tparts, protect="both", aggregator=agg, seed=9,
                        device="cpu")
    b.load_state_dict(a.state_dict())
    res = b.run()
    assert res.iterations == whole.iterations
    assert res.deviance_trace == whole.deviance_trace
    np.testing.assert_array_equal(res.beta, whole.beta)


@pytest.mark.parametrize("fused", [True, False])
def test_center_dropout_reveals_from_survivors(study, fused):
    """With center 2 offline the round reveals from points (1, 3), bit-
    identically to the all-live fit (any t-subset reconstructs exactly),
    and the wire carries only the live centers' slices."""
    parts, _, _ = study
    tparts = parts_from_numpy(parts, "cpu")
    agg = SecureCollective(backend="kernel")
    live = SecureFitDriver(tparts, protect="both", aggregator=agg,
                           fused=fused, device="cpu").run()
    drv = SecureFitDriver(tparts, protect="both", aggregator=agg,
                          fused=fused, device="cpu")
    drv.set_center_online(2, False)
    res = drv.run()
    assert all(r.centers_used == [1, 3] for r in drv.reports)
    np.testing.assert_array_equal(res.beta, live.beta)
    assert res.bytes_transmitted == 2 * live.bytes_transmitted // 3
    drv.set_center_online(3, False)
    drv.converged = False
    with pytest.raises(RuntimeError, match="threshold"):
        drv.step()


def test_midround_center_loss_and_liveness(study):
    parts, _, _ = study
    drv = SecureFitDriver(parts_from_numpy(parts, "cpu"), protect="both",
                          aggregator=SecureCollective(backend="kernel"),
                          device="cpu", deadline=1.0,
                          names=["a", "b", "c"])
    drv.set_latency("c", 5.0)
    drv._midround_hooks.append(lambda: drv.set_center_online(1, False))
    rep = drv.step()
    assert rep.responders == ["a", "b"] and rep.stragglers == ["c"]
    assert rep.centers_used == [1, 2, 3]  # the points at round start
    assert drv.centers_online == [False, True, True]
    with pytest.raises(KeyError):
        drv.set_online("zz", False)


def test_stopping_rule_matches_jax():
    for prev, obj in [(1.0, 1.0), (100.0, 100.0 + 1e-9), (np.inf, 5.0),
                      (2.0, 2.0 + 2e-8), (0.0, 1e-9)]:
        for parts in (1, 3, 8):
            want = j_should_stop_host(prev, obj, 1e-10, parts, 2.0**28)
            assert should_stop_host(prev, obj, 1e-10, parts, 2.0**28) == want
            assert bool(should_stop(torch.tensor(prev, dtype=torch.float64),
                                    torch.tensor(obj, dtype=torch.float64),
                                    1e-10, parts, 2.0**28)) == want


def test_prox_step_matches_jax_fista():
    from repro.core.newton import prox_newton_step as j_prox

    rng = np.random.default_rng(3)
    A = rng.normal(size=(6, 6))
    H = A @ A.T + 6 * np.eye(6)
    g, beta = rng.normal(size=6), 0.1 * rng.normal(size=6)
    for l1 in (0.0, 0.5):
        got = prox_newton_step(torch.as_tensor(beta), torch.as_tensor(H),
                               torch.as_tensor(g), 1.0, l1)
        want = j_prox(jnp.asarray(beta), jnp.asarray(H), jnp.asarray(g),
                      1.0, l1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-12)


def test_scan_rounds_need_the_fused_kernel_path(study):
    """Scan rounds run on the fused kernel path; the loop oracle and the
    reference backend refuse them, as they refuse a fused fit."""
    parts, _, _ = study
    res = secure_fit(parts_from_numpy(parts, "cpu"), rounds="scan",
                     aggregator=SecureCollective(backend="kernel"),
                     device="cpu")
    assert res.converged
    with pytest.raises(ValueError, match="fused kernel path"):
        secure_fit(parts_from_numpy(parts, "cpu"), rounds="scan",
                   device="cpu")
    with pytest.raises(ValueError, match="kernel backend"):
        secure_fit(parts_from_numpy(parts, "cpu"), fused=True, device="cpu")
