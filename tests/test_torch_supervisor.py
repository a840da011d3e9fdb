"""Port vs JAX package: fault-tolerant round supervision of the three drivers.

The chaos invariant (``runtime/supervisor.py``): any survivable
``FailureInjector`` schedule converges to the fault-free oracle's beta
within fixed-point quantization (S+1)/2**28 on every driver, center-fault
schedules bit-identically; unsurvivable schedules raise the driver's own
``RuntimeError`` and leave its state as it was.  The cases mirror
``tests/test_supervisor.py`` on the port's drivers (CPU, S=4 institutions,
d=5, 150 rows each, numpy data from a seed), against the port's own
fault-free oracle.  One case per driver kind runs the same schedule
through the JAX package's supervisor on the same data and must give the
same rounds, retries, aborted attempts, backoff and degraded rounds, and
beta within the quantization.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import SecureAggregator as JAggregator
from repro.core.newton import SecureFitDriver as JDriver
from repro.core.protocol import Institution as JInstitution
from repro.core.protocol import StudyCoordinator as JCoordinator
from repro.runtime import FailureInjector as JInjector
from repro.runtime import FaultPolicy as JPolicy
from repro.runtime import RoundSupervisor as JSupervisor
from repro.runtime import StragglerPolicy as JStraggler
from repro.selection import SelectionCoordinator as JSelection
from repro.selection import assign_folds as j_assign_folds
from repro_torch.core.collective import SecureCollective
from repro_torch.core.newton import SecureFitDriver
from repro_torch.core.protocol import Institution, StudyCoordinator
from repro_torch.core.shamir import ShamirScheme
from repro_torch.runtime import (
    FailureInjector,
    FaultPolicy,
    RoundSupervisor,
    StragglerPolicy,
)
from repro_torch.selection import SelectionCoordinator

NUM_INST = 4
NAMES = [f"i{k}" for k in range(NUM_INST)]
QUANT = (NUM_INST + 1) * 0.5 / 2**28


def _study(seed, rows, d):
    rng = np.random.default_rng(seed)
    n = rows * NUM_INST
    X = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, d - 1))], 1)
    beta = rng.uniform(-1.0, 1.0, size=d)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(np.float64)
    return [(X[j * rows:(j + 1) * rows], y[j * rows:(j + 1) * rows])
            for j in range(NUM_INST)]


@pytest.fixture(scope="module")
def study():
    return _study(3, 150, 5)


def make_insts(study):
    return [Institution(n, torch.as_tensor(X), torch.as_tensor(y))
            for n, (X, y) in zip(NAMES, study)]


def make_driver(kind, study, **kw):
    kernel = SecureCollective(backend="kernel")
    if kind == "coordinator":
        return StudyCoordinator(make_insts(study), lam=1.0,
                                protect="gradient", device="cpu", **kw)
    if kind == "coordinator-fused":
        return StudyCoordinator(make_insts(study), lam=1.0,
                                protect="gradient", fused=True,
                                aggregator=kernel, device="cpu", **kw)
    if kind == "secure_fit":
        return SecureFitDriver(study, lam=1.0, protect="gradient",
                               names=NAMES, fused=False, device="cpu", **kw)
    if kind == "secure_fit-fused":
        return SecureFitDriver(study, lam=1.0, protect="gradient",
                               names=NAMES, aggregator=kernel, fused=True,
                               device="cpu", **kw)
    raise ValueError(kind)


def final_beta(driver):
    return driver.beta.numpy()


@pytest.fixture(scope="module")
def oracle_betas(study):
    """Fault-free converged beta per driver kind (the chaos oracle)."""
    out = {}
    for kind in ("coordinator", "coordinator-fused", "secure_fit",
                 "secure_fit-fused"):
        drv = make_driver(kind, study)
        RoundSupervisor(drv, policy=FaultPolicy()).run(max_rounds=50)
        out[kind] = final_beta(drv)
    return out


def policy(**kw):
    kw.setdefault("max_retries", 4)
    kw.setdefault("heartbeat_timeout", 3.0)
    kw.setdefault("straggler",
                  StragglerPolicy(deadline=2.0, quorum_fraction=0.5))
    return FaultPolicy(**kw)


# survivable schedules that heal before the ~6-9 round fit converges
SURVIVABLE = {
    "flap": {2: [("flap", "i1", 3.0)]},
    "straggle_burst": {2: [("straggle", "i2", 9.0, 2.0)]},
    "crash_recover": {2: [("crash", "i0")], 4: [("recover", "i0")]},
    "center_crash_recover": {
        2: [("center_crash", 2)], 4: [("center_recover", 2)],
    },
    "center_midround": {3: [("center_midround", 1)]},
    "mixed": {
        2: [("flap", "i1", 5.0)],
        3: [("center_crash", 2)],
        4: [("recover", "i1")],
        5: [("center_midround", 1)],
    },
}
CENTER_ONLY = {"center_crash_recover", "center_midround"}
TIER1_KINDS = ("coordinator", "secure_fit-fused")
SLOW_KINDS = ("coordinator-fused", "secure_fit")


def run_chaos(kind, study, schedule, oracle_betas, **pol_kw):
    drv = make_driver(kind, study)
    sup = RoundSupervisor(drv, policy=policy(**pol_kw),
                          injector=FailureInjector(schedule))
    sup.run(max_rounds=60)
    assert drv.converged
    err = np.abs(final_beta(drv) - oracle_betas[kind]).max()
    assert err <= QUANT, (kind, err)
    return drv, sup, err


@pytest.mark.parametrize("schedule", sorted(SURVIVABLE))
@pytest.mark.parametrize("kind", TIER1_KINDS)
def test_survivable_schedule_matches_oracle(kind, schedule, study,
                                            oracle_betas):
    _, _, err = run_chaos(kind, study, SURVIVABLE[schedule], oracle_betas)
    if schedule in CENTER_ONLY:
        assert err == 0.0  # any >= t points reveal the same field element


@pytest.mark.slow
@pytest.mark.parametrize("schedule", sorted(SURVIVABLE))
@pytest.mark.parametrize("kind", SLOW_KINDS)
def test_survivable_schedule_matches_oracle_full_matrix(kind, schedule,
                                                        study, oracle_betas):
    run_chaos(kind, study, SURVIVABLE[schedule], oracle_betas)


def test_scan_blocks_under_a_center_schedule(study, oracle_betas):
    """A scan-resident fit: one supervised round is one block of 2 Newton
    rounds; center faults at block boundaries leave beta bit-identical."""
    drv = SecureFitDriver(study, lam=1.0, protect="gradient", names=NAMES,
                          aggregator=SecureCollective(backend="kernel"),
                          rounds="scan", rounds_per_sync=2, device="cpu")
    sup = RoundSupervisor(drv, policy=policy(), injector=FailureInjector(
        {2: [("center_midround", 1), ("center_midround", 2)]}))
    sup.run(max_rounds=30)
    assert drv.converged
    assert sup.rounds[1].aborted_attempts == 1
    assert np.array_equal(final_beta(drv), oracle_betas["secure_fit-fused"])


def test_degraded_round_telemetry(study, oracle_betas):
    _, sup, _ = run_chaos("coordinator", study, SURVIVABLE["mixed"],
                          oracle_betas)
    assert [r for r in sup.rounds if r.degraded]
    for rec in sup.rounds:
        if rec.report is None:
            continue
        assert rec.report.retries == rec.retries
        assert rec.report.backoff_seconds == rec.backoff_seconds
        assert rec.report.aborted_attempts == rec.aborted_attempts
        assert rec.report.degraded == rec.degraded
    drv = make_driver("coordinator", study)
    sup0 = RoundSupervisor(drv, policy=policy())
    sup0.run(max_rounds=50)
    assert sup0.total_retries == 0 and sup0.total_backoff == 0.0
    assert all(not r.degraded for r in sup0.rounds)
    assert all(r.report.retries == 0 and not r.report.degraded
               for r in sup0.rounds)


def test_midround_below_threshold_aborts_and_reshares(study, oracle_betas):
    """Both centers of a t=2 reveal die between protect and reveal: the
    round aborts, the supervisor re-provisions, the retry re-shares."""
    schedule = {2: [("center_midround", 1), ("center_midround", 2)]}
    drv, sup, err = run_chaos("coordinator", study, schedule, oracle_betas)
    rec = sup.rounds[1]
    assert rec.aborted_attempts == 1 and rec.retries >= 1
    assert rec.report.aborted_attempts == 1
    assert err == 0.0


def test_center_reprovision_uses_fresh_point(study, oracle_betas):
    """A w=4 scheme run with 3 centers: the spare evaluation point is the
    replacement's fresh identity after a crash."""
    agg = SecureCollective(scheme=ShamirScheme(threshold=2, num_shares=4))
    drv = StudyCoordinator(make_insts(study), lam=1.0, protect="gradient",
                           aggregator=agg, num_centers=3, device="cpu")
    sup = RoundSupervisor(drv, policy=policy(), injector=FailureInjector(
        {2: [("center_crash", 1), ("center_crash", 2)]}))
    sup.run(max_rounds=60)
    assert drv.converged
    assert 4 in {c.index for c in drv.centers if c.online}
    err = np.abs(final_beta(drv) - oracle_betas["coordinator"]).max()
    assert err <= QUANT


@pytest.mark.parametrize("kind", ("coordinator", "secure_fit"))
def test_unsurvivable_center_loss_raises_exact_error(kind, study):
    drv = make_driver(kind, study)
    sup = RoundSupervisor(
        drv, policy=policy(max_retries=2, reprovision_after=0),
        injector=FailureInjector(
            {1: [("center_crash", 1), ("center_crash", 2)]}))
    with pytest.raises(RuntimeError,
                       match="aggregate unrecoverable this round"):
        sup.step()
    assert drv.iteration == 0


@pytest.mark.parametrize("kind", ("coordinator", "secure_fit"))
def test_unsurvivable_quorum_raises_exact_error(kind, study):
    drv = make_driver(kind, study, min_responders=2)
    sup = RoundSupervisor(
        drv, policy=policy(max_retries=2),
        injector=FailureInjector({1: [("crash", n) for n in NAMES]}))
    with pytest.raises(RuntimeError, match="responders < min"):
        sup.step()
    assert drv.iteration == 0


def test_unknown_driver_is_refused():
    with pytest.raises(TypeError, match="don't know how to supervise"):
        RoundSupervisor(object())


# -- the selection driver -----------------------------------------------------

SEL_KW = dict(lambdas=(4.0, 1.0, 0.25), num_folds=3, rounds_per_sync=4,
              max_rounds=12, seed=0, summaries_backend="reference")


@pytest.fixture(scope="module")
def sel_study():
    return _study(5, 120, 4)


def _jax_fold_ids(parts):
    return {n: np.asarray(j_assign_folds(X.shape[0], SEL_KW["num_folds"],
                                         n, 0))
            for n, (X, _) in zip(NAMES, parts)}


def make_selection(sel_study):
    """The port's coordinator on the JAX package's fold ids (the two draw
    folds from different generators)."""
    sel = SelectionCoordinator(make_insts(sel_study), device="cpu",
                               **SEL_KW)
    sel.folds = {n: torch.from_numpy(ids.astype(np.int32))
                 for n, ids in _jax_fold_ids(sel_study).items()}
    return sel


@pytest.fixture(scope="module")
def sel_oracle(sel_study):
    return make_selection(sel_study).run_path()


SEL_CENTER_SCHEDULE = {
    1: [("center_crash", 2)],
    3: [("center_midround", 1)],
    4: [("center_recover", 2)],
}


def test_selection_center_faults_bit_identical(sel_study, sel_oracle):
    sel = make_selection(sel_study)
    sup = RoundSupervisor(sel, policy=policy(),
                          injector=FailureInjector(SEL_CENTER_SCHEDULE))
    report = sup.run(max_rounds=40)
    assert report.lambda_1se == sel_oracle.lambda_1se
    assert np.array_equal(np.asarray(report.beta),
                          np.asarray(sel_oracle.beta))
    aborted = [r for r in sup.rounds if r.aborted_attempts]
    assert aborted and aborted[0].round_no == 3


def test_selection_flap_healing_between_chunks(sel_study, sel_oracle):
    sel = make_selection(sel_study)
    sup = RoundSupervisor(sel, policy=policy(), injector=FailureInjector(
        {2: [("flap", "i3", 0.5)]}))
    report = sup.run(max_rounds=40)
    assert report.lambda_1se == sel_oracle.lambda_1se
    err = np.abs(np.asarray(report.beta) - np.asarray(sel_oracle.beta)).max()
    assert err <= QUANT


@pytest.mark.parametrize("failure", ("centers", "quorum"))
def test_selection_unsurvivable_raises_exact_error(sel_study, failure):
    sel = make_selection(sel_study)
    if failure == "centers":
        schedule = {1: [("center_crash", 1), ("center_crash", 2)]}
        match = "aggregate unrecoverable this round"
    else:
        sel.study.min_responders = 2
        schedule = {1: [("crash", n) for n in NAMES]}
        match = "responders < min"
    sup = RoundSupervisor(
        sel, policy=policy(max_retries=2, reprovision_after=0),
        injector=FailureInjector(schedule))
    with pytest.raises(RuntimeError, match=match):
        sup.step()
    assert sel.next_chunk == 0


# -- crash-resume -------------------------------------------------------------

def test_secure_fit_resumes_bit_identically(study):
    a = make_driver("secure_fit", study)
    res_a = a.run()
    b = make_driver("secure_fit", study)
    for _ in range(3):
        b.step()
    state = {k: np.array(v) for k, v in b.state_dict().items()}
    c = make_driver("secure_fit", study)
    c.load_state_dict(state)
    res_c = c.run()
    assert res_c.deviance_trace == res_a.deviance_trace
    assert np.array_equal(res_c.beta, res_a.beta)
    assert res_c.iterations == res_a.iterations
    assert res_c.bytes_transmitted == res_a.bytes_transmitted


def test_supervised_resume_replays_schedule(study):
    """A fresh supervisor over a ``state_dict``-restored driver continues
    the SAME schedule (round numbers keep their absolute meaning) and
    lands on the uninterrupted run's trace and beta."""
    schedule = {2: [("center_midround", 2)], 5: [("center_recover", 2)]}

    def supervise(drv):
        return RoundSupervisor(drv, policy=policy(reprovision_after=0),
                               injector=FailureInjector(schedule))

    res_a = supervise(make_driver("secure_fit", study)).run(max_rounds=60)
    b = make_driver("secure_fit", study)
    sup_b = supervise(b)
    for _ in range(3):
        sup_b.step()
    state = {k: np.array(v) for k, v in b.state_dict().items()}
    c = make_driver("secure_fit", study)
    c.load_state_dict(state)
    assert not c.centers_online[1]  # the mid-round death survived
    sup_c = supervise(c)
    assert sup_c.round_no == 3
    res_c = sup_c.run(max_rounds=60)
    assert res_c.deviance_trace == res_a.deviance_trace
    assert np.array_equal(res_c.beta, res_a.beta)


def test_coordinator_failed_round_is_invisible_to_resume(study):
    """A failed round advances nothing, the generator included: the trace
    of (2 rounds, failed round, 2 rounds) equals 4 clean rounds, and a
    checkpoint taken after the failure resumes without off-by-one."""
    insts = make_insts(study)
    co = StudyCoordinator(insts, lam=1.0, protect="gradient",
                          min_responders=NUM_INST, device="cpu")
    co.step()
    co.step()
    rng_before = co.generator.get_state().clone()
    insts[0].online = False
    with pytest.raises(RuntimeError, match="responders < min"):
        co.step()
    insts[0].online = True
    assert co.iteration == 2 and len(co.trace) == 2
    assert torch.equal(co.generator.get_state(), rng_before)
    clean = StudyCoordinator(make_insts(study), lam=1.0, protect="gradient",
                             device="cpu")
    state = {k: np.array(v) for k, v in co.state_dict().items()}
    resumed = StudyCoordinator(make_insts(study), lam=1.0,
                               protect="gradient", device="cpu")
    resumed.load_state_dict(state)
    beta_clean, beta_failed = clean.run(), co.run()
    beta_resumed = resumed.run()
    assert clean.trace == co.trace == resumed.trace
    assert np.array_equal(beta_clean, beta_failed)
    assert np.array_equal(beta_clean, beta_resumed)


def test_secure_fit_latency_is_read_back_and_checkpointed(study):
    """``get_latency`` (the supervisor reads each party's base latency
    through it) returns what ``set_latency`` stored, and the value
    survives a ``state_dict`` round trip."""
    drv = make_driver("secure_fit-fused", study, deadline=2.0)
    assert drv.get_latency("i2") == 0.0
    drv.set_latency("i2", 7.5)
    assert drv.get_latency("i2") == 7.5
    with pytest.raises(KeyError, match="unknown institution"):
        drv.get_latency("nobody")
    rep = drv.step()
    assert rep.stragglers == ["i2"]
    resumed = make_driver("secure_fit-fused", study, deadline=2.0)
    resumed.load_state_dict({k: np.array(v)
                             for k, v in drv.state_dict().items()})
    assert resumed.get_latency("i2") == 7.5
    assert [resumed.get_latency(n) for n in NAMES] == [0.0, 0.0, 7.5, 0.0]
    # a supervisor adopts the driver's latency as the party's base latency
    sup = RoundSupervisor(resumed, policy=policy())
    assert sup._base_latency["i2"] == 7.5


# -- provisioning semantics ---------------------------------------------------

def test_provision_center_semantics(study):
    agg = SecureCollective(scheme=ShamirScheme(threshold=2, num_shares=4))
    co = StudyCoordinator(make_insts(study), lam=1.0, protect="gradient",
                          aggregator=agg, num_centers=3, device="cpu")
    co.centers[0].online = False
    fresh = co.provision_center()
    assert fresh.index == 4
    replaced = co.provision_center()
    assert replaced.index == 1 and replaced.online
    with pytest.raises(RuntimeError, match="still online"):
        co.provision_center(2)
    with pytest.raises(RuntimeError, match="no free evaluation point"):
        co.provision_center()
    with pytest.raises(ValueError, match="must be in 1..4"):
        co.provision_center(9)


def test_secure_fit_provisioning_brings_the_point_back(study):
    drv = make_driver("secure_fit-fused", study)
    sup = RoundSupervisor(drv, policy=policy())
    with pytest.raises(RuntimeError, match="no dead center"):
        sup.driver.provision_center()
    drv.set_center_online(3, False)
    assert sup.driver.provision_center() == 3
    assert drv.centers_online == [True, True, True]


def test_num_centers_bounds(study):
    agg = SecureCollective(scheme=ShamirScheme(threshold=2, num_shares=3))
    for n in (1, 4):
        with pytest.raises(ValueError, match="num_centers must lie in"):
            StudyCoordinator(make_insts(study), aggregator=agg,
                             num_centers=n, device="cpu")


# -- parity with the JAX package's supervisor ---------------------------------

def _jpolicy(**kw):
    kw.setdefault("max_retries", 4)
    kw.setdefault("heartbeat_timeout", 3.0)
    kw.setdefault("straggler", JStraggler(deadline=2.0, quorum_fraction=0.5))
    return JPolicy(**kw)


def _jinsts(parts):
    return [JInstitution(n, jnp.asarray(X), jnp.asarray(y))
            for n, (X, y) in zip(NAMES, parts)]


def _records(sup):
    return [(r.round_no, r.attempts, r.retries, r.aborted_attempts,
             r.backoff_seconds, r.degraded, r.events, r.suspected_dead)
            for r in sup.rounds]


@pytest.mark.parametrize("kind", ("coordinator", "secure_fit-fused"))
def test_supervision_matches_jax(kind, study):
    """The "mixed" schedule (a flap, a center crash, a recover and a
    mid-round center death) through both supervisors on the same data:
    the same round records, the same total retries and backoff, and beta
    within the quantization."""
    schedule = SURVIVABLE["mixed"]
    drv = make_driver(kind, study)
    sup = RoundSupervisor(drv, policy=policy(),
                          injector=FailureInjector(schedule))
    sup.run(max_rounds=60)
    if kind == "coordinator":
        jdrv = JCoordinator(_jinsts(study), lam=1.0, protect="gradient")
    else:
        jdrv = JDriver([(jnp.asarray(X), jnp.asarray(y)) for X, y in study],
                       lam=1.0, protect="gradient", names=NAMES,
                       aggregator=JAggregator(backend="pallas"), fused=True)
    jsup = JSupervisor(jdrv, policy=_jpolicy(), injector=JInjector(schedule))
    jsup.run(max_rounds=60)
    assert drv.converged and jdrv.converged
    assert drv.iteration == jdrv.iteration
    assert _records(sup) == _records(jsup)
    assert (sup.total_retries, sup.total_backoff) == \
        (jsup.total_retries, jsup.total_backoff)
    assert [(r.report.responders, r.report.stragglers,
             r.report.centers_used) for r in sup.rounds] == \
        [(r.report.responders, r.report.stragglers,
          r.report.centers_used) for r in jsup.rounds]
    err = np.abs(final_beta(drv) - np.asarray(jdrv.beta)).max()
    assert err <= QUANT


def test_selection_supervision_matches_jax(sel_study):
    """The λ sweep under the center-fault schedule through both
    supervisors, on the JAX package's fold ids: the same chunk records,
    the same picks and rounds, equal bytes, the refit beta within the
    quantization."""
    sel = make_selection(sel_study)
    sup = RoundSupervisor(sel, policy=policy(),
                          injector=FailureInjector(SEL_CENTER_SCHEDULE))
    rep = sup.run(max_rounds=40)
    jsel = JSelection(
        [JInstitution(n, jnp.asarray(X), jnp.asarray(y))
         for n, (X, y) in zip(NAMES, sel_study)], **SEL_KW)
    jsup = JSupervisor(jsel, policy=_jpolicy(),
                       injector=JInjector(SEL_CENTER_SCHEDULE))
    jrep = jsup.run(max_rounds=40)
    assert _records(sup) == _records(jsup)
    assert (rep.lambda_best, rep.lambda_1se) == (jrep.lambda_best,
                                                 jrep.lambda_1se)
    assert rep.rounds_total == jrep.rounds_total
    assert rep.bytes_total == jrep.bytes_total
    assert np.abs(np.asarray(rep.beta) - np.asarray(jrep.beta)).max() \
        <= QUANT
