"""Port vs JAX package: the secure cross-validated λ path.

The same study (numpy, from a seed: S=3 institutions, d=6, ~600 rows,
L=3 λs, K=3 folds) goes through the JAX ``secure_cv_path`` /
``SelectionCoordinator`` and the port's, with the JAX package's fold ids
passed to the port (the two draw folds from different generators).  On
the reference rung: equal rounds per fold, fold and refit betas within
the fixed-point quantization (S+1)/2**28, held-out sums within 1e-6
relative, the same λ picks and equal wire bytes.  On the kernel rung
(float32 Gram): converged parity — the same picks, betas within the
quantization.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import SecureAggregator as JAggregator
from repro.core.protocol import Institution as JInstitution
from repro.selection import SelectionCoordinator as JSelection
from repro.selection import assign_folds as j_assign_folds
from repro.selection import secure_cv_path as j_secure_cv_path
from repro_torch.convert import (
    fold_parts_from_jax,
    parts_from_numpy,
    selection_state_from_jax,
)
from repro_torch.core.collective import SecureCollective
from repro_torch.core.protocol import Institution
from repro_torch.selection import (
    PathDriver,
    PathSettings,
    SelectionCoordinator,
    assign_folds,
    secure_cv_path,
)

SIZES = (190, 200, 210)
LAMBDAS = (10.0, 1.0, 0.1)
K = 3
QUANT_TOL = (len(SIZES) + 1) / 2**28


@pytest.fixture(scope="module")
def parts():
    rng = np.random.default_rng(1)
    n, d = sum(SIZES), 6
    X = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, d - 1))], 1)
    beta = rng.uniform(-1.0, 1.0, size=d)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(np.float64)
    off = np.cumsum((0,) + SIZES)
    return [(X[a:b], y[a:b]) for a, b in zip(off[:-1], off[1:])]


def _jparts(parts):
    return [(jnp.asarray(X), jnp.asarray(y)) for X, y in parts]


def _port_path(parts, fold_ids, **kw):
    """The port's sweep with given fold ids (``secure_cv_path`` with its
    fold assignment swapped for the JAX package's)."""
    drv = PathDriver(PathSettings(lambdas=LAMBDAS, num_folds=K, **kw),
                     SecureCollective(backend="kernel"))
    tparts = parts_from_numpy(parts, "cpu")
    folds = fold_parts_from_jax(fold_ids)
    state = drv.fresh_state()
    while not drv.finished(state):
        state = drv.run_chunk(state, tparts, folds)
    return drv.build_report(state)


def _jax_folds(parts, names=None):
    names = names if names is not None else range(len(parts))
    return [np.asarray(j_assign_folds(X.shape[0], K, nm, 0))
            for nm, (X, _) in zip(names, parts)]


def _check_converged_parity(port, jax_):
    assert port.fold_converged.all() and jax_.fold_converged.all()
    assert port.lambda_best == jax_.lambda_best
    assert port.lambda_1se == jax_.lambda_1se
    np.testing.assert_allclose(port.fold_betas, jax_.fold_betas, rtol=0,
                               atol=QUANT_TOL)
    np.testing.assert_allclose(port.beta, np.asarray(jax_.beta), rtol=0,
                               atol=QUANT_TOL)


@pytest.mark.parametrize("protect", ["both", "gradient"])
def test_reference_rung_path_matches_jax(parts, protect):
    jax_ = j_secure_cv_path(_jparts(parts), LAMBDAS, num_folds=K,
                            protect=protect, summaries_backend="reference")
    port = _port_path(parts, _jax_folds(parts), protect=protect,
                      summaries_backend="reference")
    _check_converged_parity(port, jax_)
    np.testing.assert_array_equal(port.fold_rounds, jax_.fold_rounds)
    assert port.refit_rounds == jax_.refit_rounds
    assert port.rounds_total == jax_.rounds_total
    for f in ("val_deviance", "val_correct", "val_count"):
        np.testing.assert_allclose(getattr(port, f), getattr(jax_, f),
                                   rtol=1e-6)
    assert port.bytes_per_round == jax_.bytes_per_round
    assert port.bytes_total == jax_.bytes_total


def test_kernel_rung_path_matches_jax(parts):
    jax_ = j_secure_cv_path(_jparts(parts), LAMBDAS, num_folds=K,
                            protect="both")  # the pallas rung
    port = _port_path(parts, _jax_folds(parts), protect="both",
                      summaries_backend="kernel")
    _check_converged_parity(port, jax_)


def test_secure_cv_path_runs_on_its_own_folds(parts):
    """The one-call entry point (the port's own folds): every fold
    converges, the bytes add up chunk by chunk, the refit lands at
    λ_1se; the kernel and reference rungs agree to the quantization."""
    kw = dict(num_folds=K, protect="both", device="cpu")
    rep = secure_cv_path(parts, LAMBDAS, summaries_backend="kernel", **kw)
    ref = secure_cv_path(parts, LAMBDAS, summaries_backend="reference", **kw)
    assert rep.fold_converged.all() and rep.lambda_1se == ref.lambda_1se
    np.testing.assert_allclose(rep.beta, ref.beta, rtol=0, atol=QUANT_TOL)
    assert rep.bytes_per_round == SecureCollective(
        backend="kernel").round_bytes(6, 3, "both", include_count=True,
                                      num_configs=K, extra_scalars=3)
    refit = SecureCollective(backend="kernel").round_bytes(
        6, 3, "both", include_count=True, num_configs=1, extra_scalars=3)
    sweep_rounds = rep.rounds_total - rep.refit_rounds
    assert rep.bytes_total == (sweep_rounds * rep.bytes_per_round
                               + rep.refit_rounds * refit)
    assert rep.lambda_1se in LAMBDAS and len(rep.summary_lines()) == 4


def _jax_checkpoint(jax_, parts, names):
    """The JAX coordinator's checkpoint as the port's, with the fold ids
    the JAX run draws for each institution."""
    return selection_state_from_jax(
        {k: np.asarray(v) for k, v in jax_.state_dict().items()},
        dict(zip(names, _jax_folds(parts, names))))


def _coordinators(parts, names, **kw):
    """A JAX coordinator and a port one started from its (chunk-0)
    checkpoint, so both run on the JAX package's folds."""
    port = SelectionCoordinator(
        [Institution(nm, torch.as_tensor(X), torch.as_tensor(y))
         for nm, (X, y) in zip(names, parts)], LAMBDAS, num_folds=K,
        summaries_backend="reference", device="cpu", **kw)
    jax_ = JSelection(
        [JInstitution(nm, jnp.asarray(X), jnp.asarray(y))
         for nm, (X, y) in zip(names, parts)], LAMBDAS, num_folds=K,
        aggregator=JAggregator(backend="pallas"),
        summaries_backend="reference", **kw)
    port.load_state_dict(_jax_checkpoint(jax_, parts, names))
    return port, jax_


NAMES = ("north", "south", "east")


def test_selection_coordinator_churn_matches_jax(parts):
    """An institution leaves after the first chunk and returns before the
    refit, in the port and the JAX package alike: the same report."""
    port, jax_ = _coordinators(parts, NAMES, protect="both")
    for c in (port, jax_):
        c.step_chunk()
        c.remove_institution("east")
        c.step_chunk()
    X, y = parts[2]
    port.add_institution(Institution("east", torch.as_tensor(X),
                                     torch.as_tensor(y)))
    jax_.add_institution(JInstitution("east", jnp.asarray(X),
                                      jnp.asarray(y)))
    rp, rj = port.run_path(), jax_.run_path()
    _check_converged_parity(rp, rj)
    np.testing.assert_array_equal(rp.fold_rounds, rj.fold_rounds)
    assert rp.bytes_total == rj.bytes_total
    np.testing.assert_allclose(port.study.beta.numpy(), rp.beta)


def test_selection_coordinator_resume_is_bit_identical(parts):
    names = list(NAMES)
    make = lambda seed: SelectionCoordinator(  # noqa: E731
        [Institution(nm, torch.as_tensor(X), torch.as_tensor(y))
         for nm, (X, y) in zip(names, parts)], LAMBDAS, num_folds=K,
        protect="both", rounds_per_sync=2, seed=seed, device="cpu")
    whole = make(0).run_path()
    a = make(0)
    a.step_chunk()
    a.step_chunk()
    snap = a.state_dict()
    a.step_chunk()  # the snapshot is a copy: later chunks do not leak in
    assert int(snap["path_next_chunk"]) == 2
    assert sorted(k for k in snap if k.startswith("folds_")) == sorted(
        f"folds_{nm}" for nm in names)
    b = make(0)
    b.load_state_dict(snap)
    rep = b.run_path()
    for f in ("fold_betas", "fold_rounds", "val_deviance", "val_correct",
              "val_count", "beta"):
        np.testing.assert_array_equal(getattr(rep, f), getattr(whole, f))
    assert rep.bytes_total == whole.bytes_total
    assert rep.rounds_total == whole.rounds_total
    # the port's own folds: a function of (name, seed, rows, K) alone
    for nm, (X, _) in zip(names, parts):
        assert torch.equal(assign_folds(X.shape[0], K, nm),
                           assign_folds(X.shape[0], K, nm))


def test_converted_jax_checkpoint_continues_to_the_same_report(parts):
    port, jax_ = _coordinators(parts, NAMES, protect="both")
    whole = JSelection(
        [JInstitution(nm, jnp.asarray(X), jnp.asarray(y))
         for nm, (X, y) in zip(NAMES, parts)], LAMBDAS, num_folds=K,
        protect="both", aggregator=JAggregator(backend="pallas"),
        summaries_backend="reference").run_path()
    jax_.step_chunk()
    jax_.step_chunk()
    state = _jax_checkpoint(jax_, parts, NAMES)
    assert "study_key" not in state and int(state["path_next_chunk"]) == 2
    assert all(f"folds_{nm}" in state for nm in NAMES)
    port.load_state_dict(state)
    rep = port.run_path()
    _check_converged_parity(rep, whole)
    np.testing.assert_array_equal(rep.fold_rounds, whole.fold_rounds)
    assert rep.bytes_total == whole.bytes_total


def test_mid_path_checkpoint_keeps_its_folds(parts):
    """A continued path runs on the folds it started on: a mid-path
    checkpoint without fold ids is refused by the converter and by
    ``load_state_dict``, and an institution whose rows no longer match
    its recorded folds is refused before any round."""
    port, jax_ = _coordinators(parts, NAMES, protect="both")
    jax_.step_chunk()
    state = {k: np.asarray(v) for k, v in jax_.state_dict().items()
             if k != "study_key"}
    with pytest.raises(ValueError, match="fold ids"):
        selection_state_from_jax(state, {})
    with pytest.raises(ValueError, match="fold ids"):
        port.load_state_dict(state)
    port.load_state_dict(_jax_checkpoint(jax_, parts, NAMES))
    port.remove_institution("east")
    X, y = parts[2]
    port.add_institution(Institution("east", torch.as_tensor(X[:-3]),
                                     torch.as_tensor(y[:-3])))
    with pytest.raises(ValueError, match="rows"):
        port.step_chunk()
    assert int(port.state["next_chunk"]) == 1
