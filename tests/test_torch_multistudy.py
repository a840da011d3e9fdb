"""Port vs JAX package: slot-packed multi-study rounds.

M independent studies advance by ONE collective round
(``core/multistudy.py``).  Each slot's revealed aggregate is the same
field decode an independent round gives, so the packed round matches the
JAX package's packed round and the port's own independent fits within the
fixed-point quantization (S+1)/2**28 (the batched Newton solve may differ
in its last bits).  Data: numpy from a seed, M=2 studies of S=4
institutions, d=5.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core import SecureCollective as JCollective
from repro.core.multistudy import fused_multistudy_iteration as j_iteration
from repro.core.multistudy import stack_studies as j_stack
from repro_torch.convert import parts_from_numpy
from repro_torch.core import (
    fused_multistudy_iteration,
    run_multistudy_rounds,
    stack_studies,
)
from repro_torch.core.batched_summaries import pack_partitions
from repro_torch.core.collective import SecureCollective
from repro_torch.core.newton import SecureFitDriver, _fused_secure_iteration

NUM_INST, DIM = 4, 5
QUANT = (NUM_INST + 1) / 2**28
LAMS = (1.0, 0.3)


def _study(seed, sizes, d=DIM):
    rng = np.random.default_rng(seed)
    n = sum(sizes)
    X = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, d - 1))], 1)
    beta = rng.uniform(-1.0, 1.0, size=d)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(np.float64)
    off = np.cumsum((0,) + tuple(sizes))
    return [(X[a:b], y[a:b]) for a, b in zip(off[:-1], off[1:])]


@pytest.fixture(scope="module")
def studies():
    return [_study(11, (120, 110, 130, 120)), _study(23, (120,) * 4)]


@pytest.fixture(scope="module")
def agg():
    return SecureCollective(backend="kernel")


def _port_stack(studies):
    return stack_studies([parts_from_numpy(s, "cpu") for s in studies])


@pytest.mark.parametrize("protect", ["both", "gradient", "none"])
def test_multistudy_iteration_matches_jax(studies, agg, protect):
    """One packed round on the same stacked inputs: the port's betas,
    objectives and norms against the JAX package's."""
    packed = _port_stack(studies)
    jpacked = j_stack([[(jnp.asarray(X), jnp.asarray(y)) for X, y in s]
                       for s in studies])
    np.testing.assert_array_equal(packed.X.numpy(), np.asarray(jpacked.X))
    np.testing.assert_array_equal(packed.counts.numpy(),
                                  np.asarray(jpacked.counts))
    betas0 = np.tile(np.linspace(-0.2, 0.3, DIM), (len(studies), 1))
    got = fused_multistudy_iteration(
        torch.as_tensor(betas0), torch.Generator().manual_seed(7), packed.X,
        packed.X32, packed.y, packed.counts,
        torch.as_tensor(LAMS, dtype=torch.float64), agg, protect, 0.0)
    want = j_iteration(
        jnp.asarray(betas0), jax.random.PRNGKey(7), jpacked.X, jpacked.X32,
        jpacked.y, jpacked.counts, jnp.asarray(LAMS), JCollective(
            backend="pallas"), protect, 0.0, True)
    b, obj, gn, sn = (t.numpy() for t in got)
    assert np.abs(b - np.asarray(want[0])).max() <= QUANT
    assert np.abs(obj - np.asarray(want[1])).max() <= QUANT * NUM_INST
    assert np.abs(gn - np.asarray(want[2])).max() <= QUANT * DIM
    assert np.abs(sn - np.asarray(want[3])).max() <= QUANT * DIM


@pytest.mark.parametrize("protect", ["both", "gradient", "none"])
def test_multistudy_iteration_matches_independent(studies, agg, protect):
    """One packed round == one independent fused round per study."""
    packed = _port_stack(studies)
    betas0 = torch.zeros((len(studies), DIM), dtype=torch.float64)
    betas, objs, gnorms, snorms = fused_multistudy_iteration(
        betas0, torch.Generator().manual_seed(7), packed.X, packed.X32,
        packed.y, packed.counts, torch.as_tensor(LAMS, dtype=torch.float64),
        agg, protect, 0.0)
    for m, study in enumerate(studies):
        b, obj, g, s = _fused_secure_iteration(
            betas0[m], torch.Generator().manual_seed(m),
            pack_partitions(parts_from_numpy(study, "cpu")), LAMS[m], agg,
            protect, 0.0)
        assert (betas[m] - b).abs().max() <= QUANT
        assert abs(float(objs[m]) - float(obj)) <= QUANT * NUM_INST
        assert abs(float(gnorms[m]) - float(g)) <= QUANT * DIM
        assert abs(float(snorms[m]) - float(s)) <= QUANT * DIM


def test_multistudy_rounds_track_independent_fits(studies, agg):
    """Four packed rounds track each study's own ``SecureFitDriver`` round
    by round (the driver stops updating once it converges; a step past
    that point is below the quantization)."""
    num_rounds = 4
    per_round = []
    for r in range(1, num_rounds + 1):
        betas, trace = run_multistudy_rounds(studies, LAMS, r,
                                             aggregator=agg, device="cpu")
        per_round.append(betas)
    assert tuple(trace.shape) == (num_rounds, len(studies))
    for m, study in enumerate(studies):
        drv = SecureFitDriver(study, lam=LAMS[m], protect="both",
                              aggregator=agg, device="cpu")
        for r in range(num_rounds):
            if not drv.converged:
                rep = drv.step()
                assert abs(float(trace[r, m]) - rep.objective) \
                    <= QUANT * NUM_INST * (r + 1)
            assert (per_round[r][m] - drv.beta).abs().max() \
                <= QUANT * (r + 1)


def test_ragged_studies_pad_with_silent_institutions(agg):
    """A narrower cohort enters the packed round through count=0 padding
    and still matches its own independent round."""
    wide = _study(3, (100,) * 4)
    slim = _study(5, (60, 60))
    packed = _port_stack([wide, slim])
    assert tuple(packed.X.shape[:2]) == (2, 4)
    assert packed.counts.tolist() == [[100] * 4, [60, 60, 0, 0]]
    betas0 = torch.zeros((2, DIM), dtype=torch.float64)
    betas, _, _, _ = fused_multistudy_iteration(
        betas0, torch.Generator().manual_seed(9), packed.X, packed.X32,
        packed.y, packed.counts, torch.tensor([0.5, 0.5],
                                              dtype=torch.float64),
        agg, "both", 0.0)
    for m, study in enumerate((wide, slim)):
        b, _, _, _ = _fused_secure_iteration(
            betas0[m], torch.Generator().manual_seed(1),
            pack_partitions(parts_from_numpy(study, "cpu")), 0.5, agg,
            "both", 0.0)
        assert (betas[m] - b).abs().max() <= QUANT


def test_stack_studies_refuses_mixed_widths():
    with pytest.raises(ValueError, match="feature dimension"):
        stack_studies([parts_from_numpy(_study(1, (10,)), "cpu"),
                       parts_from_numpy(_study(2, (10,), d=3), "cpu")])
    with pytest.raises(ValueError, match="at least one study"):
        stack_studies([])


# the JAX package's name for each of the port's summaries rungs
JAX_BACKEND = {"kernel": "pallas", "reference": "reference",
               "mixed": "mixed"}


@pytest.mark.parametrize("backend", ["kernel", "reference", "mixed"])
def test_multistudy_iteration_dropped_center_with_count_matches_jax(
        studies, backend, monkeypatch):
    """A round revealed from centers 1 and 3 (center 2 dropped) with the
    count leaf on the wire, for each summaries rung: the port's betas,
    objectives and norms against the JAX package's, and the live centers'
    share bytes exactly ``round_bytes(..., include_count=True,
    num_live_centers=2)``."""
    points = (1, 3)
    agg = SecureCollective(backend="kernel")
    packed = _port_stack(studies)
    jpacked = j_stack([[(jnp.asarray(X), jnp.asarray(y)) for X, y in s]
                       for s in studies])
    betas0 = np.tile(np.linspace(-0.2, 0.3, DIM), (len(studies), 1))
    shared = []
    layouts = []
    real = SecureCollective.protect_batched

    def spy(self, *args, **kwargs):
        prot = real(self, *args, **kwargs)
        shared.append(prot.buf)
        layouts.append(prot.layout)
        return prot

    monkeypatch.setattr(SecureCollective, "protect_batched", spy)
    got = fused_multistudy_iteration(
        torch.as_tensor(betas0), torch.Generator().manual_seed(7), packed.X,
        packed.X32, packed.y, packed.counts,
        torch.as_tensor(LAMS, dtype=torch.float64), agg, "both", 0.0,
        points=points, include_count=True, summaries_backend=backend)
    jagg = JCollective(backend="pallas")
    want = j_iteration(
        jnp.asarray(betas0), jax.random.PRNGKey(7), jpacked.X, jpacked.X32,
        jpacked.y, jpacked.counts, jnp.asarray(LAMS), jagg, "both", 0.0,
        True, points=points, include_count=True,
        summaries_backend=JAX_BACKEND[backend])
    b, obj, gn, sn = (t.numpy() for t in got)
    assert np.abs(b - np.asarray(want[0])).max() <= QUANT
    assert np.abs(obj - np.asarray(want[1])).max() <= QUANT * NUM_INST
    assert np.abs(gn - np.asarray(want[2])).max() <= QUANT * DIM
    assert np.abs(sn - np.asarray(want[3])).max() <= QUANT * DIM
    # one (w, R, M * S, rows, 128) int32 buffer; the live centers' slices
    (buf,) = shared
    live = len(points) * buf[0].numel() * buf.element_size()
    model = agg.round_bytes(DIM, NUM_INST, "both", include_count=True,
                            num_live_centers=len(points),
                            num_configs=len(studies))
    assert live == model == jagg.round_bytes(
        DIM, NUM_INST, "both", include_count=True,
        num_live_centers=len(points), num_configs=len(studies))
    # the count leaf rode the wire: each slice packs the Hessian, the
    # gradient, the deviance and the count, one scalar more than without
    # it (the padding to whole rows hides the difference in bytes here)
    (layout,) = layouts
    assert "count" in layout.treedef[1]
    assert layout.num_elements == DIM * DIM + DIM + 2


@pytest.mark.parametrize("backend", ["reference", "mixed"])
def test_multistudy_rounds_summaries_backend_matches_jax(studies, backend):
    """Two rounds of ``run_multistudy_rounds`` on another summaries rung
    against the JAX package's."""
    from repro.core.multistudy import run_multistudy_rounds as j_rounds

    betas, trace = run_multistudy_rounds(
        studies, LAMS, 2, device="cpu", summaries_backend=backend)
    jbetas, jtrace = j_rounds(
        [[(jnp.asarray(X), jnp.asarray(y)) for X, y in s] for s in studies],
        LAMS, 2, summaries_backend=JAX_BACKEND[backend])
    assert np.abs(betas.numpy() - np.asarray(jbetas)).max() <= 2 * QUANT
    assert np.abs(trace.numpy() - np.asarray(jtrace)).max() \
        <= 2 * QUANT * NUM_INST
