"""Port vs JAX package: the cross-validated summaries and their secure round.

The same numpy inputs (from a seed) go through the JAX functions, run as
the JAX package's own tests run them on the CPU (``fused_irls_cv_sim``,
``fused_irls_cv_pallas`` in interpret mode), and through the port's.
Tolerances: H to float32 summation order (rtol 1e-5 of max|H|), g and the
deviances to 1e-10, the held-out correct and count sums exactly; reveals
of the same floats bit-identical (a reveal does not depend on the sharing
randomness).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core.batched_summaries import (
    batched_cv_summaries as j_batched_cv_summaries,
    pack_partitions as j_pack_partitions,
)
from repro.core.collective import SecureCollective as JCollective
from repro.kernels import ops as jops
from repro.kernels.fused_irls import fused_irls_cv_sim
from repro.selection.folds import assign_folds as j_assign_folds
from repro_torch.core.batched_summaries import (
    batched_cv_summaries,
    pack_cache_evict,
    pack_partitions,
)
from repro_torch.core.collective import SecureCollective
from repro_torch.kernels import ops
from repro_torch.kernels.fused_irls import (
    fused_irls_cv_kernel,
    fused_irls_cv_plain,
)
from repro_torch.selection.folds import assign_folds, pack_fold_ids

COUNTS = (300, 123, 257)
FOLD_OF = (-1, 0, 2)


def _cv_inputs(d, seed=0, counts=COUNTS, n=300):
    rng = np.random.default_rng(seed + d)
    s_dim = len(counts)
    X = rng.normal(size=(s_dim, n, d))
    y = (rng.random((s_dim, n)) < 0.4).astype(np.float64)
    fid = rng.integers(0, 3, size=(s_dim, n)).astype(np.int32)
    for s, c in enumerate(counts):
        fid[s, c:] = -1  # padding rows: fold -1, as pack_fold_ids pads
    betas = 0.3 * rng.normal(size=(len(FOLD_OF), d))
    return (betas, X, X.astype(np.float32), y, np.asarray(counts, np.int32),
            fid, np.asarray(FOLD_OF, np.int32))


def _check_against(got, want):
    H, Hw = got[0].numpy(), np.asarray(want[0])
    assert H.dtype == np.float32
    np.testing.assert_allclose(H, Hw, rtol=0, atol=1e-5 * np.abs(Hw).max())
    for a, b in zip(got[1:4], want[1:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-10)
    for a, b in zip(got[4:], want[4:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("d", [8, 16])
def test_k5_plain_matches_fused_irls_cv_sim(d):
    args = _cv_inputs(d)
    got = fused_irls_cv_plain(*(torch.as_tensor(a) for a in args))
    _check_against(got, fused_irls_cv_sim(*(jnp.asarray(a) for a in args)))


@pytest.mark.parametrize("d", [8, 16])
def test_k5_plain_matches_pallas_interpret(d):
    betas, X, _, y, counts, fid, fold_of = _cv_inputs(d, seed=1)
    want = jops.fused_irls_cv(
        jnp.asarray(betas), jnp.asarray(X), jnp.asarray(y),
        jnp.asarray(fid), jnp.asarray(fold_of), counts=jnp.asarray(counts),
        interpret=True, simulate=False)
    got = ops.fused_irls_cv(*(torch.as_tensor(a) for a in
                              (betas, X, y, fid, fold_of)),
                            counts=torch.as_tensor(counts))
    _check_against(got, want)


def test_k5_masks_row_before_fold():
    """Padding rows hold fold id -1 = a refit's ``fold_of``: the row mask
    keeps them out of the held-out set, and ``counts=None`` means every
    row; a count past N_max reads no row beyond it."""
    betas, X, Xm, y, _, fid, fold_of = _cv_inputs(8, seed=2,
                                                  counts=(300, 300, 300))
    fid[:, 200:] = -1
    t = [torch.as_tensor(a) for a in (betas, X, Xm, y)]
    cnt = torch.tensor([200, 200, 200], dtype=torch.int32)
    out = fused_irls_cv_plain(*t, cnt, torch.as_tensor(fid),
                              torch.as_tensor(fold_of))
    assert float(out[5][0].sum()) == 0.0  # fold_of -1: nothing held out
    full = ops.fused_irls_cv(t[0], t[1], t[3], torch.as_tensor(fid),
                             torch.as_tensor(fold_of))
    assert float(full[5][0].sum()) == 3 * 100  # all 300 rows valid
    over = fused_irls_cv_plain(*t, torch.tensor([300, 999, 300],
                                                dtype=torch.int32),
                               torch.as_tensor(fid), torch.as_tensor(fold_of))
    for a, b in zip(over, full):
        assert torch.equal(a, b)


def test_k5_cpu_takes_plain_and_checks_inputs():
    args = [torch.as_tensor(a) for a in _cv_inputs(8)]
    before = fused_irls_cv_kernel.launches
    got = fused_irls_cv_kernel(*args)
    assert fused_irls_cv_kernel.launches == before
    for a, b in zip(got, fused_irls_cv_plain(*args)):
        assert torch.equal(a, b)
    with pytest.raises(TypeError):
        fused_irls_cv_kernel(*args[:5], args[5].long(), args[6])
    with pytest.raises(ValueError):
        fused_irls_cv_kernel(*args[:6], args[6][:2])
    with pytest.raises(ValueError):
        fused_irls_cv_kernel(args[0][0], *args[1:])


def _packed_study(seed=3, sizes=(140, 97, 120), d=6):
    rng = np.random.default_rng(seed)
    parts = [(rng.normal(size=(n, d)),
              (rng.random(n) < 0.5).astype(np.float64)) for n in sizes]
    folds = [rng.integers(0, 3, size=n).astype(np.int32) for n in sizes]
    betas = 0.2 * rng.normal(size=(len(FOLD_OF), d))
    return parts, folds, betas


@pytest.mark.parametrize("rung,jrung", [("reference", "reference"),
                                        ("kernel", "pallas"),
                                        ("mixed", "mixed")])
def test_batched_cv_summaries_rungs_match_jax(rung, jrung):
    parts, folds, betas = _packed_study()
    tpk = pack_partitions([(torch.as_tensor(X), torch.as_tensor(y))
                           for X, y in parts])
    jpk = j_pack_partitions([(jnp.asarray(X), jnp.asarray(y))
                             for X, y in parts])
    n_max = tpk.X.shape[1]
    got = batched_cv_summaries(torch.as_tensor(betas), tpk,
                               pack_fold_ids(folds, n_max),
                               torch.as_tensor(FOLD_OF), backend=rung)
    jfold = jnp.stack([jnp.pad(jnp.asarray(f), (0, n_max - len(f)),
                               constant_values=-1) for f in folds])
    want = j_batched_cv_summaries(jnp.asarray(betas), jpk, jfold,
                                  jnp.asarray(FOLD_OF, jnp.int32),
                                  backend=jrung)
    H, Hw = got.hessian.numpy(), np.asarray(want.hessian)
    tol = 1e-12 if rung == "reference" else 1e-5
    np.testing.assert_allclose(H, Hw, rtol=0, atol=tol * np.abs(Hw).max())
    for f in ("gradient", "deviance", "val_deviance"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-10, atol=1e-10)
    for f in ("count", "val_correct", "val_count"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert all(getattr(got, f).dtype == torch.float64 for f in got._fields)


def _cv_tree(seed, c_dim=3, s_dim=4, d=5):
    rng = np.random.default_rng(seed)
    return {
        "hessian": rng.normal(size=(c_dim, s_dim, d, d)) * 30.0,
        "gradient": rng.normal(size=(c_dim, s_dim, d)) * 5.0,
        "deviance": rng.uniform(100.0, 900.0, size=(c_dim, s_dim)),
        "count": rng.integers(50, 90, size=(c_dim, s_dim)).astype(float),
        "val_deviance": rng.uniform(10.0, 90.0, size=(c_dim, s_dim)),
        "val_correct": rng.integers(0, 30, size=(c_dim, s_dim)).astype(float),
        "val_count": rng.integers(30, 40, size=(c_dim, s_dim)).astype(float),
    }


@pytest.mark.parametrize("points", [None, (1, 3), (2, 3), (1, 2, 3)])
def test_secure_round_multiconfig_reveals_bit_identical(points):
    tree = _cv_tree(0)
    got = SecureCollective(backend="kernel").secure_round_multiconfig(
        SecureCollective.round_key(4, 7, "cpu"),
        {k: torch.as_tensor(v) for k, v in tree.items()}, points=points)
    want = JCollective(backend="pallas").secure_round_multiconfig(
        jax.random.PRNGKey(11), {k: jnp.asarray(v) for k, v in tree.items()},
        points=points)
    assert sorted(got) == sorted(want)
    for k, v in tree.items():
        assert tuple(got[k].shape) == v.shape[:1] + v.shape[2:]
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_allclose(got[k].numpy(), v.sum(axis=1),
                                   atol=5 * 2.0**-28)


def test_secure_round_multiconfig_rejects_ragged_leading_axes():
    tree = {k: torch.as_tensor(v) for k, v in _cv_tree(1).items()}
    tree["count"] = tree["count"][:2]
    with pytest.raises(ValueError, match="leading"):
        SecureCollective(backend="kernel").secure_round_multiconfig(
            SecureCollective.round_key(0, 0, "cpu"), tree)


@pytest.mark.parametrize("protect", ["none", "gradient", "hessian", "both"])
@pytest.mark.parametrize("live", [None, 2, 3])
def test_multiconfig_round_bytes_equal_jax(protect, live):
    for backend, jb in (("kernel", "pallas"), ("reference", "reference")):
        for d, s_dim, c_dim, extra in ((6, 3, 9, 3), (128, 8, 5, 3),
                                       (128, 8, 1, 3), (7, 2, 4, 0)):
            got = SecureCollective(backend=backend).round_bytes(
                d, s_dim, protect, include_count=True, num_live_centers=live,
                num_configs=c_dim, extra_scalars=extra)
            want = JCollective(backend=jb).round_bytes(
                d, s_dim, protect, include_count=True, num_live_centers=live,
                num_configs=c_dim, extra_scalars=extra)
            assert got == want
    # the lambda path's acceptance wire figure
    assert SecureCollective(backend="kernel").round_bytes(
        128, 8, "both", include_count=True, num_configs=5,
        extra_scalars=3) == 16_711_680


def test_round_key_depends_on_seed_and_slot_only():
    draw = lambda g: torch.randint(0, 2**31 - 1, (8,), generator=g)  # noqa
    a = draw(SecureCollective.round_key(3, 5, "cpu"))
    assert torch.equal(a, draw(SecureCollective.round_key(3, 5, "cpu")))
    assert not torch.equal(a, draw(SecureCollective.round_key(3, 6, "cpu")))
    assert not torch.equal(a, draw(SecureCollective.round_key(4, 5, "cpu")))


@pytest.mark.parametrize("rows,k", [(10, 3), (97, 5), (200, 2), (5, 5)])
def test_assign_folds_balanced_deterministic_churn_safe(rows, k):
    f = assign_folds(rows, k, "hospital-a", fold_seed=1)
    assert f.dtype == torch.int32 and tuple(f.shape) == (rows,)
    sizes = torch.bincount(f.long(), minlength=k)
    assert int(sizes.max() - sizes.min()) <= 1 and int(sizes.sum()) == rows
    assert torch.equal(f, assign_folds(rows, k, "hospital-a", fold_seed=1))
    # another name or seed reshuffles; the JAX package's folds obey the
    # same contract (balanced) with another stream
    assert not torch.equal(f, assign_folds(rows, k, "hospital-a",
                                           fold_seed=2)) or rows == k
    jf = np.asarray(j_assign_folds(rows, k, "hospital-a", 1))
    assert np.ptp(np.bincount(jf, minlength=k)) <= 1
    with pytest.raises(ValueError):
        assign_folds(k - 1, k, "x")


def test_pack_fold_ids_pads_with_minus_one_and_takes_numpy():
    ids = pack_fold_ids([np.array([0, 1, 2], np.int32),
                         torch.tensor([2, 0], dtype=torch.int32)], 4)
    assert ids.tolist() == [[0, 1, 2, -1], [2, 0, -1, -1]]
    assert ids.dtype == torch.int32


def test_pack_cache_evict_drops_packs_with_a_churned_part():
    rng = np.random.default_rng(5)
    parts = [(torch.as_tensor(rng.normal(size=(n, 3))),
              torch.as_tensor(rng.random(n))) for n in (5, 7, 6)]
    a = pack_partitions(parts)
    b = pack_partitions(parts[:2])
    assert pack_partitions(parts) is a and pack_partitions(parts[:2]) is b
    pack_cache_evict([parts[2]])
    assert pack_partitions(parts) is not a  # repacked
    assert pack_partitions(parts[:2]) is b  # untouched
