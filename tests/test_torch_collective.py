"""Port vs JAX package: the secure collective and the summaries pack.

A reveal does not depend on the sharing randomness (Lagrange
reconstruction cancels the polynomials exactly), so the port's reveal of
a summary tree must be bit-identical to the JAX package's although the
two draw their polynomials from different generators.
"""
import itertools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core.collective import SecureCollective as JCollective
from repro_torch.core import batched_summaries as bs
from repro_torch.core.collective import FlatProtected, SecureCollective
from repro_torch.core.secure_agg import SecureAggregator
from repro_torch.core.shamir import ShamirScheme
from repro_torch.obs import ledger


def _tree(seed, s_dim=4, d=9):
    rng = np.random.default_rng(seed)
    return {
        "hessian": rng.normal(size=(s_dim, d, d)) * 30.0,
        "gradient": rng.normal(size=(s_dim, d)) * 5.0,
        "deviance": rng.uniform(100.0, 900.0, size=(s_dim,)),
    }


@pytest.mark.parametrize("points", [None, (1, 3), (2, 3), (1, 2, 3)])
def test_secure_round_batched_reveal_bit_identical(points):
    tree = _tree(0)
    got = SecureCollective(backend="kernel").secure_round_batched(
        torch.Generator().manual_seed(5),
        {k: torch.as_tensor(v) for k, v in tree.items()}, points=points)
    want = JCollective(backend="pallas").secure_round_batched(
        jax.random.PRNGKey(9), {k: jnp.asarray(v) for k, v in tree.items()},
        points=points)
    assert sorted(got) == sorted(want)
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_allclose(got[k].numpy(), tree[k].sum(axis=0),
                                   atol=5 * 2.0**-28)


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_loop_protect_aggregate_reveal_matches_sum(backend):
    """The per-institution chain (protect each, aggregate, reveal) on both
    backends reveals the exact fixed-point sum, from any t-subset."""
    tree = _tree(1, s_dim=3, d=4)
    agg = SecureCollective(backend=backend)
    gen = torch.Generator().manual_seed(0)
    prots = [agg.protect(gen, {k: torch.as_tensor(v[j])
                               for k, v in tree.items()}) for j in range(3)]
    summed = agg.aggregate(prots)
    first = agg.reveal(summed)
    for pts in itertools.combinations((1, 2, 3), 2):
        sel = torch.tensor([p - 1 for p in pts])
        if isinstance(summed, FlatProtected):
            sub = FlatProtected(summed.buf[sel], summed.layout)
        else:
            sub = {k: v[sel] for k, v in summed.items()}
        out = agg.reveal(sub, points=list(pts))
        for k in tree:
            assert torch.equal(out[k], first[k])
            np.testing.assert_allclose(out[k].numpy(), tree[k].sum(axis=0),
                                       atol=4 * 2.0**-28)


def test_reference_and_kernel_backends_reveal_identically():
    tree = {k: torch.as_tensor(v[0]) for k, v in _tree(2).items()}
    outs = []
    for backend in ("reference", "kernel"):
        agg = SecureCollective(backend=backend)
        outs.append(agg.reveal(agg.protect(torch.Generator(), tree)))
    for k in tree:
        assert torch.equal(outs[0][k], outs[1][k])


def test_round_bytes_equal_jax_everywhere():
    for backend, jbackend in (("reference", "reference"),
                              ("kernel", "pallas")):
        agg, jagg = SecureAggregator(backend=backend), \
            JCollective(backend=jbackend)
        for protect, count, live, d in itertools.product(
                ("none", "gradient", "hessian", "both"), (False, True),
                (None, 2, 3), (1, 8, 128)):
            got = agg.round_bytes(d, 8, protect, include_count=count,
                                  num_live_centers=live)
            assert got == jagg.round_bytes(d, 8, protect,
                                           include_count=count,
                                           num_live_centers=live)
    # the slice config: S=8, d=128, protect=both -> 3,342,336 B per round
    assert SecureCollective(backend="kernel").round_bytes(
        128, 8, "both") == 3_342_336


def test_below_threshold_and_bad_points_rejected():
    agg = SecureCollective(backend="kernel")
    tree = {k: torch.as_tensor(v) for k, v in _tree(3).items()}
    with pytest.raises(ValueError, match="irrecoverable"):
        agg.secure_round_batched(torch.Generator(), tree, points=(2,))
    with pytest.raises(ValueError, match="distinct"):
        agg.secure_round_batched(torch.Generator(), tree, points=(1, 1))
    with pytest.raises(ValueError, match="1..3"):
        agg.secure_round_batched(torch.Generator(), tree, points=(1, 4))
    with pytest.raises(ValueError, match="kernel backend"):
        SecureCollective().protect_batched(torch.Generator(), tree)


def test_kernel_scheme_leafwise_matches_reference():
    """The kernel scheme's leaf-wise share runs through K4 and its
    reconstruction through K2's residues mode (their plain versions on the
    CPU): the reference backend's shares, and the secret back, bit for
    bit."""
    sch = ShamirScheme(backend="kernel")
    secret = torch.tensor([[0, 1, 5, 2**31 - 2], [3, 0, 7, 2**31 - 20]],
                          dtype=torch.int64)
    shares = sch.share(torch.Generator().manual_seed(3), secret)
    assert torch.equal(shares, ShamirScheme().share(
        torch.Generator().manual_seed(3), secret))
    assert torch.equal(sch.reconstruct(shares[[0, 2]], [1, 3]), secret)


def test_overflow_check_raises_before_saturation():
    agg = SecureCollective(backend="kernel", overflow_check=True)
    cap = agg.codec.capacity()
    tree = {"gradient": torch.full((4, 3), cap / 3, dtype=torch.float64)}
    with pytest.raises(OverflowError):
        agg.protect_batched(torch.Generator(), tree)
    assert not agg.headroom_ok(cap / 3, 4) and agg.headroom_ok(cap / 5, 4)


def test_ledger_counts_one_protect_and_one_reveal_per_round():
    tree = {k: torch.as_tensor(v) for k, v in _tree(4).items()}
    with ledger.capture() as cap:
        SecureCollective(backend="kernel").secure_round_batched(
            torch.Generator(), tree)
    assert cap.by_site == {"_protect_flat": 1, "_reveal_flat": 1}


def test_pack_cache_hits_and_misses_after_in_place_edit():
    rng = np.random.default_rng(6)
    parts = [(torch.as_tensor(rng.normal(size=(n, 3))),
              torch.as_tensor((rng.random(n) < 0.5).astype(np.float64)))
             for n in (5, 9)]
    first = bs.pack_partitions(parts)
    assert bs.pack_partitions(parts) is first
    assert first.counts.tolist() == [5, 9]
    assert torch.equal(first.X[0, 5:], torch.zeros(4, 3))
    parts[0][0][1, 2] += 1.0  # in place: _version bumps, same storage
    second = bs.pack_partitions(parts)
    assert second is not first
    assert float(second.X[0, 1, 2]) == float(parts[0][0][1, 2])
    assert float(first.X[0, 1, 2]) != float(second.X[0, 1, 2])
    assert bs.pack_partitions(parts) is second


def test_summary_rungs_agree():
    rng = np.random.default_rng(7)
    parts = [(torch.as_tensor(rng.normal(size=(n, 6))),
              torch.as_tensor((rng.random(n) < 0.5).astype(np.float64)))
             for n in (40, 70, 55)]
    packed = bs.pack_partitions(parts)
    beta = torch.as_tensor(0.1 * rng.normal(size=6))
    ref = bs.batched_local_summaries(beta, packed, backend="reference")
    for backend in ("kernel", "mixed"):
        got = bs.batched_local_summaries(beta, packed, backend=backend)
        np.testing.assert_allclose(got.hessian.numpy(), ref.hessian.numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.gradient.numpy(),
                                   ref.gradient.numpy(), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(got.deviance.numpy(),
                                   ref.deviance.numpy(), rtol=1e-12)
    with pytest.raises(ValueError):
        bs.batched_local_summaries(beta, packed, backend="pallas")
