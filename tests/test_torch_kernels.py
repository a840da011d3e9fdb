"""Port vs JAX package: the three kernels' plain versions on the CPU.

On a CPU tensor each kernel wrapper runs its plain PyTorch version, so
these tests hold that version (the CUDA kernel's oracle on the card)
against the JAX kernels run as the JAX package's own tests run them:
Pallas in interpret mode through ``repro.kernels.ops``, and
``fused_irls_sim`` for the summaries.

Tolerances:
* K1 encode+share and K2 reveal are exact field arithmetic — bit-identical.
* K3 H is a float32 Gram whose summation order differs: rtol 2e-5 of
  max|H| (the tolerance ``tests/test_kernels.py`` holds the TPU kernel to
  its simulation).  g and dev are float64 sums: 1e-12 relative.
"""
import itertools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core.field import FIELD31, FIELD_WIDE
from repro.core.fixed_point import FixedPointCodec as JCodec
from repro.core.shamir import ShamirScheme as JScheme
from repro.kernels import ops as jops
from repro.kernels.fused_irls import fused_irls_sim
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused_irls import fused_irls_kernel, \
    fused_irls_plain
from repro_torch.kernels.shamir_poly import encode_share_kernel
from repro_torch.kernels.shamir_reconstruct import reconstruct_kernel

FIELDS = [FIELD31, FIELD_WIDE]


def _payload(rng, rows, dtype, field):
    x = rng.normal(size=(rows, 128)) * 3.0
    cap = field.max_signed / 2**28
    edges = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 0.0, -0.0, cap, -cap,
                      2 * cap, -2 * cap, 1e20, -1e20])
    x.flat[:len(edges)] = edges * 2**-28
    x.flat[len(edges):2 * len(edges)] = edges
    return x.astype(dtype)


@pytest.mark.parametrize("field,dtype,points", [
    (FIELD31, np.float32, None),
    (FIELD31, np.float64, None),
    (FIELD_WIDE, np.float32, None),
    (FIELD_WIDE, np.float64, None),
    (FIELD_WIDE, np.float64, (2,)),
    (FIELD_WIDE, np.float32, (1, 3)),
], ids=lambda v: getattr(v, "name", getattr(v, "__name__", str(v))))
def test_k1_plain_matches_jax_protect_flat(field, dtype, points):
    """K1 plain vs ``ops.shamir_protect_flat``: bit-identical given the
    same coefficients, including ties, clip edges and negatives."""
    rng = np.random.default_rng(7)
    rows, t, w = 16, 2, 3
    x = _payload(rng, rows, dtype, field)
    coeffs = np.stack([rng.integers(0, p, size=(t - 1, rows, 128))
                       for p in field.moduli])
    want = jops.shamir_protect_flat(
        jnp.asarray(x), jnp.asarray(coeffs.astype(np.uint32)), w,
        field.moduli, 28, points=points)
    got = ops.shamir_protect_flat(
        torch.as_tensor(x), torch.as_tensor(coeffs.astype(np.int32)), w,
        field.moduli, 28, points=points)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.asarray(want).astype(np.int64))


def test_k1_plain_matches_ref_oracle_at_t3():
    rng = np.random.default_rng(8)
    rows, t, w = 8, 3, 5
    x = rng.normal(size=(rows, 128))
    coeffs = np.stack([rng.integers(0, p, size=(t - 1, rows, 128))
                       for p in FIELD_WIDE.moduli])
    got = ops.shamir_protect_flat(
        torch.as_tensor(x), torch.as_tensor(coeffs.astype(np.int32)), w,
        FIELD_WIDE.moduli, 28)
    from repro_torch.core.fixed_point import FixedPointCodec

    enc = FixedPointCodec().encode(torch.as_tensor(x))
    for r, p in enumerate(FIELD_WIDE.moduli):
        want = ref.shamir_shares(enc[r].reshape(-1),
                                 torch.as_tensor(coeffs[r]).reshape(t - 1, -1),
                                 w, p)
        assert torch.equal(got[:, r].reshape(w, -1).to(torch.int64), want)


def _jax_shares(field, t, w, rows, seed):
    """Aggregate-like (w, R, rows, 128) shares from the JAX scheme."""
    import jax

    scale = min(50.0, field.max_signed / 2**28 / 4)  # inside capacity
    x = scale * np.random.default_rng(seed).normal(size=(rows, 128))
    enc = JCodec(field=field).encode(jnp.asarray(x))
    shares = JScheme(threshold=t, num_shares=w, field=field).share(
        jax.random.PRNGKey(seed), enc)
    return np.asarray(shares).astype(np.uint32), x


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("t,w", [(2, 3), (3, 5)])
def test_k2_plain_matches_jax_reveal_every_subset(field, t, w):
    """K2 plain vs the JAX reveal: bit-identical for every t-subset of
    points, contiguous or not, and for the over-threshold set.  Every
    subset is held against the JAX reference reconstruct + decode; the
    first-t and one non-contiguous subset also against the Pallas
    ``ops.shamir_reveal_flat`` (one interpret-mode compile per subset)."""
    shares, x = _jax_shares(field, t, w, 8, seed=t * 10 + w)
    jscheme = JScheme(threshold=t, num_shares=w, field=field)
    subsets = list(itertools.combinations(range(1, w + 1), t))
    subsets.append(tuple(range(1, w + 1)))
    pallas_checked = {tuple(range(1, t + 1)), subsets[-2]}
    for pts in subsets:
        sel = np.asarray([p - 1 for p in pts])
        got = ops.shamir_reveal_flat(
            torch.as_tensor(shares[sel].astype(np.int32)), pts,
            field.moduli, 28)
        assert got.dtype == torch.float64
        want = np.asarray(JCodec(field=field).decode(jscheme.reconstruct(
            jnp.asarray(shares[sel].astype(np.uint64)), list(pts))))
        np.testing.assert_array_equal(got.numpy(), want)
        if pts in pallas_checked:
            want = np.asarray(jops.shamir_reveal_flat(
                jnp.asarray(shares[sel]), pts, field.moduli, 28))
            np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_allclose(got.numpy(), x, atol=2.0**-28)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_k2_residues_mode_inverts_shares(field):
    shares, x = _jax_shares(field, 3, 5, 8, seed=3)
    enc = np.asarray(JCodec(field=field).encode(jnp.asarray(x)))
    for pts in [(1, 2, 3), (1, 4, 5), (2, 3, 5)]:
        sel = np.asarray([p - 1 for p in pts])
        rec = reconstruct_kernel(
            torch.as_tensor(shares[sel].astype(np.int32)), pts,
            field.moduli, None)
        assert rec.dtype == torch.int32
        np.testing.assert_array_equal(rec.numpy().astype(np.int64),
                                      enc.astype(np.int64))


def _irls_case(seed, counts, n, d):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(len(counts), n, d))
    for s, c in enumerate(counts):
        c = min(c, n)  # a count past the batch masks nothing
        X[s, c:] = rng.normal(size=(n - c, d)) * 1e3  # masked garbage
    y = (rng.random((len(counts), n)) < 0.4).astype(np.float64)
    beta = 0.2 * rng.normal(size=(d,))
    return beta, X, y, np.asarray(counts, np.int32)


@pytest.mark.parametrize("counts,n,d", [
    ((7, 530, 64), 530, 12),      # ragged, one count below any tile
    ((3, 100), 100, 130),         # d not a multiple of 128, past one tile
    ((256, 200, 1), 256, 128),    # a full-width institution
    ((700, 90), 530, 12),         # a count past N_max reads N_max rows
])
def test_k3_plain_matches_fused_irls_sim(counts, n, d):
    beta, X, y, cnt = _irls_case(sum(counts) + d, counts, n, d)
    Xm = X.astype(np.float32)
    Hj, gj, devj = fused_irls_sim(jnp.asarray(beta), jnp.asarray(X),
                                  jnp.asarray(Xm), jnp.asarray(y),
                                  jnp.asarray(cnt))
    H, g, dev = fused_irls_kernel(
        torch.as_tensor(beta), torch.as_tensor(X), torch.as_tensor(Xm),
        torch.as_tensor(y), torch.as_tensor(cnt))
    assert H.dtype == torch.float32 and g.dtype == torch.float64
    Hj = np.asarray(Hj)
    np.testing.assert_allclose(H.numpy(), Hj, rtol=0,
                               atol=2e-5 * np.abs(Hj).max())
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(gj)).max())
    np.testing.assert_allclose(dev.numpy(), np.asarray(devj), rtol=1e-12)


def test_k3_ops_matches_f64_oracle():
    """ops.fused_irls (f32 Gram) vs the float64 ref oracle."""
    beta, X, y, cnt = _irls_case(3, (50, 80), 80, 20)
    Xt, yt, bt = map(torch.as_tensor, (X, y, beta))
    H, g, dev = ops.fused_irls(bt, Xt, yt, torch.as_tensor(cnt))
    Hr, gr, devr = ref.fused_irls(bt, Xt, yt, torch.as_tensor(cnt))
    np.testing.assert_allclose(H.numpy(), Hr.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g.numpy(), gr.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(dev.numpy(), devr.numpy(), rtol=1e-12)


def test_cpu_tensors_take_the_plain_path_without_counting():
    """On a CPU tensor a wrapper runs the plain version and its launch
    counter does not move; the counters count kernel launches only."""
    before = (encode_share_kernel.launches, reconstruct_kernel.launches,
              fused_irls_kernel.launches)
    beta, X, y, cnt = _irls_case(4, (5, 9), 9, 4)
    args = [torch.as_tensor(a) for a in (beta, X, X.astype(np.float32), y,
                                         cnt)]
    for a, b in zip(fused_irls_kernel(*args), fused_irls_plain(*args)):
        assert torch.equal(a, b)
    shares, _ = _jax_shares(FIELD_WIDE, 2, 3, 8, seed=5)
    reconstruct_kernel(torch.as_tensor(shares[:2].astype(np.int32)), (1, 2),
                       FIELD_WIDE.moduli, 28)
    assert (encode_share_kernel.launches, reconstruct_kernel.launches,
            fused_irls_kernel.launches) == before


def test_wrappers_reject_bad_inputs():
    x = torch.zeros(8, 128)
    with pytest.raises(TypeError):
        encode_share_kernel(x, torch.zeros(2, 1, 8, 128, dtype=torch.int64),
                            FIELD_WIDE.moduli, 28, (1, 2, 3))
    with pytest.raises(ValueError):
        encode_share_kernel(torch.zeros(8, 64), torch.zeros(
            2, 1, 8, 64, dtype=torch.int32), FIELD_WIDE.moduli, 28, (1,))
    with pytest.raises(ValueError, match="descending"):
        reconstruct_kernel(torch.zeros(2, 2, 8, 128, dtype=torch.int32),
                           (1, 2), tuple(reversed(FIELD_WIDE.moduli)), 28)
    # a device that is neither the card, the CPU nor ``meta`` (the dry
    # run's, which gets the outputs' shapes) raises
    class Elsewhere:
        device = torch.device("xla")

    with pytest.raises(ValueError, match="no K3"):
        fused_irls_kernel(*[Elsewhere()] * 5)


# -- past 16 shares: (t, w) = (2, 17) and (17, 20) ---------------------------
# The card's K1, K2 and K4 once capped t and w at 16; the plain versions
# never did.  (2, 17) runs the JAX package's interpret-mode kernels; at
# (17, 20) K1's interpret compile takes over a minute, so the JAX side
# there is its reference path (the codec's encode and ``ref.shamir_shares``
# for the shares, ``ShamirScheme.reconstruct`` and the decode for the
# reveal), as the JAX package's own oracles.

@pytest.mark.parametrize("t,w", [(2, 17), (17, 20)])
def test_k1_plain_matches_jax_past_sixteen_shares(t, w):
    from repro.kernels import ref as jref

    rng = np.random.default_rng(t * w)
    rows = 8
    x = _payload(rng, rows, np.float64, FIELD_WIDE)
    coeffs = np.stack([rng.integers(0, p, size=(t - 1, rows, 128))
                       for p in FIELD_WIDE.moduli])
    got = ops.shamir_protect_flat(
        torch.as_tensor(x), torch.as_tensor(coeffs.astype(np.int32)), w,
        FIELD_WIDE.moduli, 28).numpy().astype(np.int64)
    if t == 2:
        want = np.asarray(jops.shamir_protect_flat(
            jnp.asarray(x), jnp.asarray(coeffs.astype(np.uint32)), w,
            FIELD_WIDE.moduli, 28)).astype(np.int64)
    else:
        enc = JCodec(field=FIELD_WIDE).encode(jnp.asarray(x))
        want = np.stack([np.asarray(jref.shamir_shares(
            enc[r].reshape(-1), jnp.asarray(coeffs[r].astype(np.uint64))
            .reshape(t - 1, -1), w, p)).reshape(w, rows, 128)
            for r, p in enumerate(FIELD_WIDE.moduli)], axis=1)
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("t,w,points", [(2, 17, (3, 17)),
                                        (2, 17, tuple(range(1, 18))),
                                        (17, 20, tuple(range(4, 21)))])
def test_k2_plain_matches_jax_past_sixteen_shares(t, w, points):
    """Reveals of JAX-made shares from a 2-subset, all 17 and a 17-subset
    of 20; the all-17 case also against the interpret-mode kernel."""
    shares, x = _jax_shares(FIELD_WIDE, t, w, 8, seed=t + w)
    sel = np.asarray([p - 1 for p in points])
    got = ops.shamir_reveal_flat(
        torch.as_tensor(shares[sel].astype(np.int32)), points,
        FIELD_WIDE.moduli, 28).numpy()
    jscheme = JScheme(threshold=t, num_shares=w, field=FIELD_WIDE)
    want = np.asarray(JCodec(field=FIELD_WIDE).decode(jscheme.reconstruct(
        jnp.asarray(shares[sel].astype(np.uint64)), list(points))))
    np.testing.assert_array_equal(got, want)
    if len(points) == 17 and t == 2:
        np.testing.assert_array_equal(got, np.asarray(jops.shamir_reveal_flat(
            jnp.asarray(shares[sel]), points, FIELD_WIDE.moduli, 28)))
    np.testing.assert_allclose(got, x, atol=2.0**-28)


@pytest.mark.parametrize("t,w", [(2, 17), (17, 20)])
def test_k4_plain_matches_jax_reference_past_sixteen_shares(t, w):
    from repro.kernels import ref as jref
    from repro_torch.kernels.shamir_poly import share_plain

    rng = np.random.default_rng(w)
    n = 300
    secret = np.stack([rng.integers(0, p, size=n)
                       for p in FIELD_WIDE.moduli])
    coeffs = np.stack([rng.integers(0, p, size=(t - 1, n))
                       for p in FIELD_WIDE.moduli])
    got = share_plain(torch.as_tensor(secret), torch.as_tensor(coeffs),
                      FIELD_WIDE.moduli, w).numpy()
    for r, p in enumerate(FIELD_WIDE.moduli):
        want = jref.shamir_shares(jnp.asarray(secret[r].astype(np.uint64)),
                                  jnp.asarray(coeffs[r].astype(np.uint64)),
                                  w, p)
        np.testing.assert_array_equal(got[:, r],
                                      np.asarray(want).astype(np.int64))
