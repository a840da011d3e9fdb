"""Port vs JAX package: the leaf-wise Shamir kernel backend (K4, and K2 in
its residues mode).

On a CPU tensor the K4 and K2 wrappers run their plain versions, so these
tests hold those versions (the CUDA kernels' oracles on the card) against
the JAX package's Pallas kernels in interpret mode, as its own tests run
them.  Everything here is exact field arithmetic: shares, reconstructions
and reveals are held bit-identical.  The JAX side gets the port's
coefficients as numpy, so both evaluate the same polynomials.
"""
import itertools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core.collective import SecureCollective as JCollective
from repro.core.field import FIELD31 as JFIELD31
from repro.core.field import FIELD_WIDE as JFIELD_WIDE
from repro.core.shamir import ShamirScheme as JScheme
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.collective import SecureCollective
from repro_torch.core.field import FIELD31, FIELD_WIDE
from repro_torch.core.fixed_point import FixedPointCodec
from repro_torch.core.shamir import ShamirScheme
from repro_torch.kernels import ops
from repro_torch.kernels.shamir_poly import share_kernel, share_plain
from repro_torch.kernels.shamir_reconstruct import reconstruct_kernel

P31, P31B = 2**31 - 1, 2**31 - 19
FIELDS = {"field31": (FIELD31, JFIELD31), "wide": (FIELD_WIDE, JFIELD_WIDE)}


def _elements(seed, shape, moduli):
    """Reduced field elements (R, *shape) from numpy, first and last of
    each residue pinned to 0 and p - 1."""
    rng = np.random.default_rng(seed)
    out = np.stack([rng.integers(0, p, size=shape) for p in moduli])
    flat = out.reshape(len(moduli), -1)
    if flat.size:
        flat[:, 0] = 0
        flat[:, -1] = np.asarray(moduli) - 1
    return out


def _k4_case(p, t, n):
    secret = _elements(t * 100 + n, (n,), (p,))[0]
    coeffs = _elements(t * 100 + n + 1, (t - 1, n), (p,))[0]
    return secret, coeffs


GRID = list(itertools.product((P31, P31B), ((2, 3), (3, 5), (5, 9)),
                              (1, 100, 4096)))


@pytest.mark.parametrize("p,tw,n", GRID)
def test_k4_plain_matches_jax_oracle(p, tw, n):
    """The plain K4 (through the port's per-residue ``ops.shamir_shares``)
    against the JAX package's ``ref.shamir_shares`` at the shapes of its
    kernel tests."""
    t, w = tw
    secret, coeffs = _k4_case(p, t, n)
    got = ops.shamir_shares(torch.as_tensor(secret), torch.as_tensor(coeffs),
                            w, p)
    want = jref.shamir_shares(jnp.asarray(secret, jnp.uint64),
                              jnp.asarray(coeffs, jnp.uint64), w, p)
    assert got.dtype == torch.int64 and tuple(got.shape) == (w, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _check_k4_against_jax_kernel(p, t, w, n):
    secret, coeffs = _k4_case(p, t, n)
    got = ops.shamir_shares(torch.as_tensor(secret), torch.as_tensor(coeffs),
                            w, p)
    want = jops.shamir_shares(jnp.asarray(secret, jnp.uint64),
                              jnp.asarray(coeffs, jnp.uint64), w, p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# the interpret-mode kernel compiles once per static (t, w, p, tile) set,
# seconds each (8 s for t=5, w=9), so two cases run by default and the
# whole grid with -m slow
@pytest.mark.parametrize("p,tw,n", [(P31, (2, 3), 4096), (P31B, (3, 5), 1)])
def test_k4_plain_matches_jax_kernel(p, tw, n):
    _check_k4_against_jax_kernel(p, *tw, n)


@pytest.mark.slow
@pytest.mark.parametrize("p,tw,n", GRID)
def test_k4_plain_matches_jax_kernel_full_grid(p, tw, n):
    _check_k4_against_jax_kernel(p, *tw, n)


def test_k4_takes_every_residue_in_one_call():
    """One wrapper call shares all R residues, holder axis leading, each
    residue equal to its own per-modulus evaluation."""
    secret = torch.as_tensor(_elements(3, (77,), FIELD_WIDE.moduli))
    coeffs = torch.as_tensor(_elements(4, (2, 77), FIELD_WIDE.moduli)
                             .transpose(1, 0, 2).copy())  # (R, t-1, n)
    before = share_kernel.launches
    out = share_kernel(secret, coeffs, FIELD_WIDE.moduli, 4)
    assert share_kernel.launches == before  # CPU tensors: the plain version
    assert tuple(out.shape) == (4, 2, 77)
    for r, p in enumerate(FIELD_WIDE.moduli):
        assert torch.equal(out[:, r],
                           ops.shamir_shares(secret[r], coeffs[r], 4, p))


def test_k4_refuses_what_the_kernel_cannot_take():
    s = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="w <= 16"):
        share_plain(s, torch.zeros((1, 1, 8), dtype=torch.int64), (P31,), 17)
    with pytest.raises(ValueError, match="t-1 <= 15"):
        share_plain(s, torch.zeros((1, 16, 8), dtype=torch.int64), (P31,), 3)
    with pytest.raises(TypeError, match="int64"):
        share_plain(s.int(), torch.zeros((1, 1, 8), dtype=torch.int32),
                    (P31,), 3)
    with pytest.raises(ValueError, match="coeffs must be"):
        share_plain(s, torch.zeros((1, 1, 9), dtype=torch.int64), (P31,), 3)
    with pytest.raises(ValueError, match="31 bits"):
        ops.shamir_shares(s[0], torch.zeros((1, 8), dtype=torch.int64), 3,
                          2**31 + 11)


@pytest.mark.parametrize("field", sorted(FIELDS))
@pytest.mark.parametrize("t,w", [(1, 3), (2, 3), (3, 5)])
def test_scheme_share_with_coeffs_backends_agree(field, t, w):
    """``ShamirScheme(backend="kernel")`` shares bit-identically to the
    reference backend and to the JAX ``backend="pallas"`` on the same
    coefficients, t = 1 (every share is the secret) included."""
    tf, jf = FIELDS[field]
    shape = (5, 7)
    secret = _elements(t + w, shape, tf.moduli)
    coeffs = _elements(t + w + 1, (t - 1,) + shape, tf.moduli)
    sec_t, co_t = torch.as_tensor(secret), torch.as_tensor(coeffs)
    got = ShamirScheme(t, w, tf, backend="kernel").share_with_coeffs(
        sec_t, co_t)
    ref = ShamirScheme(t, w, tf).share_with_coeffs(sec_t, co_t)
    want = JScheme(t, w, jf, backend="pallas").share_with_coeffs(
        jnp.asarray(secret, jnp.uint64), jnp.asarray(coeffs, jnp.uint64))
    assert tuple(got.shape) == (w, tf.num_residues) + shape
    assert torch.equal(got, ref)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_scheme_reconstructs_from_any_t_subset(field):
    """The kernel backend's reconstruction (K2 residues mode, one launch
    per residue) recovers the secret exactly from every t-subset, equal to
    the reference backend's; one subset also against the JAX "pallas"."""
    tf, jf = FIELDS[field]
    t, w = 2, 4
    sch = ShamirScheme(t, w, tf, backend="kernel")
    secret = torch.as_tensor(_elements(11, (3, 130), tf.moduli))
    shares = sch.share(torch.Generator().manual_seed(0), secret)
    ref = ShamirScheme(t, w, tf)
    before = reconstruct_kernel.launches
    for pts in itertools.chain(itertools.combinations(range(1, w + 1), t),
                               [(1, 2, 3, 4)]):
        sel = shares[[p - 1 for p in pts]]
        got = sch.reconstruct(sel, list(pts))
        assert got.dtype == torch.int64
        assert torch.equal(got, secret), pts
        assert torch.equal(ref.reconstruct(sel, list(pts)), got)
    assert reconstruct_kernel.launches == before  # CPU: plain versions
    want = JScheme(t, w, jf, backend="pallas").reconstruct(
        jnp.asarray(shares[[1, 3]].numpy(), jnp.uint64), [2, 4])
    np.testing.assert_array_equal(secret.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="need >= t=2"):
        sch.reconstruct(shares[:1], [1])


def test_ops_shamir_reconstruct_pads_and_cuts_tiles():
    """The per-residue K2 call: n not a multiple of 128, points out of
    order, int64 in and out."""
    p = P31B
    secret = torch.as_tensor(_elements(5, (300,), (p,))[0])
    coeffs = torch.as_tensor(_elements(6, (2, 300), (p,))[0])
    shares = ops.shamir_shares(secret, coeffs, 5, p)
    rec = ops.shamir_reconstruct(shares[[4, 0, 2]], (5, 1, 3), p)
    assert rec.dtype == torch.int64 and torch.equal(rec, secret)
    want = jops.shamir_reconstruct(
        jnp.asarray(shares[[4, 0, 2]].numpy(), jnp.uint64), (5, 1, 3), p)
    np.testing.assert_array_equal(rec.numpy(), np.asarray(want))


def test_collective_reveals_a_leafwise_share_tree_like_jax():
    """``SecureCollective(backend="kernel").reveal`` of a per-leaf share
    tree (the reference backend's protect output) reconstructs through
    the kernel scheme and equals the JAX package's reveal bit for bit."""
    rng = np.random.default_rng(2)
    tree = {"gradient": rng.normal(size=(9,)) * 5.0,
            "hessian": rng.normal(size=(9, 9)) * 30.0,
            "deviance": np.asarray(412.75)}
    prot = SecureCollective(backend="reference").protect(
        torch.Generator().manual_seed(1),
        {k: torch.as_tensor(v) for k, v in tree.items()})
    agg = SecureCollective(backend="kernel")
    jagg = JCollective(backend="pallas")
    for pts in (None, (1, 3), (2, 3)):
        if pts is None:
            sel_p, sel_j = prot, {k: jnp.asarray(v.numpy(), jnp.uint64)
                                  for k, v in prot.items()}
        else:
            idx = [p - 1 for p in pts]
            sel_p = {k: v[idx] for k, v in prot.items()}
            sel_j = {k: jnp.asarray(v[idx].numpy(), jnp.uint64)
                     for k, v in prot.items()}
        got = agg.reveal(sel_p, points=pts)
        want = jagg.reveal(sel_j, points=pts)
        for k in tree:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
            np.testing.assert_allclose(got[k].numpy(), tree[k],
                                       atol=2.0**-28)


def test_share_pytree_round_trip_on_the_kernel_backend():
    codec = FixedPointCodec()
    sch = ShamirScheme(2, 3, backend="kernel")
    x = {"a": torch.linspace(-3.0, 3.0, 257, dtype=torch.float64),
         "b": torch.tensor(1.25, dtype=torch.float64)}
    enc = {k: codec.encode(v) for k, v in x.items()}
    shares = sch.share_pytree(torch.Generator().manual_seed(4), enc)
    rec = sch.reconstruct_pytree({k: v[1:] for k, v in shares.items()},
                                 [2, 3])
    for k in x:
        assert torch.equal(rec[k], enc[k])
        np.testing.assert_allclose(codec.decode(rec[k]).numpy(),
                                   x[k].numpy(), atol=2.0**-28)
