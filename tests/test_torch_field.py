"""Port vs JAX package: field, fixed-point codec and flat-buffer layout.

Everything here is exact integer or power-of-two arithmetic, so the
tolerance is zero: the port must be bit-identical to the JAX package on
the same inputs (made with numpy from a seed).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import field as jfield
from repro.core import flatbuf as jflat
from repro.core.collective import (
    check_aggregation_headroom as j_headroom,
)
from repro.core.fixed_point import FixedPointCodec as JCodec
from repro.kernels.shamir_reconstruct import (
    lagrange_weights_host as j_lagrange,
)
from repro_torch.core import field as tfield
from repro_torch.core import flatbuf as tflat
from repro_torch.core.collective import check_aggregation_headroom
from repro_torch.core.fixed_point import FixedPointCodec
from repro_torch.core.shamir import ShamirScheme
from repro_torch.kernels.shamir_reconstruct import lagrange_weights_host

FIELDS = [("field31", tfield.FIELD31, jfield.FIELD31),
          ("field_wide", tfield.FIELD_WIDE, jfield.FIELD_WIDE)]


def _edge_values(field) -> np.ndarray:
    """Ties at the quantum, clip edges, negatives, zeros."""
    q = 2.0**-28
    cap = field.max_signed / 2**28
    ties = np.array([k + 0.5 for k in range(-4, 4)]) * q
    return np.concatenate([
        ties, [0.0, -0.0, q, -q, 1.5 * q, -2.5 * q],
        [cap, -cap, cap * 0.999999, -cap * 0.999999, cap * 2, -cap * 2,
         1e30, -1e30],
        np.random.default_rng(0).normal(size=64) * 100.0,
    ])


@pytest.mark.parametrize("name,tf,jf", FIELDS, ids=[f[0] for f in FIELDS])
def test_codec_encode_decode_bit_identical(name, tf, jf):
    x = _edge_values(tf)
    got = FixedPointCodec(field=tf).encode(torch.as_tensor(x))
    want = np.asarray(JCodec(field=jf).encode(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    dec = FixedPointCodec(field=tf).decode(got)
    want_dec = np.asarray(JCodec(field=jf).decode(jnp.asarray(want)))
    np.testing.assert_array_equal(dec.numpy(), want_dec)


@pytest.mark.parametrize("name,tf,jf", FIELDS, ids=[f[0] for f in FIELDS])
def test_crt_and_lift_edges_bit_identical(name, tf, jf):
    m = tf.max_signed
    v = np.array([0, 1, -1, m, -m, m - 1, -(m - 1), m // 3, -(m // 3),
                  12345678901 % m, -(12345678901 % m)], dtype=np.int64)
    res = tfield.lift_signed(torch.as_tensor(v), tf)
    want = np.asarray(jfield.lift_signed(jnp.asarray(v), jf))
    np.testing.assert_array_equal(res.numpy(), want.astype(np.int64))
    back = tfield.crt_combine_signed(res, tf)
    np.testing.assert_array_equal(back.numpy(), v)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jfield.crt_combine_signed(
            jnp.asarray(want), jf)))


@pytest.mark.parametrize("name,tf,jf", FIELDS, ids=[f[0] for f in FIELDS])
def test_fsum_of_int32_shares_bit_identical(name, tf, jf):
    rng = np.random.default_rng(1)
    stacked = np.stack([
        np.stack([rng.integers(p - 50, p, size=(3, 40)) for p in tf.moduli])
        for _ in range(9)
    ]).astype(np.int32)  # (S, R, ...) near the modulus
    got = tfield.fsum(torch.as_tensor(stacked), tf, axis=0, residue_axis=0)
    want = jfield.fsum(jnp.asarray(stacked.astype(np.uint32)), jf, axis=0,
                       residue_axis=0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.asarray(want).astype(np.int64))


def test_int64_headroom_edge():
    """S * max(p) < 2**63 is the port's exact-sum bound: the largest
    admissible S passes, one more raises; the JAX uint64 bound admits
    roughly twice as many."""
    p = max(tfield.FIELD_WIDE.moduli)
    edge = (2**63 - 1) // p
    check_aggregation_headroom(edge, tfield.FIELD_WIDE)
    with pytest.raises(ValueError, match="2\\*\\*63"):
        check_aggregation_headroom(edge + 1, tfield.FIELD_WIDE)
    j_headroom(edge + 1, jfield.FIELD_WIDE)  # still fine under uint64
    # an int64 sum of residues just below p stays exact: check vs big ints
    vals = torch.full((1000, 2, 4), p - 1, dtype=torch.int64)
    got = tfield.fsum(vals, tfield.FIELD_WIDE, axis=0, residue_axis=0)
    for r, pr in enumerate(tfield.FIELD_WIDE.moduli):
        assert int(got[r, 0]) == (1000 * (p - 1)) % pr


def test_host_helpers_match():
    for points in [(1, 2), (1, 3), (2, 3), (1, 2, 3), (1, 4, 5), (2, 3, 5)]:
        assert lagrange_weights_host(points, tfield.FIELD_WIDE.moduli) == \
            j_lagrange(points, jfield.FIELD_WIDE.moduli)
    for p in tfield.FIELD_WIDE.moduli:
        assert tfield.finv_host(12345, p) == jfield.finv_host(12345, p)
        assert tfield.fpow_host(3, 77, p) == jfield.fpow_host(3, 77, p)
    with pytest.raises(ZeroDivisionError):
        tfield.finv_host(0, 7)


def test_random_elements_in_range():
    g = torch.Generator().manual_seed(0)
    r = tfield.random_elements(g, (5, 300), tfield.FIELD_WIDE)
    assert r.shape == (2, 5, 300) and r.dtype == torch.int64
    for i, p in enumerate(tfield.FIELD_WIDE.moduli):
        assert int(r[i].min()) >= 0 and int(r[i].max()) < p


@pytest.mark.parametrize("name,tf,jf", FIELDS, ids=[f[0] for f in FIELDS])
def test_reference_shamir_matches_jax_given_coeffs(name, tf, jf):
    from repro.core.shamir import ShamirScheme as JScheme

    rng = np.random.default_rng(2)
    t, w = 3, 5
    secret = np.stack([rng.integers(0, p, size=(4, 7))
                       for p in tf.moduli]).astype(np.int64)
    coeffs = np.stack([rng.integers(0, p, size=(t - 1, 4, 7))
                       for p in tf.moduli]).astype(np.int64)
    sch = ShamirScheme(threshold=t, num_shares=w, field=tf)
    got = sch.share_with_coeffs(torch.as_tensor(secret),
                                torch.as_tensor(coeffs))
    want = JScheme(threshold=t, num_shares=w, field=jf).share_with_coeffs(
        jnp.asarray(secret.astype(np.uint64)),
        jnp.asarray(coeffs.astype(np.uint64)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))
    rec = sch.reconstruct(got[torch.tensor([0, 3, 4])], points=[1, 4, 5])
    np.testing.assert_array_equal(rec.numpy(), secret)


def _summary_tree(rng, s_dim, d):
    return {
        "hessian": rng.normal(size=(s_dim, d, d)),
        "gradient": rng.normal(size=(s_dim, d)),
        "deviance": rng.normal(size=(s_dim,)),
    }


@pytest.mark.parametrize("d", [3, 8, 11, 128])
def test_flatbuf_matches_jax_offsets_and_rows(d):
    rng = np.random.default_rng(d)
    tree = _summary_tree(rng, 3, d)
    buf, layout = tflat.pack_pytree_batched(
        {k: torch.as_tensor(v) for k, v in tree.items()})
    jbuf, jlayout = jflat.pack_pytree_batched(
        {k: jnp.asarray(v) for k, v in tree.items()})
    assert layout.rows == jlayout.rows
    assert layout.shapes == jlayout.shapes
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    one = {k: torch.as_tensor(v[0]) for k, v in tree.items()}
    b1, l1 = tflat.pack_pytree(one)
    jb1, jl1 = jflat.pack_pytree({k: jnp.asarray(v[0])
                                  for k, v in tree.items()})
    assert l1.rows == jl1.rows
    np.testing.assert_array_equal(b1.numpy(), np.asarray(jb1))
    back = tflat.unpack_pytree(b1, l1)
    for k in tree:
        np.testing.assert_array_equal(back[k].numpy(), tree[k][0])
    backs = tflat.unpack_pytree_batched(buf, layout)
    for k in tree:
        np.testing.assert_array_equal(backs[k].numpy(), tree[k])


def test_flatbuf_nested_trees_round_trip():
    tree = {"b": [torch.arange(3.0), (torch.ones(2, 2),)],
            "a": torch.tensor(5.0)}
    buf, layout = tflat.pack_pytree(tree)
    assert buf.shape == (8, 128)
    out = tflat.unpack_pytree(buf, layout)
    assert list(out) == ["a", "b"]
    assert torch.equal(out["b"][1][0], torch.ones(2, 2))
    assert isinstance(out["b"][1], tuple)
    with pytest.raises(ValueError):
        tflat.pack_pytree({})
