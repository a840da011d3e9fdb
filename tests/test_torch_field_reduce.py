"""The Shamir kernels' field arithmetic, replayed step by step on the CPU.

K1 (``csrc/shamir_poly.cu``), K2 (``csrc/shamir_reconstruct.cu``) and K4
(``csrc/shamir_share.cu``) reduce with the Barrett method of
``csrc/field_arith.cuh``, from the constants
``kernels/field_consts.py::barrett_constants`` gives their wrappers:

    q = floor(x mu / 2**64)            (__umul64hi)
    r = low 32 bits of (x - q p)       in [0, 2p)
    r - p if r >= p                    (the one correction)

Here the same steps run in numpy uint64 (the 64 x 64 high product from
32-bit limbs, the difference in 32 bits) with the same constants, over
every operand range the kernels feed the reduction: the encode's |s| up
to max_signed, a Horner step below 2**36, a group of four Lagrange terms
and a reduced sum below 2**64, Garner's product below 2**62, and the
adversarial values k p - 1, k p, 2**62 - 1, 2**64 - 1 and 0.  Each result
must equal ``%``, with at most the one correction the kernel makes.  The
kernels' whole element arithmetic is replayed too (K1's encode and
Horner, K2's grouped Lagrange sum, Garner and decode, K4's Horner over
int64 elements) and held bit for bit against their plain versions, and
the decode's multiply by 2**-frac_bits against the plain version's
divide; K4's replay also against the JAX package's interpret-mode
``ops.shamir_shares`` (the one test here that imports JAX, inside the
test).  K4's work split is replayed as well: its pairs of elements in a
grid-stride loop, the lone tail element of an odd row, and the 16-byte or
8-byte accesses each row's own address gets.  Exact integer
arithmetic: the tolerance is zero.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.field import FIELD31, FIELD_WIDE
from repro_torch.kernels.field_consts import (
    MAX_MODULUS,
    barrett_constants,
    garner_inverse,
)
from repro_torch.kernels.shamir_poly import encode_share_plain, share_plain
from repro_torch.kernels.shamir_reconstruct import (
    lagrange_weights_host,
    reconstruct_plain,
)

U64 = np.uint64
M32 = U64(0xFFFFFFFF)
CORRECTIONS = 1  # the conditional subtractions barrett_reduce makes


def _is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 2**32 (bases 2, 7, 61)."""
    if n < 2:
        return False
    for q in (2, 3, 5, 7, 61):
        if n % q == 0:
            return n == q
    d, s = n - 1, 0
    while d % 2 == 0:
        d, s = d // 2, s + 1
    for a in (2, 7, 61):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _random_primes(count: int, seed: int = 0) -> list[int]:
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        # log-uniform over (16, 2**31): small moduli as well as large
        c = int(2 ** rng.uniform(4.01, 31.0))
        if 16 < c < MAX_MODULUS and _is_prime(c):
            out.append(c)
    return out


MODULI = [FIELD31.moduli[0], FIELD_WIDE.moduli[1], *_random_primes(6)]


def umul64hi(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The high 64 bits of a * b for uint64 arrays, from 32-bit limbs."""
    a_lo, a_hi = a & M32, a >> U64(32)
    b_lo, b_hi = b & M32, b >> U64(32)
    ll, lh, hl = a_lo * b_lo, a_lo * b_hi, a_hi * b_lo
    mid = (ll >> U64(32)) + (lh & M32) + (hl & M32)
    return a_hi * b_hi + (lh >> U64(32)) + (hl >> U64(32)) + (mid >> U64(32))


def barrett_reduce(x: np.ndarray, p: int) -> np.ndarray:
    """``csrc/field_arith.cuh::barrett_reduce`` on uint64 ``x``: checks
    that the low-word difference lies in [0, 2p), so one correction ends
    it, and returns x mod p."""
    mu, p_ = barrett_constants((p,))
    x = np.asarray(x, dtype=U64)
    q = umul64hi(x, np.full_like(x, mu))
    r = ((x & M32) - (q & M32) * U64(p_)) & M32
    assert (r < U64(2 * p_)).all(), "more than one correction needed"
    return np.where(r >= U64(p_), r - U64(p_), r)


def _check_reduce(x: np.ndarray, p: int) -> None:
    got = barrett_reduce(x, p)
    want = np.array([int(v) % p for v in x.tolist()], dtype=U64)
    np.testing.assert_array_equal(got, want)


def _uniform_below(rng, hi: int, size: int) -> np.ndarray:
    """uint64 values uniform in [0, hi), for any hi <= 2**64."""
    words = rng.integers(0, 2**63, size=(size, 2), dtype=np.int64)
    v = [(int(a) << 63 | int(b)) % hi for a, b in words]
    return np.array(v, dtype=U64)


def test_umul64hi_replay_matches_python_ints():
    rng = np.random.default_rng(1)
    a = _uniform_below(rng, 2**64, 2000)
    b = _uniform_below(rng, 2**64, 2000)
    got = umul64hi(a, b)
    want = [(int(x) * int(y)) >> 64 for x, y in zip(a.tolist(), b.tolist())]
    np.testing.assert_array_equal(got, np.array(want, dtype=U64))


def test_barrett_constants_layout_and_range():
    consts = barrett_constants(FIELD_WIDE.moduli)
    assert consts == tuple(v for p in FIELD_WIDE.moduli
                           for v in ((1 << 64) // p, p))
    assert all(c < 2**64 for c in consts)
    for bad in (1, 0, -5, MAX_MODULUS, 2**32 + 15):
        with pytest.raises(ValueError, match="moduli"):
            barrett_constants((bad,))
    p1, p2 = FIELD_WIDE.moduli
    assert garner_inverse(p1, p2) * p1 % p2 == 1


def _operands(kind: str, p: int, rng, size: int = 4000) -> np.ndarray:
    """Values the kernels hand the reduction, by where they come from."""
    if kind == "encode":  # |s| <= max_signed (< 2**62) of FIELD_WIDE
        v = _uniform_below(rng, FIELD_WIDE.max_signed + 1, size)
        return np.concatenate([v, np.array([FIELD_WIDE.max_signed,
                                            FIELD31.max_signed], dtype=U64)])
    if kind == "horner":  # acc * j + c: acc < p, j <= w < 2**31, c < 2**31
        acc = _uniform_below(rng, p, size)
        j = np.concatenate([rng.integers(1, 17, size=size // 2),
                            rng.integers(17, 2**31, size=size - size // 2)]
                           ).astype(U64)
        c = _uniform_below(rng, 2**31, size)
        top = U64(p - 1) * U64(2**31 - 1) + U64(2**31 - 1)
        return np.concatenate([acc * j + c, [top]])
    if kind == "lagrange":  # a reduced sum and four terms lam * share
        acc = _uniform_below(rng, p, size)
        s = acc.copy()
        for _ in range(4):
            s = s + _uniform_below(rng, p, size) * _uniform_below(
                rng, 2**31, size)
        top = U64(p - 1) + U64(4) * U64(p - 1) * U64(2**31 - 1)
        return np.concatenate([s, [top]])
    if kind == "garner":  # diff * p1^-1 mod p2: both below p
        a, b = _uniform_below(rng, p, size), _uniform_below(rng, p, size)
        return np.concatenate([a * b, [U64(p - 1) * U64(p - 1)]])
    assert kind == "full64"
    return _uniform_below(rng, 2**64, size)


@pytest.mark.parametrize("kind", ["encode", "horner", "lagrange", "garner",
                                  "full64"])
@pytest.mark.parametrize("p", MODULI)
def test_reduction_equals_mod(p, kind):
    rng = np.random.default_rng(p % 1000 + len(kind))
    x = _operands(kind, p, rng)
    if kind == "horner":
        assert int(x.max()) < 2**62 + 2**31
    if kind == "garner":
        assert int(x.max()) < 2**62
    _check_reduce(x, p)


@pytest.mark.parametrize("p", MODULI)
def test_reduction_adversarial_values(p):
    top = (2**64 - 1) // p
    ks = sorted({1, 2, 3, 16, 2**31, 2**32 + 1, top // 2, top - 1, top})
    vals = [0, 1, p - 1, p, p + 1, 2 * p - 1, 2 * p, 2**31 - 1, 2**36 - 1,
            2**62 - 1, 2**62, 2**63, 2**64 - 2, 2**64 - 1]
    vals += [k * p - 1 for k in ks] + [k * p for k in ks if k * p < 2**64]
    _check_reduce(np.array(sorted(set(vals)), dtype=U64), p)


@pytest.mark.parametrize("frac_bits", [0, 1, 16, 28, 40, 61])
def test_decode_multiply_equals_divide(frac_bits):
    """K2 multiplies by the exact 2**-frac_bits where the plain version
    divides by 2**frac_bits: the same float64 for every signed value up
    to +-max_signed."""
    rng = np.random.default_rng(frac_bits)
    m = FIELD_WIDE.max_signed
    v = rng.integers(-m, m + 1, size=20000, dtype=np.int64)
    edges = np.array([0, 1, -1, m, -m, m - 1, -(m - 1), 2**53, 2**53 + 1,
                      -(2**53 + 1), 2**62 - 1, -(2**62 - 1)], dtype=np.int64)
    d = np.concatenate([v, edges]).astype(np.float64)
    np.testing.assert_array_equal(
        (d * 2.0 ** -frac_bits).view(np.int64),
        (d / float(1 << frac_bits)).view(np.int64))


# -- the kernels' element arithmetic, replayed -------------------------------

def k1_replay(x: np.ndarray, coeffs: np.ndarray, moduli, frac_bits: int,
              points) -> np.ndarray:
    """``encode_share_kernel``'s arithmetic on (rows, 128) ``x`` and (R,
    t-1, rows, 128) int32 ``coeffs``: (len(points), R, rows, 128) int32."""
    lim = float((np.prod([int(p) for p in moduli], dtype=object) - 1) // 2)
    if x.dtype == np.float32:
        s = np.clip(np.rint(x * np.float32(2.0**frac_bits)),
                    -np.float32(lim), np.float32(lim)).astype(np.float64)
    else:
        s = np.clip(np.rint(x * 2.0**frac_bits), -lim, lim)
    s = s.astype(np.int64)
    neg = s < 0
    mag = np.abs(s).astype(U64)
    c64 = coeffs.astype(np.int64).astype(U64)  # int32 -> 64 bits, as coeff64
    tm1 = coeffs.shape[1]
    out = np.zeros((len(points), len(moduli)) + x.shape, dtype=np.int32)
    for r, p in enumerate(moduli):
        sm = barrett_reduce(mag, p)
        secret = np.where(neg & (sm != 0), U64(p) - sm, sm)
        top = barrett_reduce(c64[r, tm1 - 1], p) if tm1 else \
            np.zeros_like(mag)
        for o, j in enumerate(points):
            acc = top
            for k in range(tm1 - 2, -1, -1):
                acc = barrett_reduce(acc * U64(j) + c64[r, k], p)
            out[o, r] = barrett_reduce(acc * U64(j) + secret, p)
    return out


def k2_replay(shares: np.ndarray, points, moduli, frac_bits):
    """``reconstruct_kernel``'s arithmetic on (k, R, rows, 128) int32
    shares: Lagrange terms summed unreduced in groups of four (checked
    never to wrap), Garner, the multiply by 2**-frac_bits."""
    lams = lagrange_weights_host(tuple(points), tuple(moduli))
    sh = shares.astype(np.int64).astype(U64)
    k = shares.shape[0]
    rec = []
    for r, p in enumerate(moduli):
        acc = np.zeros(shares.shape[2:], dtype=U64)
        for i0 in range(0, k, 4):
            s = acc.copy()
            for i in range(i0, min(i0 + 4, k)):
                nxt = s + U64(lams[r][i]) * sh[i, r]
                assert (nxt >= s).all(), "the unreduced Lagrange sum wrapped"
                s = nxt
            acc = barrett_reduce(s, p)
        rec.append(acc)
    if frac_bits is None:
        return np.stack(rec).astype(np.int32)
    if len(moduli) == 2:
        p1, p2 = moduli
        r1 = barrett_reduce(rec[0], p2)
        diff = rec[1] + U64(p2) - r1
        diff = np.where(diff >= U64(p2), diff - U64(p2), diff)
        kd = barrett_reduce(diff * U64(garner_inverse(p1, p2)), p2)
        x, m = rec[0] + U64(p1) * kd, p1 * p2
    else:
        x, m = rec[0], moduli[0]
    half = U64((m - 1) // 2)
    value = np.where(x <= half, x.astype(np.int64),
                     -(U64(m) - x).astype(np.int64))
    return value.astype(np.float64) * 2.0 ** -frac_bits


def _payload(rows: int, dtype, field, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, 128)) * 3.0
    cap = field.max_signed / 2**28
    edges = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 0.0, -0.0, cap, -cap,
                      2 * cap, -2 * cap, 1e20, -1e20])
    x.flat[:len(edges)] = edges * 2**-28
    x.flat[len(edges):2 * len(edges)] = edges
    return x.astype(dtype)


@pytest.mark.parametrize("field", [FIELD31, FIELD_WIDE], ids=lambda f: f.name)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("t,points", [(2, (1, 2, 3)), (1, (1, 2)),
                                      (3, (1, 2, 3, 4, 5)),
                                      (16, tuple(range(1, 17))),
                                      (2, tuple(range(1, 18))),
                                      (17, tuple(range(1, 21))),
                                      (33, tuple(range(1, 41)))])
def test_k1_replay_matches_plain(field, dtype, t, points):
    rows = 6
    x = _payload(rows, dtype, field, seed=t)
    rng = np.random.default_rng(t + 100)
    coeffs = np.stack([rng.integers(0, p, size=(t - 1, rows, 128))
                       for p in field.moduli]).astype(np.int32)
    want = encode_share_plain(torch.from_numpy(x), torch.from_numpy(coeffs),
                              field.moduli, 28, points)
    got = k1_replay(x, coeffs, field.moduli, 28, points)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("field", [FIELD31, FIELD_WIDE], ids=lambda f: f.name)
@pytest.mark.parametrize("points,fill", [
    ((1, 2), None), ((2, 3), None), ((2, 4, 5), None),
    (tuple(range(1, 17)), None),
    (tuple(range(1, 17)), "p-1"),  # the largest unreduced Lagrange sum
    (tuple(range(1, 18)), None),
    (tuple(range(1, 41)), None),
    (tuple(range(1, 41)), "p-1"),
])
@pytest.mark.parametrize("frac_bits", [28, None])
def test_k2_replay_matches_plain(field, points, fill, frac_bits):
    rows = 4
    rng = np.random.default_rng(len(points))
    shares = np.stack([np.stack([
        np.full((rows, 128), p - 1) if fill else
        rng.integers(0, p, size=(rows, 128)) for p in field.moduli])
        for _ in points]).astype(np.int32)
    want = reconstruct_plain(torch.from_numpy(shares), points, field.moduli,
                             frac_bits)
    got = k2_replay(shares, points, field.moduli, frac_bits)
    if frac_bits is None:
        np.testing.assert_array_equal(got, want.numpy())
    else:
        np.testing.assert_array_equal(got.view(np.int64),
                                      want.numpy().view(np.int64))


# -- K4: leaf-wise shares of int64 field elements ---------------------------

def k4_replay(secret: np.ndarray, coeffs: np.ndarray, moduli,
              w: int) -> np.ndarray:
    """``leafwise_share_kernel``'s arithmetic on (R, n) ``secret`` and (R,
    t-1, n) ``coeffs`` (reduced int64): (w, R, n) int64 shares.  The secret
    is kept as its low 32 bits, the first Horner step is the top
    coefficient reduced once a residue, and every later operand acc * j +
    c is checked to stay below 2**62 + 2**31 (j <= w < 2**31), the bound
    ``csrc/shamir_share.cu`` states."""
    tm1 = coeffs.shape[1]
    out = np.zeros((w,) + secret.shape, dtype=np.int64)
    for r, p in enumerate(moduli):
        s = secret[r].astype(U64) & M32
        c = coeffs[r].astype(U64)
        top = barrett_reduce(c[tm1 - 1], p) if tm1 else np.zeros_like(s)
        for j in range(1, w + 1):
            acc = top
            for k in range(tm1 - 2, -1, -1):
                x = acc * U64(j) + c[k]
                assert int(x.max(initial=0)) < 2**62 + 2**31
                acc = barrett_reduce(x, p)
            x = acc * U64(j) + s
            assert int(x.max(initial=0)) < 2**62 + 2**31
            out[j - 1, r] = barrett_reduce(x, p).astype(np.int64)
    return out


def _k4_inputs(moduli, tm1: int, n: int, seed: int):
    """Reduced (R, n) secrets and (R, t-1, n) coefficients, with 0 and p - 1
    among both."""
    rng = np.random.default_rng(seed)
    secret = np.stack([rng.integers(0, p, size=n) for p in moduli])
    coeffs = np.stack([rng.integers(0, p, size=(tm1, n)) for p in moduli])
    top = np.asarray(moduli) - 1
    secret[:, 0], secret[:, 1] = 0, top
    coeffs[:, :, 0], coeffs[:, :, 1] = top[:, None], 0
    coeffs[:, :, 2] = top[:, None]
    return secret.astype(np.int64), coeffs.astype(np.int64)


K4_MODULI = {"field31": FIELD31.moduli, "field_wide": FIELD_WIDE.moduli,
             "random_primes": tuple(_random_primes(6, seed=4))}


@pytest.mark.parametrize("moduli", sorted(K4_MODULI))
@pytest.mark.parametrize("tm1", range(16))
def test_k4_replay_matches_plain(moduli, tm1):
    """K4's arithmetic at every point 1..16 and every t - 1 from 0 to 15,
    bit for bit with ``share_plain``."""
    mods = K4_MODULI[moduli]
    secret, coeffs = _k4_inputs(mods, tm1, 37, seed=tm1)
    got = k4_replay(secret, coeffs, mods, 16)
    want = share_plain(torch.as_tensor(secret), torch.as_tensor(coeffs),
                       mods, 16)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("moduli", sorted(K4_MODULI))
@pytest.mark.parametrize("t,w", [(2, 17), (17, 20), (33, 40)])
def test_k4_replay_past_sixteen_shares(moduli, t, w):
    """K4's arithmetic past the 16 shares and threshold 16 it once capped:
    bit for bit with ``share_plain``."""
    mods = K4_MODULI[moduli]
    secret, coeffs = _k4_inputs(mods, t - 1, 37, seed=t * w)
    got = k4_replay(secret, coeffs, mods, w)
    want = share_plain(torch.as_tensor(secret), torch.as_tensor(coeffs),
                       mods, w)
    np.testing.assert_array_equal(got, want.numpy())


# the JAX kernel's mulmod31 folds with p = 2**31 - c (c = 1 or 19): the
# field's own moduli only.  Interpret mode compiles once per (t-1, w, p),
# for ~1.3 s per unit of t-1 at w = 16 (21 s at t-1 = 15), so two cases
@pytest.mark.parametrize("p,tm1", [(FIELD31.moduli[0], 1),
                                   (FIELD_WIDE.moduli[1], 4)])
def test_k4_replay_matches_jax_kernel(p, tm1):
    """K4's arithmetic at points 1..16 against the JAX package's
    ``ops.shamir_shares`` (interpret-mode ``shamir_poly_pallas``)."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops

    secret, coeffs = _k4_inputs((p,), tm1, 37, seed=p % 97 + tm1)
    got = k4_replay(secret, coeffs, (p,), 16)[:, 0]
    want = jops.shamir_shares(jnp.asarray(secret[0], jnp.uint64),
                              jnp.asarray(coeffs[0], jnp.uint64), 16, p)
    np.testing.assert_array_equal(got, np.asarray(want).astype(np.int64))


# -- K4's work split ---------------------------------------------------------

K4_THREADS = 128  # csrc/shamir_share.cu


def field_grid_blocks(cap: int, groups: int, threads: int) -> int:
    """``FieldGrid::blocks`` of csrc/field_arith.cuh for a card that holds
    ``cap`` blocks at once."""
    need = -(-groups // threads)
    trips = -(-need // cap)
    return -(-need // trips)


def k4_pairs(n: int, cap: int) -> np.ndarray:
    """The pairs the grid-stride loop's threads take, in launch order:
    thread t of the grid takes g = t, t + stride, ... below ceil(n / 2)."""
    pairs = (n + 1) >> 1
    stride = field_grid_blocks(cap, pairs, K4_THREADS) * K4_THREADS
    gs = [np.arange(t, pairs, stride) for t in range(min(stride, pairs))]
    return np.concatenate(gs)


def k4_pieces(row_start: int, pairs: np.ndarray, n: int):
    """The accesses ``load2``/``store2`` make for each pair of one row whose
    first element is element ``row_start`` of an allocation that starts
    16-byte aligned: (first elements, width in elements).  A whole pair at
    an even element (16-byte aligned) is one 2-wide access, at an odd one
    two 1-wide; a lone element (the tail of an odd row) one 1-wide."""
    e = pairs * 2
    whole = n - e >= 2
    a = row_start + e
    vec = whole & (a % 2 == 0)
    return [(a[vec], 2), (a[~vec], 1), (a[whole & ~vec] + 1, 1)]


def _touched(pieces, size: int) -> tuple[np.ndarray, int]:
    """Times each element of a ``size``-element allocation is touched, and
    the 2-wide accesses that are not 16-byte aligned."""
    hits = np.zeros(size, dtype=np.int64)
    misaligned = 0
    for s, wd in pieces:
        for o in range(wd):
            np.add.at(hits, s + o, 1)
        if wd == 2:
            misaligned += int((s % 2).sum())
    return hits, misaligned


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 8, 100, 4097, 100_003,
                               1_000_003])
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("R,tm1,w", [(2, 1, 3), (1, 2, 5), (3, 0, 2)])
def test_k4_work_split_writes_every_share_once(n, offset, R, tm1, w):
    """Replays K4's partition: the grid-stride loop takes every pair once;
    each (r, i) share is written exactly once and each secret and
    coefficient read once a pass, nothing outside the tensors is touched,
    and every 16-byte access is 16-byte aligned, for odd n (the rows of one
    tensor in both alignments) and for inputs that start ``offset``
    elements into their storage (the out tensor is the wrapper's own)."""
    pairs = (n + 1) >> 1
    for cap in (1, 132, 132 * 16):
        np.testing.assert_array_equal(np.sort(k4_pairs(n, cap)),
                                      np.arange(pairs))
    g = np.arange(pairs)
    sec = [p for r in range(R) for p in k4_pieces(offset + r * n, g, n)]
    co = [p for r in range(R) for k in range(tm1)
          for p in k4_pieces(offset + (r * tm1 + k) * n, g, n)]
    out = [p for j in range(w) for r in range(R)
           for p in k4_pieces((j * R + r) * n, g, n)]
    for pieces, start, size in ((sec, offset, R * n),
                                (co, offset, R * tm1 * n),
                                (out, 0, w * R * n)):
        hits, bad = _touched(pieces, start + size)
        assert bad == 0 and not hits[:start].any()
        assert (hits[start:] == 1).all()
    if n % 2 and n > 2:  # some whole pairs of out's rows are off 16 bytes
        assert any(len(out[i + 2][0]) for i in range(0, len(out), 3))
