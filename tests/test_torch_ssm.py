"""The port's recurrent mixers (``repro_torch.models.ssm``) against the
JAX package's ``repro.models.ssm``, on the CPU.

First the mirror of ``tests/test_models_chunked.py`` on the port: the
chunked (GLA-form) RWKV6 recurrence against the per-token one, for
ragged tails, strong decay, gradients and the carried state, at that
file's tolerances (2e-5; 3e-5 for strong decay; 5e-5 for gradients).
Then every function against JAX's on the same numpy inputs from a seed:
``_rwkv6_recurrence``, ``_rwkv6_chunked``, ``rwkv6_mix`` (fresh, and from
a carried state and previous token; per-token and chunked),
``rwkv6_channelmix``, ``_rglru_recurrence`` and ``rglru_block`` (fresh
and from a carried state): outputs and states within 2e-5 of their max
in float32, 2e-2 in bf16 (the two frameworks round bf16 at other
places).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.configs import smoke_config
from repro_torch.models import ssm
from repro_torch.models import transformer as T

F32_TOL, BF16_TOL = 2e-5, 2e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(a, dtype=torch.float32):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(dtype)


def _close(got, want, tol, what=""):
    want = _np(want)
    err = float(np.abs(_np(got) - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


def _inputs(seed, B=2, S=48, H=3, D=8, w_lo=0.3, w_hi=0.999):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(w_lo, w_hi, (B, S, H, D)).astype(np.float32)
    u = (0.5 * rng.standard_normal((H, D))).astype(np.float32)
    s0 = (0.3 * rng.standard_normal((B, H, D, D))).astype(np.float32)
    return r, k, v, w, u, s0


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


# ------------------------------------ chunked vs per-token (the JAX mirror)
@pytest.mark.parametrize("S,chunk", [(48, 16), (64, 16), (50, 16), (7, 16),
                                     (48, 8)])
def test_chunked_matches_per_token(S, chunk):
    args = _t(_inputs(S, S=S))
    o_ref, s_ref = ssm._rwkv6_recurrence(*args)
    o_chk, s_chk = ssm._rwkv6_chunked(*args, chunk=chunk)
    torch.testing.assert_close(o_chk, o_ref, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(s_chk, s_ref, rtol=2e-5, atol=2e-5)


def test_chunked_strong_decay_exact():
    """Fast-decay channels (w -> 1e-6): the overflow-prone regime for
    factored GLA; the exact pairwise form must still match."""
    args = _t(_inputs(1, S=64, w_lo=1e-6, w_hi=1.0))
    o_ref, s_ref = ssm._rwkv6_recurrence(*args)
    o_chk, s_chk = ssm._rwkv6_chunked(*args, chunk=16)
    torch.testing.assert_close(o_chk, o_ref, rtol=3e-5, atol=3e-5)
    torch.testing.assert_close(s_chk, s_ref, rtol=3e-5, atol=3e-5)
    assert bool(torch.isfinite(o_chk).all())


def _chunked_gradients_match(S, chunk):
    r, k, v, w, u, s0 = _t(_inputs(2, S=S, B=1, H=2, D=6))

    def grads(fn):
        rr, kk = (t.clone().requires_grad_(True) for t in (r, k))
        o, s = fn(rr, kk, v, w, u, s0)
        weight = torch.cos(torch.arange(o.numel(), dtype=torch.float32)
                           ).reshape(o.shape)
        return torch.autograd.grad((o * weight).sum() + s.sum(), (rr, kk))

    g_ref = grads(ssm._rwkv6_recurrence)
    g_chk = grads(lambda *a: ssm._rwkv6_chunked(*a, chunk=chunk))
    for a, b in zip(g_chk, g_ref):
        torch.testing.assert_close(a, b, rtol=5e-5, atol=5e-5)


def test_chunked_gradients_match():
    _chunked_gradients_match(32, 8)


def test_chunked_gradients_match_at_the_training_chunk():
    """``rwkv_chunk`` 32, the JAX package's training preset, over two
    chunks and a ragged tail (each chunk under the checkpoint)."""
    _chunked_gradients_match(70, 32)


def test_chunked_state_carry_composes():
    """Running two chunked halves back-to-back == one full pass."""
    r, k, v, w, u, s0 = _t(_inputs(3, S=64))
    o_full, s_full = ssm._rwkv6_chunked(r, k, v, w, u, s0, chunk=16)
    h = 32
    o1, s1 = ssm._rwkv6_chunked(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u,
                                s0, chunk=16)
    o2, s2 = ssm._rwkv6_chunked(r[:, h:], k[:, h:], v[:, h:], w[:, h:], u,
                                s1, chunk=16)
    torch.testing.assert_close(torch.cat([o1, o2], dim=1), o_full,
                               rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(s2, s_full, rtol=2e-5, atol=2e-5)


# ------------------------------------------------------- against the JAX ssm
@pytest.mark.parametrize("S,chunk", [(48, 0), (50, 16), (48, 8), (80, 32)])
def test_rwkv6_recurrences_match_jax(S, chunk):
    arrays = _inputs(10 + S, S=S)
    if chunk:
        got = ssm._rwkv6_chunked(*_t(arrays), chunk=chunk)
        want = jssm._rwkv6_chunked(*map(jnp.asarray, arrays), chunk=chunk)
    else:
        got = ssm._rwkv6_recurrence(*_t(arrays))
        want = jssm._rwkv6_recurrence(*map(jnp.asarray, arrays))
    _close(got[0], want[0], F32_TOL, "out")
    _close(got[1], want[1], F32_TOL, "state")


def _params(kind, cfg, seed, dtype):
    """Seeded numpy leaves of one block of ``kind`` (the mixer's and, for
    RWKV6, the channel mix's), as (JAX, port) dicts: token-shift mixes in
    [0, 1], decay logits around -1, RG-LRU's lambda JAX's linspace, the
    rest normal, matrices scaled by fan_in**-0.5."""
    rng = np.random.default_rng(seed)
    shapes = T._block_param_shapes(cfg, kind)
    out = {}
    for name, shape in shapes.items():
        if not name.startswith(("rwkv", "lru")):
            continue
        if name.startswith("rwkv_mu"):
            a = rng.uniform(0.0, 1.0, shape)
        elif name == "rwkv_w0":
            a = rng.normal(-1.0, 0.5, shape)
        elif name == "lru_lambda":
            a = np.linspace(1.0, 4.0, shape[0])
        elif len(shape) == 2:
            a = rng.standard_normal(shape) * shape[0] ** -0.5
        else:
            a = 0.5 * rng.standard_normal(shape)
        out[name] = a.astype(np.float32)
    pairs = {n: _pair(a, dtype) for n, a in out.items()}
    return ({n: j for n, (j, _) in pairs.items()},
            {n: t for n, (_, t) in pairs.items()})


def _x(seed, shape, dtype):
    return _pair(np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32), dtype)


DTYPES = [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)]


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("carried", [False, True])
def test_rwkv6_mix_matches_jax(dtype, tol, chunk, carried):
    """The time mix, fresh (a prefill) or from a carried state and
    previous token (a continued sequence), per-token or chunked."""
    cfg = dataclasses.replace(smoke_config("rwkv6_3b"), rwkv_chunk=chunk)
    B, S, d = 2, 40, cfg.d_model
    H, D = cfg.num_heads, cfg.rwkv_head_dim
    jp, tp = _params(("rwkv6", "channelmix"), cfg, 20, dtype)
    jx, x = _x(21, (B, S, d), dtype)
    kw, jkw = {}, {}
    if carried:
        rng = np.random.default_rng(22)
        js, s = _pair((0.3 * rng.standard_normal((B, H, D, D))).astype(
            np.float32))
        jpx, px = _x(23, (B, d), dtype)
        kw, jkw = dict(state=s, prev_x=px), dict(state=js, prev_x=jpx)
    y, (st, last) = ssm.rwkv6_mix(tp, x, cfg, **kw)
    jy, (jst, jlast) = jssm.rwkv6_mix(jp, jx, cfg, **jkw)
    assert y.dtype == dtype and st.dtype == torch.float32
    _close(y, jy, tol, "y")
    _close(st, jst, tol, "state")
    assert torch.equal(last, x[:, -1])


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("carried", [False, True])
def test_rwkv6_channelmix_matches_jax(dtype, tol, carried):
    cfg = smoke_config("rwkv6_3b")
    B, S, d = 2, 40, cfg.d_model
    jp, tp = _params(("rwkv6", "channelmix"), cfg, 30, dtype)
    jx, x = _x(31, (B, S, d), dtype)
    jpx, px = _x(32, (B, d), dtype) if carried else (None, None)
    y, last = ssm.rwkv6_channelmix(tp, x, prev_x=px)
    jy, _ = jssm.rwkv6_channelmix(jp, jx, prev_x=jpx)
    assert y.dtype == dtype
    _close(y, jy, tol, "y")
    assert torch.equal(last, x[:, -1])


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["f32", "bf16"])
def test_rglru_recurrence_matches_jax(dtype, tol):
    rng = np.random.default_rng(40)
    B, S, W = 2, 48, 32
    a = rng.uniform(0.5, 0.9999, (B, S, W)).astype(np.float32)
    jgx, gx = _x(41, (B, S, W), dtype)
    h0 = (0.5 * rng.standard_normal((B, W))).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    hs, h = ssm._rglru_recurrence(torch.from_numpy(a), gx,
                                  torch.from_numpy(h0), out_dtype=dtype)
    jhs, jh = jssm._rglru_recurrence(jnp.asarray(a), jgx, jnp.asarray(h0),
                                     out_dtype=jdt)
    assert hs.dtype == dtype and h.dtype == torch.float32
    _close(hs, jhs, tol, "hs")
    _close(h, jh, tol, "h")


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("S,carried", [(40, False), (40, True), (1, True)])
def test_rglru_block_matches_jax(dtype, tol, S, carried):
    """Fresh (a prefill), from a carried carry and conv tail, and one
    decode step."""
    cfg = smoke_config("recurrentgemma_9b")
    B, d, W, cw = 2, cfg.d_model, cfg.lru_width, cfg.conv_width
    jp, tp = _params(("rglru", "dense"), cfg, 50, dtype)
    jx, x = _x(51 + S, (B, S, d), dtype)
    state = jstate = None
    if carried:
        jh, h = _pair((0.5 * np.random.default_rng(52).standard_normal(
            (B, W))).astype(np.float32))
        jc, c = _x(53, (B, cw - 1, W), dtype)
        state, jstate = (h, c), (jh, jc)
    y, (h_last, tail) = ssm.rglru_block(tp, x, cfg, state=state)
    jy, (jh_last, jtail) = jssm.rglru_block(jp, jx, cfg, state=jstate)
    assert y.dtype == dtype and h_last.dtype == torch.float32
    assert tail.dtype == dtype and tuple(tail.shape) == (B, cw - 1, W)
    _close(y, jy, tol, "y")
    _close(h_last, jh_last, tol, "h")
    # the conv tail is the last cw - 1 inputs of lru_in: a projection,
    # the same matmul in both
    _close(tail, jtail, tol, "conv tail")
