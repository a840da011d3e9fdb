"""K8a / K8b (causal GQA flash-attention backward) on the port against the
JAX package, on the CPU.

The same numpy inputs (drawn from a seed) go through the JAX package's
``ops.flash_attention_bwd`` (its Pallas kernels in interpret mode, block
32), ``jax.grad`` of ``ref.flash_attention`` and ``flash_dq_pallas`` /
``flash_dkdv_pallas`` called directly, and through the port's
``ops.flash_attention_bwd``, ``torch.autograd.grad`` through
``ops.flash_attention`` (``FlashAttention``: K7 forward, K8 backward) and
the kernels' plain versions, which the wrappers run for CPU tensors.
Tolerances: 3e-5 in float32 (the JAX package's own backward test), 2e-2
in bfloat16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.flash_attention_bwd import flash_dkdv_pallas, \
    flash_dq_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import FlashAttention, \
    flash_attention_kernel
from repro_torch.kernels.flash_attention_bwd import flash_dkdv_kernel, \
    flash_dkdv_plain, flash_dq_kernel, flash_dq_plain

# tests/test_kernels_flash.py's backward shapes
SHAPES = [
    (1, 64, 2, 2, 32),   # MHA
    (2, 64, 4, 2, 64),   # GQA group 2 (dk/dv summed over the group)
    (1, 96, 4, 1, 16),   # MQA, ragged S, small D
]


def _inputs(seed, B, S, H, KVH, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D),
                          (B, S, H, D))]


def _both(arrays, dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(dtype) for a in arrays])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _jax_grad(q, k, v, do):
    def loss(q, k, v):
        o = jref.flash_attention(q, k, v)
        return jnp.sum(o.astype(jnp.float32) * do.astype(jnp.float32))

    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def _autograd(q, k, v, do):
    t = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = ops.flash_attention(*t)
    return torch.autograd.grad(o, t, do)


def _close(got, want, tol):
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(_np(g), _np(w), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,H,KVH,D", SHAPES)
def test_flash_bwd_matches_jax(B, S, H, KVH, D):
    (jq, jk, jv, jdo), (q, k, v, do) = _both(
        _inputs(S + D, B, S, H, KVH, D), torch.float32)
    want_kernels = jops.flash_attention_bwd(jq, jk, jv, jdo, block_q=32,
                                            block_k=32)
    want_grad = _jax_grad(jq, jk, jv, jdo)
    got = ops.flash_attention_bwd(q, k, v, do)
    assert [g.dtype for g in got] == [torch.float32] * 3
    _close(got, want_kernels, 3e-5)
    _close(got, want_grad, 3e-5)
    _close(_autograd(q, k, v, do), want_grad, 3e-5)


def test_flash_bwd_bf16_matches_jax():
    (jq, jk, jv, jdo), (q, k, v, do) = _both(
        _inputs(9, 2, 64, 4, 2, 64), torch.bfloat16)
    want = jops.flash_attention_bwd(jq, jk, jv, jdo, block_q=32, block_k=32)
    got = ops.flash_attention_bwd(q, k, v, do)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3
    _close(got, want, 2e-2)
    _close(_autograd(q, k, v, do), _jax_grad(jq, jk, jv, jdo), 2e-2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_bwd_head_dim_256_matches_jax(dtype, tol):
    """head_dim 256, recurrentgemma's local attention (ragged S, MQA): the
    port's backward (K7 then ``flash_dq_plain``/``flash_dkdv_plain`` on
    the CPU) against JAX's ``ops.flash_attention_bwd`` and, through
    ``FlashAttention``, against ``jax.grad``."""
    B, S, H, KVH, D = 1, 100, 2, 1, 256
    (jq, jk, jv, jdo), (q, k, v, do) = _both(
        _inputs(D + S, B, S, H, KVH, D), dtype)
    want = jops.flash_attention_bwd(jq, jk, jv, jdo, block_q=32, block_k=32)
    got = ops.flash_attention_bwd(q, k, v, do)
    assert [g.dtype for g in got] == [dtype] * 3
    _close(got, want, tol)
    _close(_autograd(q, k, v, do), _jax_grad(jq, jk, jv, jdo), tol)


@pytest.mark.parametrize("B,S,H,KVH,D", [(1, 64, 2, 2, 128),
                                         (2, 64, 4, 2, 32),
                                         (1, 64, 2, 1, 256)])
def test_plain_kernels_match_pallas(B, S, H, KVH, D):
    """The plain K8a/K8b given JAX's (m, linv, delta) against
    ``flash_dq_pallas``/``flash_dkdv_pallas`` on the (B*H, S, D) layout."""
    (jq, jk, jv, jdo), (q, k, v, do) = _both(
        _inputs(B * S + D, B, S, H, KVH, D), torch.float32)

    def heads_first(t, heads):
        return jnp.moveaxis(t, 2, 1).reshape(B * heads, S, D)

    def heads_back(t, heads):
        return np.moveaxis(_np(t).reshape(B, heads, S, D), 1, 2)

    G = H // KVH
    args = (heads_first(jq, H), heads_first(jk, KVH), heads_first(jv, KVH),
            heads_first(jdo, H))
    o, m, l = flash_attention_pallas(*args[:3], group=G, seq_len=S,
                                     block_q=32, block_k=32)
    linv = 1.0 / jnp.maximum(l, 1e-30)
    delta = jnp.sum(args[3] * o, -1)
    kw = dict(group=G, seq_len=S, block_q=32, block_k=32)
    dq_j = flash_dq_pallas(*args, m, linv, delta, **kw)
    dk_j, dv_j = flash_dkdv_pallas(*args, m, linv, delta, **kw)
    stats = [torch.from_numpy(np.array(_np(t)).reshape(B, H, S))
             for t in (m, linv, delta)]
    dq = flash_dq_plain(q, k, v, do, *stats)
    dk, dv = flash_dkdv_plain(q, k, v, do, *stats)
    np.testing.assert_allclose(_np(dq), heads_back(dq_j, H), rtol=3e-5,
                               atol=3e-5)
    np.testing.assert_allclose(_np(dk), heads_back(dk_j, KVH), rtol=3e-5,
                               atol=3e-5)
    np.testing.assert_allclose(_np(dv), heads_back(dv_j, KVH), rtol=3e-5,
                               atol=3e-5)


def test_p_ds_helper_is_the_softmax_backward():
    """``ref.causal_p_ds``: p is the causal softmax and ds = dL/ds of
    L = sum(o * do), checked against autograd of the scores."""
    _, (q, k, v, do) = _both(_inputs(4, 1, 24, 4, 2, 8), torch.float32)
    o, m, l = flash_attention_kernel(q, k, v)
    delta = (do * o).sum(-1).transpose(1, 2)
    p, ds = ref.causal_p_ds(q, k, v, do, m, 1.0 / l, delta)
    s = ref.causal_scores(q, k).requires_grad_(True)
    p_want = torch.softmax(s, dim=-1)
    o_want = torch.einsum("bkgqt,btkd->bqkgd", p_want, v)
    (ds_want,) = torch.autograd.grad(o_want, s, do.reshape(1, 24, 2, 2, 8))
    torch.testing.assert_close(p, p_want.detach(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ds, ds_want, rtol=1e-5, atol=1e-6)
    assert bool((p.tril() == p).all())


def test_wrappers_route_and_refuse():
    """CPU tensors take the plain versions without a launch; K7 itself
    refuses inputs that require a gradient instead of returning a detached
    output; bad stats are refused."""
    _, (q, k, v, do) = _both(_inputs(1, 1, 16, 4, 2, 8), torch.float32)
    o, m, l = flash_attention_kernel(q, k, v)
    stats = (m, 1.0 / l, (do * o).sum(-1).transpose(1, 2).contiguous())
    before = (flash_dq_kernel.launches, flash_dkdv_kernel.launches)
    dq = flash_dq_kernel(q, k, v, do, *stats)
    dk, dv = flash_dkdv_kernel(q, k, v, do, *stats)
    assert (flash_dq_kernel.launches, flash_dkdv_kernel.launches) == before
    torch.testing.assert_close(dq, flash_dq_plain(q, k, v, do, *stats))
    assert dk.shape == dv.shape == k.shape
    with pytest.raises(RuntimeError, match="FlashAttention"):
        flash_attention_kernel(q.clone().requires_grad_(True), k, v)
    with torch.no_grad():  # no gradient recorded: allowed
        flash_attention_kernel(q.clone().requires_grad_(True), k, v)
    with pytest.raises(ValueError, match="delta"):
        flash_dq_kernel(q, k, v, do, m, stats[1], stats[2][..., :-1])
    with pytest.raises(ValueError, match="do must match"):
        flash_dkdv_kernel(q, k, v, do.double(), *stats)
    # meta (the shape dry run) gets dq's and dk's, dv's shapes and no
    # launch; a device that is neither the card, the CPU nor meta raises
    meta = [t.to("meta") for t in (q, k, v, do, *stats)]
    assert flash_dq_kernel(*meta).shape == q.shape
    assert [t.shape for t in flash_dkdv_kernel(*meta)] == [k.shape, v.shape]
    assert (flash_dq_kernel.launches, flash_dkdv_kernel.launches) == before

    class Elsewhere:
        device = torch.device("xla")

    with pytest.raises(ValueError, match="device"):
        flash_dq_kernel(*[Elsewhere()] * 7)


def test_function_saves_nothing_under_inference_mode():
    """Serving loses nothing: under inference mode the Function is K7's
    forward alone, and its output is K7's o."""
    _, (q, k, v, _) = _both(_inputs(2, 1, 40, 4, 2, 16), torch.float32)
    with torch.inference_mode():
        o = FlashAttention.apply(q, k, v)
    assert o.grad_fn is None
    torch.testing.assert_close(o, flash_attention_kernel(q, k, v)[0],
                               rtol=0, atol=0)
    qg = q.clone().requires_grad_(True)
    assert ops.flash_attention(qg, k, v).grad_fn is not None
