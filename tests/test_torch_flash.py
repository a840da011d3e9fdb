"""K7 (causal GQA flash-attention forward) on the port against the JAX
package, on the CPU.

The same numpy inputs (drawn from a seed) go through the JAX package's
``ops.flash_attention`` (its Pallas kernel in interpret mode),
``ref.flash_attention`` and ``flash_attention_pallas`` itself, and
through the port's ``ops.flash_attention``, whose K7 wrapper runs the
kernel's plain PyTorch version for CPU tensors.  Tolerances are the JAX
package's own (``tests/test_kernels_flash.py``): 2e-5 for float32, 5e-5
with score outliers over many key blocks, 2e-2 for bfloat16; m and l
within 1e-5 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (
    flash_attention_kernel,
    flash_attention_plain,
)


def _qkv(seed, B, S, H, KVH, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, KVH, D)).astype(np.float32),
            rng.standard_normal((B, S, KVH, D)).astype(np.float32))


def _both(arrays, dtype):
    """The same values as JAX arrays and torch tensors of ``dtype``
    (float32 -> bfloat16 rounds to nearest even in both)."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(dtype) for a in arrays])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize(
    "B,S,H,KVH,D",
    [
        (1, 64, 4, 4, 32),    # MHA
        (2, 128, 4, 2, 64),   # GQA group 2
        (1, 96, 8, 1, 128),   # MQA, ragged S
        (1, 200, 2, 2, 16),   # very ragged S, small D
    ],
)
def test_flash_matches_jax(B, S, H, KVH, D):
    (jq, jk, jv), (q, k, v) = _both(_qkv(S + D, B, S, H, KVH, D),
                                    torch.float32)
    out = ops.flash_attention(q, k, v)
    assert out.shape == (B, S, H, D) and out.dtype == torch.float32
    want = jops.flash_attention(jq, jk, jv, block_q=64, block_k=64)
    np.testing.assert_allclose(_np(out), _np(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(out), _np(jref.flash_attention(jq, jk,
                                                                   jv)),
                               rtol=2e-5, atol=2e-5)


def test_flash_bf16_matches_jax():
    (jq, jk, jv), (q, k, v) = _both(_qkv(7, 2, 64, 4, 2, 64),
                                    torch.bfloat16)
    out = ops.flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16
    want = jops.flash_attention(jq, jk, jv, block_q=32, block_k=32)
    np.testing.assert_allclose(_np(out), _np(want), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(out), _np(jref.flash_attention(jq, jk,
                                                                   jv)),
                               rtol=2e-2, atol=2e-2)


def test_flash_multiblock_outliers_match_jax():
    """Score outliers over many key blocks: the running (m, l) rescale."""
    qn, kn, vn = _qkv(3, 1, 256, 2, 2, 32)
    qn[:, 17] *= 30.0
    (jq, jk, jv), (q, k, v) = _both((qn, kn, vn), torch.float32)
    out = ops.flash_attention(q, k, v)
    want = jops.flash_attention(jq, jk, jv, block_q=32, block_k=32)
    np.testing.assert_allclose(_np(out), _np(want), rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(_np(out), _np(jref.flash_attention(jq, jk,
                                                                   jv)),
                               rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("B,S,H,KVH", [(1, 64, 2, 2), (2, 128, 4, 2)])
def test_flash_stats_match_pallas(B, S, H, KVH):
    """(o, m, l) against ``flash_attention_pallas`` called directly (D =
    128, S a block multiple, so the JAX wrapper's padding is not in play);
    the port's m, l (B, H, S) are the kernel's (B*H, S)."""
    D = 128
    (jq, jk, jv), (q, k, v) = _both(_qkv(B * S, B, S, H, KVH, D),
                                    torch.float32)

    def heads_first(t, heads):
        return jnp.moveaxis(t, 2, 1).reshape(B * heads, S, D)

    o_j, m_j, l_j = flash_attention_pallas(
        heads_first(jq, H), heads_first(jk, KVH), heads_first(jv, KVH),
        group=H // KVH, seq_len=S, block_q=32, block_k=32)
    o, m, l = flash_attention_kernel(q, k, v)
    assert m.shape == l.shape == (B, H, S)
    assert m.dtype == l.dtype == torch.float32
    np.testing.assert_allclose(
        _np(o), np.moveaxis(_np(o_j).reshape(B, H, S, D), 1, 2),
        rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(m).reshape(B * H, S), _np(m_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(l).reshape(B * H, S), _np(l_j),
                               rtol=1e-5)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_head_dim_256_matches_jax(dtype, tol):
    """head_dim 256, recurrentgemma's local attention (ragged S, MQA):
    the port's K7 against JAX's ``ops.flash_attention``, whose wrapper
    pads D to a multiple of 128 (here none) and S to the block."""
    B, S, H, KVH, D = 1, 100, 2, 1, 256
    (jq, jk, jv), (q, k, v) = _both(_qkv(D + S, B, S, H, KVH, D), dtype)
    out = ops.flash_attention(q, k, v)
    assert out.shape == (B, S, H, D) and out.dtype == dtype
    want = jops.flash_attention(jq, jk, jv, block_q=32, block_k=32)
    np.testing.assert_allclose(_np(out), _np(want), rtol=tol, atol=tol)


def test_flash_stats_head_dim_256_match_pallas():
    """(o, m, l) at head_dim 256 against ``flash_attention_pallas`` called
    directly (S a block multiple, D 256 needs no padding)."""
    B, S, H, KVH, D = 1, 96, 2, 1, 256
    (jq, jk, jv), (q, k, v) = _both(_qkv(S + 1, B, S, H, KVH, D),
                                    torch.float32)

    def heads_first(t, heads):
        return jnp.moveaxis(t, 2, 1).reshape(B * heads, S, D)

    o_j, m_j, l_j = flash_attention_pallas(
        heads_first(jq, H), heads_first(jk, KVH), heads_first(jv, KVH),
        group=H // KVH, seq_len=S, block_q=32, block_k=32)
    o, m, l = flash_attention_kernel(q, k, v)
    np.testing.assert_allclose(
        _np(o), np.moveaxis(_np(o_j).reshape(B, H, S, D), 1, 2),
        rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(m).reshape(B * H, S), _np(m_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(l).reshape(B * H, S), _np(l_j),
                               rtol=1e-5)


def test_ref_matches_jax_ref():
    (jq, jk, jv), (q, k, v) = _both(_qkv(11, 2, 40, 6, 3, 24),
                                    torch.float32)
    np.testing.assert_allclose(_np(ref.flash_attention(q, k, v)),
                               _np(jref.flash_attention(jq, jk, jv)),
                               rtol=2e-6, atol=2e-6)


def test_plain_stats_normalize_the_softmax():
    """m is each row's largest allowed score and l its softmax
    denominator: recomputed from the scores directly."""
    _, (q, k, v) = _both(_qkv(5, 1, 50, 4, 2, 16), torch.float32)
    o, m, l = flash_attention_plain(q, k, v)
    s = torch.einsum("bqhd,bthd->bhqt", q * 16**-0.5,
                     k.repeat_interleave(2, dim=2))
    s = torch.where(torch.ones(50, 50, dtype=torch.bool).tril(), s, -1e30)
    torch.testing.assert_close(m, s.amax(-1), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(l, torch.exp(s - s.amax(-1, keepdim=True))
                               .sum(-1), rtol=1e-5, atol=1e-5)
    assert bool((l >= 1.0).all())


def test_wrapper_routes_and_rejects():
    """CPU tensors take the plain version without a launch; bad shapes,
    dtypes and devices are refused before any kernel could see them."""
    _, (q, k, v) = _both(_qkv(1, 1, 8, 4, 2, 8), torch.float32)
    before = flash_attention_kernel.launches
    flash_attention_kernel(q, k, v)
    assert flash_attention_kernel.launches == before
    with pytest.raises(ValueError, match="KVH"):
        flash_attention_kernel(q, k[:, :, :1].expand(1, 8, 3, 8)
                               .contiguous(), v)
    with pytest.raises(TypeError):
        flash_attention_kernel(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        flash_attention_kernel(q, k.bfloat16(), v)
    # meta (the shape dry run) gets K7's output shapes and no launch; a
    # device that is neither the card, the CPU nor meta raises
    o, m, l = flash_attention_kernel(q.to("meta"), k.to("meta"),
                                     v.to("meta"))
    assert o.device.type == "meta" and o.shape == q.shape
    assert m.shape == l.shape == (q.shape[0], q.shape[2], q.shape[1])
    assert flash_attention_kernel.launches == before

    class Elsewhere:
        device, requires_grad = torch.device("xla"), False

    with pytest.raises(ValueError, match="device"):
        flash_attention_kernel(Elsewhere(), Elsewhere(), Elsewhere())
