"""The roundings of the port's two tensor-core numerics choices, emulated
in torch on the CPU and held against the JAX package.

* K3, K5 and K6 (one Gram, ``csrc/irls_tc.cuh``) take their float32
  Gram's products as three TF32 products: a = (w Xm) rounded to float32,
  each of a and Xm split as x = hi + lo with hi = rna(x) and lo = rna(x -
  hi), rna being ``cvt.rna.tf32.f32`` (round to nearest, ties away from
  zero, to 10 stored mantissa bits), and H = a_hi^T x_hi + a_hi^T x_lo +
  a_lo^T x_hi summed in float32.  Held within 2e-5 max|H|, the kernels'
  tolerance against their plain versions: K5's against the JAX
  ``fused_irls_cv_sim`` H, K3's (the IRLS weights, no folds) against
  ``fused_irls_sim``, K6's (the caller's weights) against the JAX
  package's ``ops.gram_hessian`` in interpret mode.
* K8a in bfloat16 (``csrc/flash_attention_bwd.cu``) computes S and dP in
  float32 from bf16 inputs, dS = P (dP - delta) in float32, and dq = dS K
  with dS as two bf16 terms (hi = bf16(dS), lo = bf16(dS - hi)).  Held
  against JAX's ``flash_dq_pallas`` in interpret mode (float32 dS) within
  5e-3 + 1e-2 |dq|, K7's and K8's bf16 tolerance on the card, on small
  causal GQA shapes, a peaked softmax (q scaled by 4) among them.

Inputs come from a numpy seed.  Run as a script, the file also prints the
emulated dq with one bf16 rounding of dS beside hi + lo at a training-like
shape (B 1, S 2048, H 8, KVH 2, D 128, q scaled by 4), against the port's
plain version: the evidence for the kernel's hi + lo.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.flash_attention_bwd import flash_dq_pallas
from repro.kernels.fused_irls import fused_irls_cv_sim, fused_irls_sim
from repro_torch.kernels.ref import masked_cv_terms, masked_irls_terms

LOG2E = 1.4426950408889634
BF16_TOL = (5e-3, 1e-2)  # (abs, rel), as K7 and K8 on the card


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: add
    half a TF32 unit to the magnitude bits, clear the 13 low bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def gram_3xtf32(Xm: torch.Tensor, w32: torch.Tensor) -> torch.Tensor:
    """(d, d) H of one (configuration, institution) pair as K3, K5 and K6
    form it: Xm (N, d) float32, w32 (N,) float32 weights."""
    a_hi, a_lo = tf32_split(Xm * w32[:, None])
    x_hi, x_lo = tf32_split(Xm)
    return a_lo.T @ x_hi + a_hi.T @ x_lo + a_hi.T @ x_hi


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0**-10  # a TF32 neighbour of 1
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-12, -(1.0 + 2.0**-11),
                      one + 2.0**-11, 3.0e38, 0.0], dtype=torch.float32)
    want = torch.tensor([1.0, one, 1.0, -one, one + 2.0**-10, 3.0e38, 0.0],
                        dtype=torch.float32)
    got = tf32_rna(x)
    assert torch.equal(got[:5], want[:5]) and got[6] == 0.0
    assert float(abs(got[5] - x[5]) / x[5]) <= 2.0**-11
    assert bool(((got.view(torch.int32) & 0x1FFF) == 0).all())


@pytest.mark.parametrize("d", [8, 130, 256])
def test_k5_3xtf32_gram_matches_fused_irls_cv_sim(d):
    rng = np.random.default_rng(17 + d)
    counts = np.array([300, 123, 257], np.int32)
    s_dim, n = len(counts), 300
    X = rng.normal(size=(s_dim, n, d))
    y = (rng.random((s_dim, n)) < 0.4).astype(np.float64)
    fid = rng.integers(0, 3, size=(s_dim, n)).astype(np.int32)
    for s, c in enumerate(counts):
        fid[s, c:] = -1
    betas = 0.3 * rng.normal(size=(3, d)) / np.sqrt(d)
    fold_of = np.array([-1, 0, 2], np.int32)
    args = (betas, X, X.astype(np.float32), y, counts, fid, fold_of)
    want = np.asarray(fused_irls_cv_sim(*(jnp.asarray(a) for a in args))[0])
    t = [torch.as_tensor(a) for a in args]
    w32 = masked_cv_terms(t[0], t[1], t[3], t[4], t[5], t[6])[0].float()
    got = torch.stack([torch.stack([gram_3xtf32(t[2][j], w32[c, j])
                                    for j in range(s_dim)])
                       for c in range(len(fold_of))]).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-5 * scale
    # the split is what keeps float32: one TF32 product misses
    one = torch.stack([torch.stack([
        (tf32_rna(t[2][j] * w32[c, j][:, None]).T @ tf32_rna(t[2][j]))
        for j in range(s_dim)]) for c in range(len(fold_of))]).numpy()
    assert np.abs(one - want).max() > 2e-5 * scale


@pytest.mark.parametrize("d", [8, 130, 256])
def test_k3_3xtf32_gram_matches_fused_irls_sim(d):
    """K3 is K5 with one configuration and no folds: the weights are the
    IRLS weights of every valid row; ragged counts, one past N_max (all
    N_max rows count) and one zero."""
    rng = np.random.default_rng(29 + d)
    counts = np.array([300, 123, 420, 0], np.int32)
    s_dim, n = len(counts), 300
    X = rng.normal(size=(s_dim, n, d))
    y = (rng.random((s_dim, n)) < 0.4).astype(np.float64)
    beta = 0.3 * rng.normal(size=(d,)) / np.sqrt(d)
    args = (beta, X, X.astype(np.float32), y, counts)
    want = np.asarray(fused_irls_sim(*(jnp.asarray(a) for a in args))[0])
    t = [torch.as_tensor(a) for a in args]
    w32 = masked_irls_terms(t[0], t[1], t[3], t[4])[0].float()
    got = torch.stack([gram_3xtf32(t[2][j], w32[j])
                       for j in range(s_dim)]).numpy()
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()
    assert not got[3].any()  # count 0: H is zero


@pytest.mark.parametrize("n", [8, 100, 1000])
@pytest.mark.parametrize("d", [3, 84, 200])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k6_3xtf32_gram_matches_jax_gram_hessian(n, d, dtype):
    """K6's products from X and w cast to float32 once, a = x_i w rounded
    to float32 before the split, at ``tests/test_torch_gram.py``'s
    shapes, against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(n * 1000 + d)
    X = rng.normal(size=(n, d)).astype(dtype)
    w = rng.uniform(0.0, 0.25, size=(n,)).astype(dtype)
    want = np.asarray(jops.gram_hessian(jnp.asarray(X), jnp.asarray(w)))
    got = gram_3xtf32(torch.as_tensor(X).float(),
                      torch.as_tensor(w).float()).numpy()
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()


def emulate_dq(q, k, v, do, m, linv, delta, split=True):
    """dq (B, S, H, D) bf16 as K8a's tensor-core kernel rounds it: q, k,
    v, do bf16 (B, S, H|KVH, D); m, linv, delta (B, H, S) float32."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    G = H // KVH
    f32 = torch.float32
    s = torch.einsum("bqkgd,btkd->bkgqt", q.to(f32).reshape(B, S, KVH, G, D),
                     k.to(f32))
    dp = torch.einsum("bqkgd,btkd->bkgqt",
                      do.to(f32).reshape(B, S, KVH, G, D), v.to(f32))

    def rows(t):
        return t.reshape(B, KVH, G, S)[..., None]

    sl2 = torch.tensor(D**-0.5 * LOG2E, dtype=f32)
    p = torch.exp2(s * sl2 - rows(m) * LOG2E) * rows(linv)
    p = torch.where(torch.ones((S, S), dtype=torch.bool).tril(), p, 0.0)
    ds = p * (dp - rows(delta))
    hi = ds.to(torch.bfloat16).to(f32)
    if split:
        hi = hi + (ds - hi).to(torch.bfloat16).to(f32)
    dq = torch.einsum("bkgqt,btkd->bqkgd", hi, k.to(f32)) * D**-0.5
    return dq.reshape(B, S, H, D).to(torch.bfloat16)


@pytest.mark.parametrize("B,S,H,KVH,D,q_scale", [
    (1, 64, 4, 2, 32, 1.0),
    (2, 96, 4, 1, 64, 1.0),
    (1, 64, 2, 2, 128, 1.0),
    (1, 96, 4, 2, 64, 4.0),   # peaked softmax: dS cancels hardest
    (1, 64, 2, 1, 256, 4.0),
])
def test_k8a_hi_lo_dq_matches_flash_dq_pallas(B, S, H, KVH, D, q_scale):
    rng = np.random.default_rng(S + D + H)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32)
                   for shape in ((B, S, H, D), (B, S, KVH, D),
                                 (B, S, KVH, D), (B, S, H, D)))
    q = q * q_scale
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jnp.bfloat16)
                       for a in (q, k, v, do))

    def heads_first(t, heads):
        return jnp.moveaxis(t, 2, 1).reshape(B * heads, S, D)

    a = (heads_first(jq, H), heads_first(jk, KVH), heads_first(jv, KVH),
         heads_first(jdo, H))
    kw = dict(group=H // KVH, seq_len=S, block_q=32, block_k=32)
    o, m, l = flash_attention_pallas(*a[:3], **kw)
    linv = 1.0 / jnp.maximum(l, 1e-30)
    delta = jnp.sum(a[3].astype(jnp.float32) * o.astype(jnp.float32), -1)
    want = flash_dq_pallas(*a, m, linv, delta, **kw)
    want = np.moveaxis(np.asarray(want.astype(jnp.float32))
                       .reshape(B, H, S, D), 1, 2)
    tq, tk, tv, tdo = (torch.from_numpy(np.array(t.astype(jnp.float32)))
                       .to(torch.bfloat16) for t in (jq, jk, jv, jdo))
    stats = [torch.from_numpy(np.array(t, np.float32)).reshape(B, H, S)
             for t in (m, linv, delta)]
    got = emulate_dq(tq, tk, tv, tdo, *stats).float().numpy()
    atol, rtol = BF16_TOL
    assert np.all(np.abs(got - want) <= atol + rtol * np.abs(want))


if __name__ == "__main__":
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.flash_attention_bwd import flash_dq_plain

    rng = np.random.default_rng(0)
    B, S, H, KVH, D = 1, 2048, 8, 2, 128
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape)
                                    .astype(np.float32))
                   for shape in ((B, S, H, D), (B, S, KVH, D),
                                 (B, S, KVH, D), (B, S, H, D)))
    q, k, v, do = (t.to(torch.bfloat16) for t in (4.0 * q, k, v, do))
    o, m, l = flash_attention_kernel(q, k, v)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, m, 1.0 / torch.clamp(l, min=1e-30), delta)
    want = flash_dq_plain(*args).float()
    for split in (False, True):
        err = (emulate_dq(*args, split=split).float() - want).abs()
        over = err - (BF16_TOL[0] + BF16_TOL[1] * want.abs())
        print(f"dS {'hi + lo' if split else 'one bf16 rounding'}: max err "
              f"{float(err.max()):.6g}, {int((over > 0).sum())} of "
              f"{want.numel()} elements outside 5e-3 + 1e-2 |dq|")
