"""Port vs JAX package: K6, the weighted Gram X^T diag(w) X.

On CPU tensors ``ops.gram_hessian`` runs K6's plain version (the CUDA
kernel's oracle on the card), held against the JAX package's
``ops.gram_hessian`` (the Pallas kernel in interpret mode) and its
``ref.gram_hessian``.  Tolerance rtol = atol = 2e-5, the one
``tests/test_kernels.py`` holds the TPU kernel to: both sides cast to
float32 and accumulate in float32, in different orders.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused_irls import gram_hessian_kernel, \
    gram_hessian_plain


def _case(n, d, dtype):
    rng = np.random.default_rng(n * 1000 + d)
    X = rng.normal(size=(n, d)).astype(dtype)
    w = rng.uniform(0.0, 0.25, size=(n,)).astype(dtype)
    return X, w


@pytest.mark.parametrize("n", [8, 100, 1000])
@pytest.mark.parametrize("d", [3, 84, 200])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gram_plain_matches_jax(n, d, dtype):
    X, w = _case(n, d, dtype)
    got = ops.gram_hessian(torch.as_tensor(X), torch.as_tensor(w))
    assert got.dtype == torch.float32 and tuple(got.shape) == (d, d)
    want = jops.gram_hessian(jnp.asarray(X), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    oracle = jref.gram_hessian(jnp.asarray(X), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=2e-5,
                               atol=2e-5)


def test_gram_casts_once_and_runs_the_plain_version_on_the_cpu():
    """Any float dtype in, float32 H out; the port's ``ref.gram_hessian``
    is the same function; a CPU call launches nothing."""
    X, w = _case(333, 17, np.float64)
    Xt, wt = torch.as_tensor(X), torch.as_tensor(w)
    before = gram_hessian_kernel.launches
    H = ops.gram_hessian(Xt, wt)
    assert gram_hessian_kernel.launches == before
    assert torch.equal(H, ref.gram_hessian(Xt, wt))
    assert torch.equal(H, gram_hessian_plain(Xt.float(), wt.float()))
    Hb = ops.gram_hessian(Xt.to(torch.bfloat16), wt)
    assert Hb.dtype == torch.float32
    np.testing.assert_allclose(
        Hb.numpy(), gram_hessian_plain(Xt.to(torch.bfloat16).float(),
                                       wt).numpy())
    np.testing.assert_allclose(H.numpy(), H.numpy().T, rtol=0, atol=1e-4)


def test_gram_refuses_mismatched_inputs():
    X = torch.zeros((5, 3))
    with pytest.raises(ValueError, match="w \\(N,\\)"):
        ops.gram_hessian(X, torch.zeros(4))
    with pytest.raises(TypeError, match="floating point"):
        ops.gram_hessian(X.long(), torch.zeros(5))
