"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: without a CUDA card every test here skips.  The file
imports neither JAX nor the JAX package, so on a machine with a card and
no JAX it runs on its own:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

Tolerances: K1 and K2 are exact field arithmetic (bit-identical); K3's
float32 Gram differs from the plain version's in summation order
(|dH| <= 2e-5 max|H|), its float64 g and dev to 1e-12 of the sums of
absolute terms.  K5 holds the same H bound, g and the deviances to 1e-10
relative (of the sums of absolute terms), and its held-out counts exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.field import FIELD31, FIELD_WIDE
from repro_torch.kernels.fused_irls import fused_irls_cv_kernel, \
    fused_irls_cv_plain, fused_irls_kernel, fused_irls_plain
from repro_torch.kernels.shamir_poly import encode_share_kernel, \
    encode_share_plain
from repro_torch.kernels.shamir_reconstruct import reconstruct_kernel, \
    reconstruct_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _payload(rows, dtype, field, device):
    rng = np.random.default_rng(rows)
    x = rng.normal(size=(rows, 128)) * 3.0
    cap = field.max_signed / 2**28
    edges = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 0.0, -0.0, cap, -cap,
                      2 * cap, -2 * cap, 1e20, -1e20])
    x.flat[:len(edges)] = edges * 2**-28
    x.flat[len(edges):2 * len(edges)] = edges
    return torch.as_tensor(x, dtype=dtype, device=device)


@pytest.mark.parametrize("field", [FIELD31, FIELD_WIDE],
                         ids=lambda f: f.name)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("t,points", [(2, (1, 2, 3)), (2, (3,)),
                                      (3, (1, 2, 3, 4, 5)), (1, (1, 2))])
def test_k1_kernel_matches_plain(cuda, field, dtype, t, points):
    rows = 40
    x = _payload(rows, dtype, field, cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    coeffs = torch.stack([
        torch.randint(0, p, (t - 1, rows, 128), generator=g, device=cuda)
        for p in field.moduli]).to(torch.int32)
    before = encode_share_kernel.launches
    got = encode_share_kernel(x, coeffs, field.moduli, 28, points)
    torch.cuda.synchronize()
    assert encode_share_kernel.launches == before + 1
    want = encode_share_plain(x, coeffs, field.moduli, 28, points)
    assert torch.equal(got, want)


@pytest.mark.parametrize("field", [FIELD31, FIELD_WIDE],
                         ids=lambda f: f.name)
@pytest.mark.parametrize("points", [(1, 2), (1, 3), (2, 3), (1, 2, 3),
                                    (2, 4, 5)])
@pytest.mark.parametrize("decode", [True, False])
def test_k2_kernel_matches_plain(cuda, field, points, decode):
    rows = 24
    g = torch.Generator(device=cuda).manual_seed(1)
    shares = torch.stack([
        torch.stack([torch.randint(0, p, (rows, 128), generator=g,
                                   device=cuda) for p in field.moduli])
        for _ in points]).to(torch.int32)
    frac_bits = 28 if decode else None
    got = reconstruct_kernel(shares, points, field.moduli, frac_bits)
    torch.cuda.synchronize()
    want = reconstruct_plain(shares, points, field.moduli, frac_bits)
    assert torch.equal(got, want)


@pytest.mark.parametrize("counts,n,d", [
    ((7, 530, 64), 530, 12),
    ((1000, 37, 2500), 2500, 130),
    ((26250, 23750), 26250, 128),
    ((0, 300), 300, 256),
    ((700, 90), 530, 12),  # a count past N_max reads no row beyond it
])
def test_k3_kernel_matches_plain(cuda, counts, n, d):
    gen = torch.Generator(device=cuda).manual_seed(sum(counts) + d)
    s_dim = len(counts)
    X = torch.randn((s_dim, n, d), generator=gen, device=cuda,
                    dtype=torch.float64)
    y = (torch.rand((s_dim, n), generator=gen, device=cuda,
                    dtype=torch.float64) < 0.4).to(torch.float64)
    beta = 0.05 * torch.randn((d,), generator=gen, device=cuda,
                              dtype=torch.float64)
    cnt = torch.tensor(counts, dtype=torch.int32, device=cuda)
    Xm = X.to(torch.float32)
    H, g, dev = fused_irls_kernel(beta, X, Xm, y, cnt)
    torch.cuda.synchronize()
    Hp, gp, devp = fused_irls_plain(beta, X, Xm, y, cnt)
    assert float((H - Hp).abs().max()) <= 2e-5 * float(Hp.abs().max())
    mask = (torch.arange(n, device=cuda)[None, :] < cnt[:, None]).double()
    z = torch.einsum("snd,d->sn", X, beta)
    p = torch.sigmoid(z)
    g_scale = torch.einsum("snd,sn->sd", X.abs(), ((y - p) * mask).abs())
    assert bool(((g - gp).abs() <= 1e-12 * g_scale + 1e-300).all())
    dev_terms = ((y * z - torch.logaddexp(torch.zeros_like(z), z)) * mask)
    dev_scale = dev_terms.abs().sum(dim=1)
    assert bool(((dev - devp).abs() <= 1e-12 * dev_scale + 1e-300).all())


@pytest.mark.parametrize("counts,n,d,fold_of", [
    ((300, 123, 257), 300, 8, (-1, 0, 2)),
    ((7, 530, 64), 530, 12, (0,)),
    ((1000, 37, 2500), 2500, 130, (-1, 0, 1, 2, 3)),
    ((26250, 23750), 26250, 128, (0, 1, 2, 3, 4)),
    ((0, 300), 300, 256, (-1, 1)),
    ((700, 90), 530, 12, (-1, 0, 1)),  # a count past N_max
])
def test_k5_kernel_matches_plain(cuda, counts, n, d, fold_of):
    gen = torch.Generator(device=cuda).manual_seed(sum(counts) + d)
    s_dim, c_dim = len(counts), len(fold_of)
    X = torch.randn((s_dim, n, d), generator=gen, device=cuda,
                    dtype=torch.float64)
    y = (torch.rand((s_dim, n), generator=gen, device=cuda,
                    dtype=torch.float64) < 0.4).to(torch.float64)
    betas = 0.05 * torch.randn((c_dim, d), generator=gen, device=cuda,
                               dtype=torch.float64)
    cnt = torch.tensor(counts, dtype=torch.int32, device=cuda)
    fids = torch.randint(0, 5, (s_dim, n), generator=gen, device=cuda,
                         dtype=torch.int32)
    rows = torch.arange(n, device=cuda)[None, :]
    fids = torch.where(rows < cnt[:, None], fids, -1)  # padding: fold -1
    fold = torch.tensor(fold_of, dtype=torch.int32, device=cuda)
    args = (betas, X, X.to(torch.float32), y, cnt, fids, fold)
    before = fused_irls_cv_kernel.launches
    got = fused_irls_cv_kernel(*args)
    torch.cuda.synchronize()
    assert fused_irls_cv_kernel.launches == before + 1
    want = fused_irls_cv_plain(*args)
    H, Hp = got[0], want[0]
    assert float((H - Hp).abs().max()) <= 2e-5 * float(Hp.abs().max())
    z = torch.einsum("snd,cd->csn", X, betas)
    p = torch.sigmoid(z)
    valid = (rows < cnt[:, None])[None]
    g_scale = torch.einsum("snd,csn->csd", X.abs(),
                           ((y[None] - p) * valid).abs())
    assert bool(((got[1] - want[1]).abs() <= 1e-10 * g_scale + 1e-300)
                .all())
    ll = (y[None] * z - torch.logaddexp(torch.zeros_like(z), z)) * valid
    dev_scale = 2.0 * ll.abs().sum(dim=2)
    for k in (2, 3):
        assert bool(((got[k] - want[k]).abs() <= 1e-10 * dev_scale
                     + 1e-300).all())
    for k in (4, 5):
        assert torch.equal(got[k], want[k])
