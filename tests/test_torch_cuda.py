"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: without a CUDA card every test here skips.  The file
imports neither JAX nor the JAX package, so on a machine with a card and
no JAX it runs on its own:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

Tolerances: K1 and K2 are exact field arithmetic (bit-identical), held at
the fit's and the λ path's row counts, on views that start off 16-byte
alignment (the kernels' plain-load path), with t up to 33, up to 40
points and k up to 40 (past the 16 they once capped at, and past what a
block stages in shared memory: 12,300 points, 3,073 shares) and every
share at p - 1 (the largest unreduced Lagrange sums K2 forms); K3's
float32 Gram differs from the plain version's in summation order
(|dH| <= 2e-5 max|H|), its float64 g and dev to 1e-12 of the sums of
absolute terms.  K3 and K6 run K5's kernels (three TF32 products on the
tensor cores, fixed-order sums) and are deterministic as K5 is.  K5 holds the same H bound, g and the deviances to 1e-10
relative (of the sums of absolute terms), and its held-out counts exactly.
K4 is exact field arithmetic (bit-identical, also on views off 16-byte
alignment and rows of odd length, and under ``secure_add``); K6's float32
Gram holds |dH| <= 2e-5 max|H| against the plain version (summation
order).  K7's
output holds 2e-5 absolute and relative in float32, the JAX package's
flash tolerance, and 5e-3 absolute + 1e-2 relative in bfloat16 (set from
the measured error, under one bf16 unit in the last place of |o| < 2; the
CPU parity tests keep the JAX package's 2e-2); its m and l 1e-5 relative
(m also 1e-6 absolute, for a row whose largest score is near zero).
K5 takes its Gram's products as three TF32 products on the tensor cores
and is deterministic: two calls give bit-identical outputs.  K7, K8a and
K8b run bfloat16 on the tensor cores and float32 on the CUDA cores; each
takes any head_dim up to 256, and the cases cover both instantiations, D
256, D padded to the tensor-core kernels' 32 and D not a multiple of 8
(plain loads in place of cp.async), and a peaked softmax (q scaled by 4),
where dq = sum_j ds_ij k_j cancels hardest.
K8a/K8b hold 2e-5 of the larger of max|plain output| and max|do| in
float32 (a one-token row's gradient is pure cancellation, so its own
magnitude is no scale) and 5e-3 absolute + 1e-2 relative in bfloat16, as
K7.  Gradients and training steps on the card hold 1e-4 max|g| per leaf
of the same call on the CPU (float32, summation order).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core.collective import SecureCollective, _protect_flat
from repro_torch.core.field import FIELD31, FIELD_WIDE, fadd, fmul, \
    random_elements
from repro_torch.core.secure_agg import secure_add, secure_scale_by_public
from repro_torch.core.shamir import ShamirScheme
from repro_torch.kernels import flash_attention as k7_mod
from repro_torch.kernels import fused_irls as k3_mod
from repro_torch.kernels import ops
from repro_torch.kernels import shamir_poly as k1_mod
from repro_torch.kernels import shamir_reconstruct as k2_mod
from repro_torch.kernels import flash_attention_bwd as k8_mod
from repro_torch.kernels.flash_attention import flash_attention_kernel, \
    flash_attention_plain
from repro_torch.kernels.flash_attention_bwd import flash_dkdv_kernel, \
    flash_dkdv_plain, flash_dq_kernel, flash_dq_plain
from repro_torch.kernels.fused_irls import fused_irls_cv_kernel, \
    fused_irls_cv_plain, fused_irls_kernel, fused_irls_plain, \
    gram_hessian_kernel, gram_hessian_plain
from repro_torch.kernels.shamir_poly import encode_share_kernel, \
    encode_share_plain, share_kernel, share_plain
from repro_torch.kernels.shamir_reconstruct import reconstruct_kernel, \
    reconstruct_plain
from repro_torch.models import transformer as T

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


def _offset_view(t, offset):
    """``t``'s values in a contiguous view that starts ``offset`` elements
    into its storage (an offset that is not a multiple of four elements
    leaves the data pointer off 16-byte alignment)."""
    if not offset:
        return t
    base = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = base[offset:].view(t.shape)
    view.copy_(t)
    assert view.storage_offset() == offset and view.is_contiguous()
    return view


def _coeffs(field, t, rows, g, device):
    return torch.stack([
        torch.randint(0, p, (t - 1, rows, 128), generator=g, device=device)
        for p in field.moduli]).to(torch.int32)


# rows: a small buffer, the fit's payload (S 8 x 136 rows) and the lambda
# path's (5 configurations x 8 x 136); offset: the payload and the
# coefficients as views 1 or 3 elements into their storage
@pytest.mark.parametrize("field", [FIELD31, FIELD_WIDE],
                         ids=lambda f: f.name)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("t,points", [(2, (1, 2, 3)), (2, (3,)),
                                      (3, (1, 2, 3, 4, 5)), (1, (1, 2)),
                                      (16, tuple(range(1, 17))),
                                      (2, tuple(range(1, 18))),
                                      (17, tuple(range(1, 21))),
                                      (33, tuple(range(1, 41)))])
@pytest.mark.parametrize("rows,offset", [(40, 0), (1088, 0), (5440, 0),
                                         (40, 1), (40, 3)])
def test_k1_kernel_matches_plain(cuda, field, dtype, t, points, rows,
                                 offset):
    x = _offset_view(_payload(rows, dtype, field, cuda), offset)
    g = torch.Generator(device=cuda).manual_seed(0)
    coeffs = _offset_view(_coeffs(field, t, rows, g, cuda), offset)
    before = encode_share_kernel.launches
    got = encode_share_kernel(x, coeffs, field.moduli, 28, points)
    torch.cuda.synchronize()
    assert encode_share_kernel.launches == before + 1
    want = encode_share_plain(x, coeffs, field.moduli, 28, points)
    assert torch.equal(got, want)


def test_k1_reads_points_past_shared_memory_from_the_table(cuda):
    """12,300 points (more than the 12,288 a block stages in shared
    memory): the kernel reads them from the device table, bit-identical to
    the plain version."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = _payload(8, torch.float64, FIELD_WIDE, cuda)
    coeffs = _coeffs(FIELD_WIDE, 2, 8, g, cuda)
    points = tuple(range(1, 12301))
    got = encode_share_kernel(x, coeffs, FIELD_WIDE.moduli, 28, points)
    assert torch.equal(got, encode_share_plain(x, coeffs, FIELD_WIDE.moduli,
                                               28, points))


def _k2_shares(field, k, rows, g, device, fill=None):
    return torch.stack([
        torch.stack([torch.full((rows, 128), p - 1, device=device)
                     if fill == "p-1" else
                     torch.randint(0, p, (rows, 128), generator=g,
                                   device=device) for p in field.moduli])
        for _ in range(k)]).to(torch.int32)


# fill "p-1": every share at p - 1 with k = 16, the largest unreduced
# Lagrange sum the kernel forms (four terms and a reduced sum in a uint64)
@pytest.mark.parametrize("field", [FIELD31, FIELD_WIDE],
                         ids=lambda f: f.name)
@pytest.mark.parametrize("points,fill", [
    ((1, 2), None), ((1, 3), None), ((2, 3), None), ((1, 2, 3), None),
    ((2, 4, 5), None), (tuple(range(1, 17)), None),
    (tuple(range(1, 17)), "p-1"), (tuple(range(1, 18)), None),
    (tuple(range(1, 41)), None), (tuple(range(1, 41)), "p-1")])
@pytest.mark.parametrize("decode", [True, False])
@pytest.mark.parametrize("rows,offset", [(24, 0), (1088, 0), (5440, 0),
                                         (24, 1), (24, 3)])
def test_k2_kernel_matches_plain(cuda, field, points, fill, decode, rows,
                                 offset):
    g = torch.Generator(device=cuda).manual_seed(1)
    shares = _offset_view(_k2_shares(field, len(points), rows, g, cuda,
                                     fill), offset)
    frac_bits = 28 if decode else None
    got = reconstruct_kernel(shares, points, field.moduli, frac_bits)
    torch.cuda.synchronize()
    want = reconstruct_plain(shares, points, field.moduli, frac_bits)
    assert torch.equal(got, want)


@pytest.mark.parametrize("decode", [True, False])
def test_k2_reads_weights_past_shared_memory_from_the_table(cuda, decode):
    """k = 3,073 over the CRT pair: 6,146 Lagrange weights, more than the
    6,144 a block stages in shared memory, so the kernel reads them from
    the device table, bit-identical to the plain version."""
    g = torch.Generator(device=cuda).manual_seed(4)
    points = tuple(range(1, 3074))
    shares = _k2_shares(FIELD_WIDE, len(points), 8, g, cuda)
    frac_bits = 28 if decode else None
    got = reconstruct_kernel(shares, points, FIELD_WIDE.moduli, frac_bits)
    assert torch.equal(got, reconstruct_plain(shares, points,
                                              FIELD_WIDE.moduli, frac_bits))


@pytest.mark.parametrize("field", [FIELD31, FIELD_WIDE],
                         ids=lambda f: f.name)
@pytest.mark.parametrize("t", [2, 3])
def test_protect_coefficient_draw_matches_random_elements(cuda, field, t,
                                                          monkeypatch):
    """On the card, ``_protect_flat`` draws K1's coefficients with
    ``random_elements`` straight into int32: the values its int64 draw
    gives from the same generator state, cast to int32, and the generator
    ends in the same state."""
    seen = {}

    def spy(buf, coeffs, *args, **kw):
        seen["coeffs"] = coeffs
        return "shares"

    monkeypatch.setattr(ops, "shamir_protect_flat", spy)
    scheme = ShamirScheme(field=field, threshold=t, num_shares=t + 1)
    gen, ref_gen = (torch.Generator(device=cuda).manual_seed(11)
                    for _ in range(2))
    rows = 1088
    _protect_flat(gen, torch.zeros((rows, 128), device=cuda), scheme, 28,
                  rows)
    want = random_elements(ref_gen, (t - 1, rows, 128), field)
    assert seen["coeffs"].dtype == torch.int32
    assert torch.equal(seen["coeffs"], want.to(torch.int32))
    assert torch.equal(
        torch.randint(0, 2**31 - 1, (64,), generator=gen, device=cuda),
        torch.randint(0, 2**31 - 1, (64,), generator=ref_gen, device=cuda))


def test_k1_and_k2_two_calls_are_bit_identical(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = _payload(1088, torch.float64, FIELD_WIDE, cuda)
    coeffs = _coeffs(FIELD_WIDE, 2, 1088, g, cuda)
    a = encode_share_kernel(x, coeffs, FIELD_WIDE.moduli, 28, (1, 2, 3))
    b = encode_share_kernel(x, coeffs, FIELD_WIDE.moduli, 28, (1, 2, 3))
    assert torch.equal(a, b)
    shares = a[:2, :, :136].contiguous()
    for fb in (28, None):
        assert torch.equal(
            reconstruct_kernel(shares, (1, 2), FIELD_WIDE.moduli, fb),
            reconstruct_kernel(shares, (1, 2), FIELD_WIDE.moduli, fb))


def test_k1_and_k2_cuda_tensors_never_reach_the_plain_versions(
        cuda, monkeypatch):
    def refuse(*args):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(k1_mod, "encode_share_plain", refuse)
    monkeypatch.setattr(k2_mod, "reconstruct_plain", refuse)
    rng = np.random.default_rng(3)
    tree = {"hessian": rng.normal(size=(4, 9, 9)) * 30.0,
            "gradient": rng.normal(size=(4, 9)) * 5.0}
    agg = SecureCollective(backend="kernel")
    launches = (encode_share_kernel.launches, reconstruct_kernel.launches)
    got = agg.secure_round_batched(
        torch.Generator(device=cuda).manual_seed(5),
        {k: torch.as_tensor(v, device=cuda) for k, v in tree.items()})
    torch.cuda.synchronize()
    assert (encode_share_kernel.launches, reconstruct_kernel.launches) == \
        (launches[0] + 1, launches[1] + 1)
    for k, v in tree.items():
        assert float((got[k].cpu() - torch.as_tensor(v).sum(0)).abs().max()) \
            <= 5 / 2**28
    with pytest.raises(AssertionError, match="plain version"):
        agg.secure_round_batched(
            torch.Generator().manual_seed(5),
            {k: torch.as_tensor(v) for k, v in tree.items()})


@pytest.mark.parametrize("counts,n,d", [
    ((7, 530, 64), 530, 12),
    ((1000, 37, 2500), 2500, 130),
    ((26250, 23750), 26250, 128),
    ((0, 300), 300, 256),
    ((700, 90), 530, 12),  # a count past N_max reads no row beyond it
    ((40, 3, 17), 40, 1),  # d 1
    ((600, 411), 600, 1024),  # d 1024, the largest K3 takes
    ((3000, 2811, 2950), 3000, 28),  # HIGGS's width: the narrow Gram
    ((2000, 1900), 2000, 500),  # PASCAL alpha's: the wide Gram, 4 ranges
    # each side of the Gram's boundaries: 32 | 33 (narrow | wide), 64 | 65
    # (a wide block's second warpgroup idle | at work), 128 | 129 (one |
    # two 128-column ranges)
    ((530, 499), 530, 32),
    ((530, 499), 530, 33),
    ((530, 499), 530, 64),
    ((530, 499), 530, 65),
    ((530, 499), 530, 129),
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
    before = fused_irls_kernel.launches
    H, g, dev = fused_irls_kernel(beta, X, Xm, y, cnt)
    torch.cuda.synchronize()
    assert fused_irls_kernel.launches == before + 1
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
    ((40, 3, 17), 40, 1, (-1, 0, 1)),  # d 1
    ((600, 411), 600, 1024, (-1, 2)),  # d 1024, the largest K5 takes
    # the λ path's 40 pairs: 5 folds x 8 institutions, ragged
    ((2500, 2375, 2625, 2400, 2600, 2450, 2550, 2500), 2625, 128,
     (0, 1, 2, 3, 4)),
    # 8 λs x 5 folds x 8 institutions: few, long slices a pair
    ((6000, 5700, 6300, 5760, 6240, 5880, 6120, 6000), 6300, 128,
     (0, 1, 2, 3, 4) * 8),
    # the λ path at PASCAL alpha's width: 5 folds, the wide Gram
    ((2000, 1900, 2100), 2100, 500, (0, 1, 2, 3, 4)),
    ((3000, 2811), 3000, 28, (0, 1, 2, 3, 4)),  # HIGGS's: the narrow Gram
    # each side of the Gram's regime boundaries, as K3's
    ((530, 499), 530, 32, (-1, 0, 3)),
    ((530, 499), 530, 33, (-1, 0, 3)),
    ((530, 499), 530, 64, (-1, 0, 3)),
    ((530, 499), 530, 65, (-1, 0, 3)),
    ((530, 499), 530, 129, (-1, 0, 3)),
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


@pytest.mark.parametrize("d", [128, 130, 28, 64, 500])
def test_k5_two_calls_are_bit_identical(cuda, d):
    """No float atomics: the slices' partials are summed in slice order,
    so the same inputs give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    counts = torch.tensor([3000, 2811, 2950], dtype=torch.int32, device=cuda)
    X = torch.randn((3, 3000, d), generator=gen, device=cuda,
                    dtype=torch.float64)
    y = (torch.rand((3, 3000), generator=gen, device=cuda) < 0.5).double()
    betas = 0.05 * torch.randn((5, d), generator=gen, device=cuda,
                               dtype=torch.float64)
    fids = torch.randint(0, 5, (3, 3000), generator=gen, device=cuda,
                         dtype=torch.int32)
    fold = torch.arange(5, dtype=torch.int32, device=cuda)
    args = (betas, X, X.float(), y, counts, fids, fold)
    first = fused_irls_cv_kernel(*args)
    second = fused_irls_cv_kernel(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# n: one element, a ragged tail, whole groups, odd rows (every other row
# of a tensor off 16-byte alignment) up to the leaf-wise phase's size;
# offset: the secret and the coefficients as views 1 or 3 elements into
# their storage
@pytest.mark.parametrize("field", [FIELD31, FIELD_WIDE],
                         ids=lambda f: f.name)
@pytest.mark.parametrize("t,w", [(1, 2), (2, 3), (3, 5), (5, 9), (16, 16),
                                 (2, 17), (17, 20), (33, 40)])
@pytest.mark.parametrize("n", [1, 100, 4096, 100_003, 1_000_003])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_k4_kernel_matches_plain(cuda, field, t, w, n, offset):
    g = torch.Generator(device=cuda).manual_seed(n + t)
    draw = lambda shape: torch.stack([  # noqa: E731
        torch.randint(0, p, shape, generator=g, device=cuda)
        for p in field.moduli])
    secret, coeffs = draw((n,)), draw((t - 1, n))
    secret[:, 0] = 0
    secret[:, -1] = torch.tensor(field.moduli, device=cuda) - 1
    secret, coeffs = _offset_view(secret, offset), _offset_view(coeffs, offset)
    before = share_kernel.launches
    got = share_kernel(secret, coeffs, field.moduli, w)
    torch.cuda.synchronize()
    assert share_kernel.launches == before + 1
    assert torch.equal(got, share_plain(secret, coeffs, field.moduli, w))


@pytest.mark.parametrize("field", [FIELD31, FIELD_WIDE],
                         ids=lambda f: f.name)
def test_secure_add_of_k4_shares_reveals_the_sum_through_k2(cuda, field):
    """Algorithm 2 on the card: two K4 share stacks added share-wise with
    ``secure_add`` reveal, from every 2-subset through K2's residues mode,
    the field sum of the two secrets; the public scaling by 3 reveals
    three times it."""
    g = torch.Generator(device=cuda).manual_seed(7)
    sch = ShamirScheme(2, 3, field, backend="kernel")
    a = random_elements(g, (100_003,), field)
    b = random_elements(g, (100_003,), field)
    before = (share_kernel.launches, reconstruct_kernel.launches)
    total = secure_add(sch.share(g, a), sch.share(g, b), field,
                       residue_axis=1)
    three = torch.full((1, field.num_residues, 1), 3, dtype=torch.int64,
                       device=cuda)
    tripled = secure_scale_by_public(total, three, field, residue_axis=1)
    want = fadd(a, b, field)
    for pts in ((1, 2), (1, 3), (2, 3)):
        sel = [p - 1 for p in pts]
        assert torch.equal(sch.reconstruct(total[sel], list(pts)), want)
        assert torch.equal(sch.reconstruct(tripled[sel], list(pts)),
                           fmul(want, 3, field))
    torch.cuda.synchronize()
    assert (share_kernel.launches, reconstruct_kernel.launches) == \
        (before[0] + 2, before[1] + 6 * field.num_residues)


@pytest.mark.parametrize("n,d,dtype", [
    (1, 3, torch.float32),
    (1000, 12, torch.float64),
    (2500, 130, torch.float32),
    (25_000, 128, torch.float32),
    (4097, 256, torch.bfloat16),
    (0, 8, torch.float32),
    (3000, 1024, torch.float32),  # d 1024, the largest K6 takes
    (30_000, 28, torch.float32),   # the narrow Gram at HIGGS's width
    (5000, 500, torch.float32),    # the wide Gram at PASCAL alpha's
    # each side of the Gram's regime boundaries, as K3's
    (4097, 32, torch.float32),
    (4097, 33, torch.float32),
    (4097, 64, torch.float32),
    (4097, 65, torch.float32),
    (4097, 129, torch.float32),
])
def test_k6_kernel_matches_plain(cuda, n, d, dtype):
    gen = torch.Generator(device=cuda).manual_seed(n + d)
    X = torch.randn((n, d), generator=gen, device=cuda).to(dtype)
    w = torch.rand((n,), generator=gen, device=cuda, dtype=torch.float64)
    before = gram_hessian_kernel.launches
    H = gram_hessian_kernel(X, w)
    torch.cuda.synchronize()
    assert gram_hessian_kernel.launches == before + 1
    Hp = gram_hessian_plain(X, w)
    assert H.dtype == torch.float32 and tuple(H.shape) == (d, d)
    assert float((H - Hp).abs().max()) <= 2e-5 * float(Hp.abs().max())


@pytest.mark.parametrize("d", [128, 130, 28, 64, 500])
def test_k3_and_k6_two_calls_are_bit_identical(cuda, d):
    """K3 and K6 run K5's kernels: fixed-order sums, no float atomics, so
    the same inputs give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(d + 3)
    counts = torch.tensor([26250, 23750, 3000], dtype=torch.int32,
                          device=cuda)
    X = torch.randn((3, 26250, d), generator=gen, device=cuda,
                    dtype=torch.float64)
    y = (torch.rand((3, 26250), generator=gen, device=cuda) < 0.5).double()
    beta = 0.05 * torch.randn((d,), generator=gen, device=cuda,
                              dtype=torch.float64)
    args = (beta, X, X.float(), y, counts)
    for a, b in zip(fused_irls_kernel(*args), fused_irls_kernel(*args)):
        assert torch.equal(a, b)
    w = torch.rand((26250,), generator=gen, device=cuda)
    assert torch.equal(gram_hessian_kernel(X[0], w),
                       gram_hessian_kernel(X[0], w))


def test_k3_and_k6_cuda_tensors_never_reach_the_plain_versions(
        cuda, monkeypatch):
    def refuse(*args):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(k3_mod, "fused_irls_plain", refuse)
    monkeypatch.setattr(k3_mod, "gram_hessian_plain", refuse)
    X = torch.randn((2, 300, 12), device=cuda, dtype=torch.float64)
    y = (torch.rand((2, 300), device=cuda) < 0.5).double()
    beta = torch.zeros((12,), device=cuda, dtype=torch.float64)
    ops.fused_irls(beta, X, y)
    ops.gram_hessian(X[0], torch.rand((300,), device=cuda))
    torch.cuda.synchronize()
    with pytest.raises(AssertionError, match="plain version"):
        ops.fused_irls(beta.cpu(), X.cpu(), y.cpu())
    with pytest.raises(AssertionError, match="plain version"):
        ops.gram_hessian(X[0].cpu(), torch.rand((300,)))


@pytest.mark.parametrize("B,S,H,KVH,D,dtype,outliers", [
    (4, 2048, 40, 8, 128, torch.bfloat16, False),  # the serving shape
    (1, 1000, 32, 8, 120, torch.bfloat16, False),  # H2O-like: ragged, D 120
    (2, 384, 4, 1, 64, torch.float32, False),      # MQA
    (1, 256, 2, 2, 32, torch.float32, True),       # outliers, many blocks
    (1, 200, 2, 2, 16, torch.float32, False),      # ragged S, small D
    (3, 1, 4, 2, 128, torch.float32, False),       # one token
    (1, 2048, 16, 1, 256, torch.bfloat16, False),  # recurrentgemma-like
    (4, 2048, 16, 1, 256, torch.bfloat16, False),  # recurrentgemma serving
    (1, 300, 4, 2, 256, torch.float32, False),     # D 256 on CUDA cores
    (1, 200, 4, 2, 24, torch.bfloat16, False),     # D padded to 32
    (2, 130, 2, 1, 16, torch.bfloat16, False),     # D padded to 32
    (1, 100, 2, 1, 20, torch.bfloat16, False),     # D % 8 != 0: no cp.async
    (1, 70, 2, 1, 7, torch.bfloat16, False),       # odd D: scalar stores
    (3, 1, 4, 2, 128, torch.bfloat16, False),      # one token
])
def test_k7_kernel_matches_plain(cuda, B, S, H, KVH, D, dtype, outliers):
    gen = torch.Generator(device=cuda).manual_seed(S + D)
    q, k, v = (torch.randn((B, S, n, D), generator=gen, device=cuda)
               for n in (H, KVH, KVH))
    if outliers:
        q[:, 17] *= 30.0
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = flash_attention_kernel.launches
    o, m, l = flash_attention_kernel(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == before + 1
    op, mp, lp = flash_attention_plain(q, k, v)
    atol, rtol = (2e-5, 2e-5) if dtype == torch.float32 else (5e-3, 1e-2)
    assert o.dtype == dtype and o.shape == q.shape
    torch.testing.assert_close(o.float(), op.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(m, mp, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(l, lp, rtol=1e-5, atol=0.0)


def test_k7_launches_once_per_layer_of_a_prefill(cuda):
    """A full-causal prefill runs K7 once per layer; decode never; a
    windowed prompt longer than the window takes the banded scan."""
    for arch, prompt, want in (("qwen2_5_32b", 24, 2),
                               ("h2o_danube3_4b", 16, 2),
                               ("h2o_danube3_4b", 48, 0)):
        cfg = smoke_config(arch)
        params = T.init_params(cfg, seed=0, device=cuda)
        toks = torch.randint(0, cfg.vocab_size, (2, prompt), device=cuda)
        before = flash_attention_kernel.launches
        logits, caches, n = T.prefill(params, cfg, toks, cache_len=prompt + 4)
        assert flash_attention_kernel.launches - before == want
        before = flash_attention_kernel.launches
        for _ in range(3):
            logits, caches, n = T.decode_step(params, caches, n, cfg,
                                              logits.argmax(-1))
        torch.cuda.synchronize()
        assert flash_attention_kernel.launches == before
        assert bool(torch.isfinite(logits.float()).all())


def test_k7_cuda_tensors_never_reach_the_plain_version(cuda, monkeypatch):
    def refuse(*args):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(k7_mod, "flash_attention_plain", refuse)
    monkeypatch.setattr(k8_mod, "flash_dq_plain", refuse)
    x = torch.randn((1, 64, 4, 32), device=cuda)
    ops.flash_attention(x, x[:, :, :2].contiguous(), x[:, :, :2].contiguous())
    for dtype in (torch.float32, torch.bfloat16):  # head_dim 256
        y = torch.randn((1, 96, 4, 256), device=cuda).to(dtype)
        ops.flash_attention(y, y[:, :, :1].contiguous(),
                            y[:, :, 1:2].contiguous())
    for d in (128, 256):  # K8a's tensor-core kernel under the gradient
        y = torch.randn((1, 96, 4, d), device=cuda).to(torch.bfloat16) \
            .requires_grad_(True)
        kv = torch.randn((1, 96, 2, d), device=cuda).to(torch.bfloat16)
        o = ops.flash_attention(y, kv, kv)
        torch.autograd.grad(o.float().sum(), (y,))
    cfg = smoke_config("qwen2_5_32b")
    T.prefill(T.init_params(cfg, seed=0, device=cuda), cfg,
              torch.zeros((1, 8), dtype=torch.long, device=cuda))
    torch.cuda.synchronize()
    with pytest.raises(AssertionError, match="plain version"):
        ops.flash_attention(x.cpu(), x[:, :, :2].cpu(), x[:, :, :2].cpu())


def test_prefill_on_the_card_matches_the_cpu(cuda):
    """The smoke config's prefill and decode logits in float32, K7 on the
    card against its plain version on the CPU, same weights."""
    import dataclasses

    cfg = dataclasses.replace(smoke_config("qwen2_5_32b"),
                              dtype_str="float32")
    params = T.init_params(cfg, seed=0, device="cpu")
    on_card = {"embed": params["embed"].to(cuda),
               "final_norm": params["final_norm"].to(cuda),
               "lm_head": params["lm_head"].to(cuda),
               "segments": [{n: t.to(cuda) for n, t in seg.items()}
                            for seg in params["segments"]]}
    toks = torch.randint(0, cfg.vocab_size, (2, 40))
    want, cw, nw = T.prefill(params, cfg, toks, cache_len=44)
    got, cg, ng = T.prefill(on_card, cfg, toks.to(cuda), cache_len=44)
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale
    tok = want.argmax(-1)
    want, _, _ = T.decode_step(params, cw, nw, cfg, tok)
    got, _, _ = T.decode_step(on_card, cg, ng, cfg, tok.to(cuda))
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale


# ------------------------------------------- MoE, MLA, embeddings (F3a)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Dk,Dv", [(192, 128), (24, 16)])
def test_attend_dv_not_dk_matches_plain(cuda, dtype, Dk, Dv):
    """MLA's attention (V narrower than Q and K) runs K7 on V zero-padded
    to Dk: forward against the
    materialized float32 softmax(q k^T) v, at K7's tolerances."""
    from repro_torch.kernels.ref import causal_scores
    from repro_torch.models import attention

    B, S, H = 2, 300, 4
    gen = torch.Generator(device=cuda).manual_seed(Dk + Dv)
    q, k = (torch.randn((B, S, H, Dk), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    v = torch.randn((B, S, H, Dv), generator=gen, device=cuda).to(dtype)
    before = flash_attention_kernel.launches
    with torch.no_grad():
        o = attention.attend(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches - before == 1
    p = torch.softmax(causal_scores(q, k), dim=-1)  # (B, H, 1, S, S)
    want = torch.einsum("bkgqt,btkd->bqkgd", p, v.float()).reshape(
        B, S, H, Dv)
    atol, rtol = (2e-5, 2e-5) if dtype == torch.float32 else (5e-3, 1e-2)
    assert o.dtype == dtype and o.shape == (B, S, H, Dv)
    torch.testing.assert_close(o.float(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("arch,capacity_factor", [
    ("qwen3_moe_235b", 1.25), ("deepseek_v2_lite", 1.25),
    ("deepseek_v2_lite", 0.3)])
def test_moe_ffn_on_the_card_matches_the_cpu(cuda, arch, capacity_factor):
    """The MoE FFN in float32 on the card against the CPU on the same
    inputs: expert ids, queue positions, kept slots and drops equal (x and
    the router on a grid, so the router's logits are exact), y within
    1e-5 of max|y|, aux within 1e-6."""
    import dataclasses

    from repro_torch.models import moe

    cfg = dataclasses.replace(smoke_config(arch),
                              capacity_factor=capacity_factor)
    gen = torch.Generator().manual_seed(11)
    d, E, h = cfg.d_model, cfg.moe_num_experts, cfg.moe_d_ff
    params = {"router": torch.randint(-8, 9, (d, E), generator=gen) / 64.0,
              **{n: 0.1 * torch.randn(shape, generator=gen) for n, shape in
                 (("experts_w1", (E, d, h)), ("experts_w3", (E, d, h)),
                  ("experts_w2", (E, h, d)))}}
    if cfg.moe_num_shared:
        hs = cfg.moe_num_shared * h
        params.update({n: 0.1 * torch.randn(shape, generator=gen)
                       for n, shape in (("shared_w1", (d, hs)),
                                        ("shared_w3", (d, hs)),
                                        ("shared_w2", (hs, d)))})
    x = torch.randint(-8, 9, (4, 64, d), generator=gen) / 8.0
    want = moe.moe_ffn(x, params, cfg)
    got = moe.moe_ffn(x.to(cuda), _to(params, cuda), cfg)
    T_ = x.shape[0] * x.shape[1]
    capacity = max(1, int(T_ * cfg.moe_top_k * capacity_factor / E))
    routes = [moe._route(x.reshape(T_, d).to(dev), params["router"].to(dev),
                         cfg.moe_top_k)[1] for dev in ("cpu", cuda)]
    assert torch.equal(routes[1].cpu(), routes[0])
    for a, b in zip(moe._dispatch(routes[0], capacity, 0, E, E),
                    moe._dispatch(routes[1], capacity, 0, E, E)):
        assert torch.equal(b.cpu(), a)
    assert float(got[2]) == float(want[2])
    if capacity_factor < 1:
        assert float(want[2]) > 0.0
    scale = float(want[0].abs().max())
    assert float((got[0].cpu() - want[0]).abs().max()) <= 1e-5 * scale
    assert abs(float(got[1]) - float(want[1])) <= 1e-6


@pytest.mark.parametrize("arch", ["deepseek_v2_lite", "qwen3_moe_235b",
                                  "musicgen_medium", "llava_next_34b"])
def test_new_families_on_the_card_match_the_cpu(cuda, arch):
    """Prefill and 3 decode steps (MLA decode expanded, then absorbed) of
    the smoke config in float32, the card against the CPU with the same
    weights and inputs, within 1e-4 max|logits|; K7 once a layer of the
    prefill and never in decode."""
    import dataclasses

    cfg = _smoke_f32(arch)
    params = T.init_params(cfg, seed=0, device="cpu")
    on_card = _to(params, cuda)
    gen = torch.Generator().manual_seed(5)
    if cfg.frontend == "embeddings":
        ins = torch.randn((2, 40 + 3, cfg.d_model), generator=gen)
        pre, steps = {"embeds": ins[:, :40]}, [
            {"embeds": ins[:, 40 + i]} for i in range(3)]
    else:
        ins = torch.randint(0, cfg.vocab_size, (2, 43), generator=gen)
        pre, steps = {"tokens": ins[:, :40]}, [
            {"tokens": ins[:, 40 + i]} for i in range(3)]
    before = flash_attention_kernel.launches
    want, cw, nw = T.prefill(params, cfg, cache_len=44, **pre)
    got, cg, ng = T.prefill(on_card, cfg, cache_len=44, **_to(pre, cuda))
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches - before == cfg.num_layers
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale
    before = flash_attention_kernel.launches
    for i, step in enumerate(steps):
        c = dataclasses.replace(cfg, mla_absorb=i == 2)
        want, cw, nw = T.decode_step(params, cw, nw, c, **step)
        got, cg, ng = T.decode_step(on_card, cg, ng, c, **_to(step, cuda))
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == before


# ------------------------------------------ RWKV6 and RG-LRU (F3b)
def _recurrent_params(cfg, kind, seed):
    """Seeded float32 leaves of one block's mixer (and channel mix) on
    the CPU: token-shift mixes in [0, 1], decay logits around -1, the
    rest normal, matrices scaled by fan_in**-0.5."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in T._block_param_shapes(cfg, kind).items():
        if not name.startswith(("rwkv", "lru")):
            continue
        if name.startswith("rwkv_mu"):
            out[name] = torch.rand(shape, generator=gen)
        elif name == "rwkv_w0":
            out[name] = -1.0 + 0.5 * torch.randn(shape, generator=gen)
        elif name == "lru_lambda":
            out[name] = torch.linspace(1.0, 4.0, shape[0])
        elif len(shape) == 2:
            out[name] = torch.randn(shape, generator=gen) * shape[0] ** -0.5
        else:
            out[name] = 0.5 * torch.randn(shape, generator=gen)
    return out


def _card_close(got, want, tol=1e-4):
    assert got.device.type == "cuda"
    err = float((got.cpu() - want).abs().max())
    assert err <= tol * float(want.abs().max()), err


@pytest.mark.parametrize("S", [40, 1])
def test_recurrent_mixers_on_the_card_match_the_cpu(cuda, S):
    """RWKV6's time mix (per token and chunked, fresh and from a carried
    state), its channel mix and RG-LRU's block (fresh and carried) in
    float32, the card against the CPU on the same inputs: outputs and
    states within 1e-4 of their max; the chunked form on the card within
    the same of the per-token one."""
    import dataclasses

    from repro_torch.models import ssm

    gen = torch.Generator().manual_seed(S)
    cfg = _smoke_f32("rwkv6_3b")
    B, d, H, D = 2, cfg.d_model, cfg.num_heads, cfg.rwkv_head_dim
    p = _recurrent_params(cfg, ("rwkv6", "channelmix"), 60)
    x = torch.randn((B, S, d), generator=gen)
    carried = {"state": 0.3 * torch.randn((B, H, D, D), generator=gen),
               "prev_x": torch.randn((B, d), generator=gen)}
    for kw in ({}, carried):
        per_token = None
        for chunk in (0, 16):
            c = dataclasses.replace(cfg, rwkv_chunk=chunk)
            want = ssm.rwkv6_mix(p, x, c, **kw)
            got = ssm.rwkv6_mix(_to(p, cuda), x.to(cuda), c,
                                **_to(kw, cuda))
            _card_close(got[0], want[0])
            _card_close(got[1][0], want[1][0])
            if per_token is None:
                per_token = got
            else:
                _card_close(got[0], per_token[0].cpu())
                _card_close(got[1][0], per_token[1][0].cpu())
        want = ssm.rwkv6_channelmix(p, x, prev_x=kw.get("prev_x"))
        got = ssm.rwkv6_channelmix(_to(p, cuda), x.to(cuda),
                                   prev_x=_to(kw, cuda).get("prev_x"))
        _card_close(got[0], want[0])
    cfg = _smoke_f32("recurrentgemma_9b")
    W, cw = cfg.lru_width, cfg.conv_width
    p = _recurrent_params(cfg, ("rglru", "dense"), 61)
    state = (torch.randn((B, W), generator=gen),
             torch.randn((B, cw - 1, W), generator=gen))
    for st in (None, state):
        want = ssm.rglru_block(p, x, cfg, state=st)
        got = ssm.rglru_block(_to(p, cuda), x.to(cuda), cfg,
                              state=None if st is None else _to(list(st),
                                                                cuda))
        for g, w in ((got[0], want[0]), (got[1][0], want[1][0]),
                     (got[1][1], want[1][1])):
            _card_close(g, w)


@pytest.mark.parametrize("arch,prompt,k7", [
    ("rwkv6_3b", 40, 0), ("recurrentgemma_9b", 24, 1),
    ("recurrentgemma_9b", 40, 0)])
def test_recurrent_families_on_the_card_match_the_cpu(cuda, arch, prompt,
                                                      k7):
    """Prefill and 3 decode steps of the smoke config in float32, the card
    against the CPU with the same weights, within 1e-4 max|logits|; K7
    once a local layer of a prefill no longer than the window (none past
    it: the banded scan), never in decode, never for RWKV6."""
    cfg = _smoke_f32(arch)
    params = T.init_params(cfg, seed=0, device="cpu")
    on_card = _to(params, cuda)
    ins = torch.randint(0, cfg.vocab_size, (2, prompt + 3),
                        generator=torch.Generator().manual_seed(6))
    before = flash_attention_kernel.launches
    want, cw, nw = T.prefill(params, cfg, ins[:, :prompt],
                             cache_len=prompt + 4)
    got, cg, ng = T.prefill(on_card, cfg, ins[:, :prompt].to(cuda),
                            cache_len=prompt + 4)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches - before == k7
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale
    before = flash_attention_kernel.launches
    for i in range(3):
        tok = ins[:, prompt + i]
        want, cw, nw = T.decode_step(params, cw, nw, cfg, tok)
        got, cg, ng = T.decode_step(on_card, cg, ng, cfg, tok.to(cuda))
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == before


# ------------------------------------------------------------- K8 (training)
def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.parametrize("B,S,H,KVH,D,dtype,q_scale", [
    (1, 2048, 40, 8, 128, torch.bfloat16, 1.0),  # the training shape
    (1, 1000, 32, 8, 120, torch.bfloat16, 1.0),  # H2O-like: ragged, D 120
    (2, 384, 4, 1, 64, torch.float32, 1.0),      # MQA
    (1, 256, 2, 2, 32, torch.float32, 1.0),      # many blocks
    (1, 200, 2, 2, 16, torch.float32, 1.0),      # ragged S, small D
    (3, 1, 4, 2, 128, torch.float32, 1.0),       # one token
    (1, 2048, 16, 1, 256, torch.bfloat16, 1.0),  # recurrentgemma-like
    (1, 300, 4, 2, 256, torch.float32, 1.0),     # D 256, 32-row tiles
    (1, 200, 4, 2, 24, torch.bfloat16, 1.0),     # D padded to 32
    (2, 130, 2, 1, 16, torch.bfloat16, 1.0),     # D padded to 32
    (1, 100, 2, 1, 20, torch.bfloat16, 1.0),     # D % 8 != 0: no cp.async
    (1, 70, 2, 1, 7, torch.bfloat16, 1.0),       # odd D: scalar stores
    (3, 1, 4, 2, 128, torch.bfloat16, 1.0),      # one token
    # a peaked softmax (q scaled by 4): dq = sum_j ds_ij k_j, whose dS sums
    # to zero along the row, cancels hardest
    (1, 2048, 40, 8, 128, torch.bfloat16, 4.0),
    (1, 1000, 16, 1, 256, torch.bfloat16, 4.0),
    (2, 300, 8, 2, 64, torch.bfloat16, 4.0),
    # the MoE, MLA and embeddings families' training shapes: MLA's Dk 192
    # (its padded V: test_attend_mla_backward_matches_plain), Qwen3-MoE's
    # 64/4 GQA, MusicGen's 24 heads of 64
    (1, 2048, 16, 16, 192, torch.bfloat16, 1.0),
    (1, 2048, 64, 4, 128, torch.bfloat16, 1.0),
    (1, 2048, 24, 24, 64, torch.bfloat16, 1.0),
])
def test_k8_kernels_match_plain(cuda, B, S, H, KVH, D, dtype, q_scale):
    gen = torch.Generator(device=cuda).manual_seed(S + D + 1)
    q, k, v, do = (torch.randn((B, S, n, D), generator=gen, device=cuda)
                   for n in (H, KVH, KVH, H))
    q, k, v, do = (t.to(dtype) for t in (q_scale * q, k, v, do))
    with torch.no_grad():
        o, m, l = flash_attention_kernel(q, k, v)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, m, 1.0 / torch.clamp(l, min=1e-30), delta)
    before = (flash_dq_kernel.launches, flash_dkdv_kernel.launches)
    got = (flash_dq_kernel(*args), *flash_dkdv_kernel(*args))
    torch.cuda.synchronize()
    assert (flash_dq_kernel.launches, flash_dkdv_kernel.launches) == (
        before[0] + 1, before[1] + 1)
    want = (flash_dq_plain(*args), *flash_dkdv_plain(*args))
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        err = (g.float() - w.float()).abs()
        if dtype == torch.float32:
            scale = max(float(w.abs().max()), float(do.abs().max()))
            assert float(err.max()) <= 2e-5 * scale
        else:
            assert bool((err <= 5e-3 + 1e-2 * w.float().abs()).all()), \
                float(err.max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attend_head_dim_256_matches_plain(cuda, dtype):
    """recurrentgemma's local attention (head_dim 256) with a window of
    at least S runs full-causal through K7, and its gradient through K8a
    and K8b, on the card: forward and backward against the plain
    versions, at the tolerances above."""
    from repro_torch.models import attention

    B, S, H, KVH, D = 1, 320, 16, 1, 256
    gen = torch.Generator(device=cuda).manual_seed(256)
    q, k, v, do = (torch.randn((B, S, n, D), generator=gen, device=cuda)
                   .to(dtype) for n in (H, KVH, KVH, H))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (flash_attention_kernel.launches, flash_dq_kernel.launches,
              flash_dkdv_kernel.launches)
    o = attention.attend(*leaves, window=2048)
    got = (o, *torch.autograd.grad(o, leaves, do))
    torch.cuda.synchronize()
    assert (flash_attention_kernel.launches, flash_dq_kernel.launches,
            flash_dkdv_kernel.launches) == tuple(n + 1 for n in before)
    atol, rtol = (2e-5, 2e-5) if dtype == torch.float32 else (5e-3, 1e-2)
    assert o.dtype == dtype
    torch.testing.assert_close(o.detach().float(),
                               flash_attention_plain(q, k, v)[0].float(),
                               rtol=rtol, atol=atol)
    # the plain backward from the statistics the Function saved
    with torch.no_grad():
        o, m, l = flash_attention_kernel(q, k, v)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, m, 1.0 / torch.clamp(l, min=1e-30), delta)
    want = (flash_dq_plain(*args), *flash_dkdv_plain(*args))
    for g, w in zip(got[1:], want):
        assert g.dtype == dtype and g.shape == w.shape
        err = (g.float() - w.float()).abs()
        if dtype == torch.float32:
            scale = max(float(w.abs().max()), float(do.abs().max()))
            assert float(err.max()) <= 2e-5 * scale
        else:
            assert bool((err <= 5e-3 + 1e-2 * w.float().abs()).all()), \
                float(err.max())


@pytest.mark.parametrize("S", [2048, 300])
def test_attend_mla_backward_matches_plain(cuda, S):
    """MLA's training attention (16 heads, Dk 192, Dv 128, bf16): ``attend``
    pads V to 192 for K7, so K8a and K8b see V and do zero past 128
    columns; dq, dk and dv against the plain backward on the padded
    tensors, dv cut back to 128, at K8's bf16 tolerance."""
    import torch.nn.functional as F

    from repro_torch.models import attention

    B, H, Dk, Dv = 1, 16, 192, 128
    gen = torch.Generator(device=cuda).manual_seed(S + 192)
    q, k = (torch.randn((B, S, H, Dk), generator=gen, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    v, do = (torch.randn((B, S, H, Dv), generator=gen, device=cuda)
             .to(torch.bfloat16) for _ in range(2))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (flash_dq_kernel.launches, flash_dkdv_kernel.launches)
    o = attention.attend(*leaves)
    got = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    assert (flash_dq_kernel.launches, flash_dkdv_kernel.launches) == (
        before[0] + 1, before[1] + 1)
    v_pad, do_pad = F.pad(v, (0, Dk - Dv)), F.pad(do, (0, Dk - Dv))
    with torch.no_grad():
        o_pad, m, l = flash_attention_kernel(q, k, v_pad)
    delta = (do_pad.float() * o_pad.float()).sum(-1).transpose(1, 2) \
        .contiguous()
    args = (q, k, v_pad, do_pad, m, 1.0 / torch.clamp(l, min=1e-30), delta)
    dk_plain, dv_plain = flash_dkdv_plain(*args)
    want = (flash_dq_plain(*args), dk_plain, dv_plain[..., :Dv])
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        err = (g.float() - w.float()).abs()
        assert bool((err <= 5e-3 + 1e-2 * w.float().abs()).all()), \
            float(err.max())


def _smoke_f32(arch="qwen2_5_32b", remat=False):
    import dataclasses

    return dataclasses.replace(smoke_config(arch), dtype_str="float32",
                               remat=remat)


def _leaf_grads(params, cfg, batch):
    from repro_torch.launch.train import _loss_and_grads

    return _loss_and_grads(params, batch, cfg)


def test_loss_grads_on_the_card_match_the_cpu(cuda):
    """The repair of the serving slice: attention through K7 had no
    gradient on the card, so wq, wk, wv and the QKV biases got none.  Every
    leaf's gradient, through K7 + K8 on the card, against the plain
    versions on the CPU."""
    from repro_torch.core.flatbuf import tree_flatten

    cfg = _smoke_f32()
    params = T.init_params(cfg, seed=0, device="cpu")
    for seg in params["segments"]:  # nonzero biases
        for name in ("bq", "bk", "bv"):
            seg[name] += 0.05
    toks = torch.randint(0, cfg.vocab_size, (2, 41),
                         generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want_loss, want = _leaf_grads(params, cfg, batch)
    got_loss, got = _leaf_grads(_to(params, cuda), cfg, _to(batch, cuda))
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
    leaves = tree_flatten(params)[0]
    assert len(got) == len(want) == len(leaves)
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert scale > 0.0
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_launches_and_matches_the_cpu(cuda, remat):
    """One smoke-config ``train_step`` with two institutions on the card
    against the CPU (AdamW eps 1e-3, as in the CPU parity test, so the
    update is Lipschitz in the gradient), and the launches per step: K7
    once per layer and institution (twice with remat), K8a and K8b once."""
    from repro_torch.core.flatbuf import tree_flatten
    from repro_torch.launch.train import train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = _smoke_f32(remat=remat)
    opt = AdamWConfig(lr=1e-2, eps=1e-3, warmup_steps=2)
    toks = torch.randint(0, cfg.vocab_size, (2, 33),
                         generator=torch.Generator().manual_seed(1))
    insts = [{"tokens": toks[j:j + 1, :-1], "labels": toks[j:j + 1, 1:]}
             for j in range(2)]
    params = T.init_params(cfg, seed=1, device="cpu")
    card = _to(params, cuda)
    p_cpu, _, m_cpu = train_step(params, adamw_init(params), insts, cfg, opt)
    counters = (flash_attention_kernel, flash_dq_kernel, flash_dkdv_kernel)
    before = [c.launches for c in counters]
    p_gpu, _, m_gpu = train_step(card, adamw_init(card),
                                 [_to(b, cuda) for b in insts], cfg, opt)
    torch.cuda.synchronize()
    runs = [c.launches - b for c, b in zip(counters, before)]
    L = cfg.num_layers
    assert runs == [L * 2 * (2 if remat else 1), L * 2, L * 2]
    assert abs(m_gpu["loss"] - m_cpu["loss"]) <= 1e-5 * abs(m_cpu["loss"])
    assert abs(m_gpu["grad_norm"] - m_cpu["grad_norm"]) <= 1e-4 * \
        m_cpu["grad_norm"]
    for g, w in zip(tree_flatten(p_gpu)[0], tree_flatten(p_cpu)[0]):
        assert float((g.cpu() - w).abs().max()) <= 1e-6


# ------------------- training the MoE, MLA, embeddings and recurrent families
def _grads_of(fn, tree):
    """(fn's output, d(sum of each output times a fixed cosine weight)/d
    every leaf of ``tree``), leaves in sorted-name order."""
    names = sorted(tree)
    req = {n: tree[n].detach().requires_grad_(True) for n in names}
    outs = fn(req)
    loss = 0.0
    for o in outs:
        w = torch.cos(torch.arange(o.numel(), dtype=torch.float32,
                                   device=o.device)).reshape(o.shape)
        loss = loss + (o.float() * w).sum()
    return outs, dict(zip(names, torch.autograd.grad(
        loss, [req[n] for n in names])))


def _grads_close(got, want, tol=1e-4):
    for name, w in want.items():
        assert got[name].device.type == "cuda"
        err = float((got[name].cpu() - w).abs().max())
        assert err <= tol * float(w.abs().max()), (name, err)


@pytest.mark.parametrize("arch", ["qwen3_moe_235b", "deepseek_v2_lite"])
def test_moe_ffn_backward_on_the_card_matches_the_cpu(cuda, arch):
    """``moe_ffn``'s backward (x, the router, every expert and shared leaf)
    in float32 on the card against the CPU on the same inputs, through the
    aux loss too: x and the router on a grid, so the routing is equal;
    each gradient within 1e-5 of its max."""
    from repro_torch.models import moe

    cfg = smoke_config(arch)
    gen = torch.Generator().manual_seed(12)
    d, E, h = cfg.d_model, cfg.moe_num_experts, cfg.moe_d_ff
    tree = {"x": torch.randint(-8, 9, (2, 64, d), generator=gen) / 8.0,
            "router": torch.randint(-8, 9, (d, E), generator=gen) / 64.0,
            **{n: 0.1 * torch.randn(shape, generator=gen) for n, shape in
               (("experts_w1", (E, d, h)), ("experts_w3", (E, d, h)),
                ("experts_w2", (E, h, d)))}}
    if cfg.moe_num_shared:
        hs = cfg.moe_num_shared * h
        tree.update({n: 0.1 * torch.randn(shape, generator=gen)
                     for n, shape in (("shared_w1", (d, hs)),
                                      ("shared_w3", (d, hs)),
                                      ("shared_w2", (hs, d)))})

    def fn(t):
        p = dict(t)
        y, aux, drop = moe.moe_ffn(p.pop("x"), p, cfg)
        return y, aux, drop

    (y_cpu, _, drop_cpu), want = _grads_of(fn, tree)
    (y, _, drop), got = _grads_of(fn, _to(tree, cuda))
    y, y_cpu = y.detach().cpu(), y_cpu.detach()
    assert float(drop) == float(drop_cpu)
    assert float((y - y_cpu).abs().max()) <= 1e-5 * float(y_cpu.abs().max())
    _grads_close(got, want, 1e-5)


@pytest.mark.parametrize("S", [70, 32])
def test_recurrent_backward_on_the_card_matches_the_cpu(cuda, S):
    """RWKV6's time mix in its chunked form at ``rwkv_chunk`` 32 (the JAX
    package's training preset; S 70 runs two chunks and a ragged tail,
    each chunk under the checkpoint), its channel mix, and RG-LRU's block
    backward in float32: every gradient on the card within 1e-4 of the
    CPU's max."""
    import dataclasses

    from repro_torch.models import ssm

    gen = torch.Generator().manual_seed(S + 32)
    cfg = dataclasses.replace(_smoke_f32("rwkv6_3b"), rwkv_chunk=32)
    tree = dict(_recurrent_params(cfg, ("rwkv6", "channelmix"), 62),
                x=torch.randn((2, S, cfg.d_model), generator=gen))

    def rwkv(t):
        p = dict(t)
        x = p.pop("x")
        y, (state, _) = ssm.rwkv6_mix(p, x, cfg)
        return y, state, ssm.rwkv6_channelmix(p, x)[0]

    _, want = _grads_of(rwkv, tree)
    _, got = _grads_of(rwkv, _to(tree, cuda))
    _grads_close(got, want)
    cfg = _smoke_f32("recurrentgemma_9b")
    tree = dict(_recurrent_params(cfg, ("rglru", "dense"), 63),
                x=torch.randn((2, S, cfg.d_model), generator=gen))

    def rglru(t):
        p = dict(t)
        y, (h, _) = ssm.rglru_block(p, p.pop("x"), cfg)
        return y, h

    _, want = _grads_of(rglru, tree)
    _, got = _grads_of(rglru, _to(tree, cuda))
    _grads_close(got, want)


@pytest.mark.parametrize("arch", ["deepseek_v2_lite", "qwen3_moe_235b",
                                  "musicgen_medium", "rwkv6_3b",
                                  "recurrentgemma_9b"])
def test_family_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """One ``train_step`` of the smoke config in float32 with remat, two
    institutions (MusicGen on seeded frames; RWKV6 chunked at 16, two
    chunks a sequence), on the card against the CPU: loss and grad norm,
    and the parameters within 1e-6 (AdamW eps 1e-3, as above); K7 twice
    per K7 layer and institution, K8a and K8b once."""
    import dataclasses

    from repro_torch.core.flatbuf import tree_flatten
    from repro_torch.launch.train import corpus_batch, train_step
    from repro_torch.models.config import block_kinds
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = _smoke_f32(arch, remat=True)
    if cfg.mixer == "rwkv6":
        cfg = dataclasses.replace(cfg, rwkv_chunk=16)
    opt = AdamWConfig(lr=1e-2, eps=1e-3, warmup_steps=2)
    b = corpus_batch(3, 0, 2, 32, cfg.vocab_size, "cpu",
                     cfg.d_model if cfg.frontend == "embeddings" else 0)
    insts = [{k: v[j:j + 1].float() if k == "embeds" else v[j:j + 1]
              for k, v in b.items()} for j in range(2)]
    params = T.init_params(cfg, seed=2, device="cpu")
    card = _to(params, cuda)
    p_cpu, _, m_cpu = train_step(params, adamw_init(params), insts, cfg, opt)
    counters = (flash_attention_kernel, flash_dq_kernel, flash_dkdv_kernel)
    before = [c.launches for c in counters]
    p_gpu, _, m_gpu = train_step(card, adamw_init(card),
                                 [_to(x, cuda) for x in insts], cfg, opt)
    torch.cuda.synchronize()
    n_k7 = sum(1 for m, _ in block_kinds(cfg)
               if m in ("full", "mla") or (m == "local" and cfg.window >= 32))
    assert [c.launches - n for c, n in zip(counters, before)] == [
        4 * n_k7, 2 * n_k7, 2 * n_k7]
    assert abs(m_gpu["loss"] - m_cpu["loss"]) <= 1e-5 * abs(m_cpu["loss"])
    assert abs(m_gpu["grad_norm"] - m_cpu["grad_norm"]) <= 1e-4 * \
        m_cpu["grad_norm"]
    for g, w in zip(tree_flatten(p_gpu)[0], tree_flatten(p_cpu)[0]):
        assert float((g.cpu() - w).abs().max()) <= 1e-6


def test_k8_cuda_tensors_never_reach_the_plain_versions(cuda, monkeypatch):
    def refuse(*args):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(k8_mod, "flash_dq_plain", refuse)
    monkeypatch.setattr(k8_mod, "flash_dkdv_plain", refuse)
    monkeypatch.setattr(k7_mod, "flash_attention_plain", refuse)
    x = torch.randn((1, 64, 4, 32), device=cuda, requires_grad=True)
    kv = torch.randn((1, 64, 2, 32), device=cuda, requires_grad=True)
    o = ops.flash_attention(x, kv, kv)
    torch.autograd.grad(o.sum(), (x, kv))
    ops.flash_attention_bwd(x.detach(), kv.detach(), kv.detach(),
                            torch.ones_like(x))
    for dtype, d in ((torch.float32, 256), (torch.bfloat16, 256),
                     (torch.bfloat16, 128)):
        y = torch.randn((1, 96, 4, d), device=cuda).to(dtype) \
            .requires_grad_(True)
        kv2 = torch.randn((1, 96, 1, d), device=cuda).to(dtype) \
            .requires_grad_(True)
        o = ops.flash_attention(y, kv2, kv2)
        torch.autograd.grad(o.float().sum(), (y, kv2))
    torch.cuda.synchronize()
    with pytest.raises(AssertionError, match="plain version"):
        ops.flash_attention_bwd(x.detach().cpu(), kv.detach().cpu(),
                                kv.detach().cpu(), torch.ones_like(x).cpu())


# -- the multi-device wires on one card: a single-rank NCCL group ------------

@pytest.fixture
def nccl_pod(cuda, tmp_path):
    """A one-rank NCCL world on the card and its 1D pod mesh (NCCL refuses
    two ranks on one card; several ranks share it over gloo instead)."""
    import datetime

    import torch.distributed as dist
    from repro_torch.distributed import compat, multihost

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        with compat.use_mesh(multihost.pod_mesh(1)) as mesh:
            yield mesh
    finally:
        dist.destroy_process_group()


def _wire_tree(device):
    g = torch.Generator(device=device).manual_seed(5)
    return {"g": 0.5 * torch.randn(300, generator=g, device=device),
            "h": torch.full((4, 4), 3.25, device=device)}


@pytest.mark.parametrize("backend,reveal,out", [
    ("reference", "replicated", "tree"), ("kernel", "replicated", "tree"),
    ("kernel", "sharded", "tree"), ("kernel", "sharded", "tile")])
def test_secure_psum_on_a_single_rank_nccl_group(nccl_pod, backend, reveal,
                                                 out):
    """Each mode reveals the decoded exact sum of the one rank's tree, bit
    for bit, with one K1 and one K2 launch a flat-wire call (none for the
    per-leaf oracle) and nothing staged through the host."""
    from repro_torch.core.collective import secure_psum
    from repro_torch.distributed import compat

    tree = _wire_tree(torch.device("cuda"))
    agg = SecureCollective(backend=backend)
    before = (encode_share_kernel.launches, reconstruct_kernel.launches)
    compat.reset_wire_stats()
    got = secure_psum(tree, "pod", 5, aggregator=agg, reveal=reveal,
                      out=out)
    if out == "tile":
        got = got.gather("pod")
    torch.cuda.synchronize()
    flat = int(backend == "kernel")
    assert (encode_share_kernel.launches - before[0],
            reconstruct_kernel.launches - before[1]) == (flat, flat)
    assert compat.wire_stats().get("host_staged", 0) == 0
    for k, v in tree.items():
        want = (torch.round(v * 2.0**28).double() / 2.0**28).float()
        assert got[k].is_cuda and torch.equal(got[k], want)


# -- the privacy gate on the card --------------------------------------------

_GATE_SPECS = ("secure_fit_fused[protect=both]",
               "secure_fit_fused[protect=gradient]",
               "coordinator_fused[protect=both]",
               "coordinator_fused[protect=gradient]",
               "secure_fit_scan[protect=both]",
               "secure_fit_scan[protect=gradient]",
               "selection_scan[protect=both]",
               "selection_scan[protect=gradient]")


def _gate_run(spec, device):
    from repro_torch.analysis.drivers import certify

    return certify(spec, device, lint=True)


@pytest.mark.parametrize("name", _GATE_SPECS)
def test_gate_on_the_card_matches_the_cpu(cuda, name):
    """The same census, rounds, findings, declassification trail and
    declared kernel calls on the card as on the CPU, where the kernels'
    outputs come through ctypes and the plain versions' through aten."""
    from repro_torch.analysis.drivers import all_driver_specs

    spec = {s.name: s for s in all_driver_specs()}[name]
    got = []
    for device in (torch.device("cpu"), cuda):
        rep, trace = _gate_run(spec, device)
        assert rep.ok, rep.format(verbose=True)
        got.append((trace.round_census(),
                    [(f.severity, f.where, f.message)
                     for f in rep.findings],
                    rep.declassifications, dict(trace.kernels),
                    [(r.kind, r.where, r.taint) for r in trace.host_reads]))
    assert got[0] == got[1]


def test_skip_protect_is_caught_on_the_card(cuda):
    """The kernel-output hole's negative control: K3 writes its summaries
    through ctypes, where no dispatcher sees them; its declaration carries
    their taint, so the plain sums still reach the outputs as SECRET."""
    from repro_torch.analysis.drivers import certify
    from repro_torch.analysis.fixtures import leak_fixture_specs

    spec = leak_fixture_specs()[0]
    assert spec.name == "LEAKY:skip_protect"
    before = fused_irls_kernel.launches
    rep, trace = certify(spec, cuda)
    assert fused_irls_kernel.launches - before == 1
    assert trace.kernels == {"fused_irls_kernel": 1}
    errs = rep.errors()
    assert errs and all("outputs[" in f.where and "SECRET" in f.message
                        for f in errs)


def test_every_kernel_wrapper_with_a_launch_counter_is_declared(cuda):
    import inspect

    found = []
    for mod in (k1_mod, k2_mod, k3_mod, k7_mod, k8_mod):
        for name, obj in inspect.getmembers(mod, callable):
            if hasattr(obj, "launches"):
                found.append(name)
                assert getattr(obj, "gate_hook", None) == ("kernel", name)
    assert sorted(found) == sorted([
        "encode_share_kernel", "share_kernel", "reconstruct_kernel",
        "fused_irls_kernel", "fused_irls_cv_kernel", "gram_hessian_kernel",
        "flash_attention_kernel", "flash_dq_kernel", "flash_dkdv_kernel"])


# -- the sharded serving path (rules=) ----------------------------------------
@pytest.mark.parametrize("B,S,H,KVH,D", [
    (4, 2048, 10, 2, 128),  # Qwen2.5-32B's 40/8 at tp 4
    (4, 2048, 16, 1, 128),  # Qwen3-MoE's 64/4 at tp 4
    (4, 2048, 4, 1, 256),   # RecurrentGemma's 16/1 at tp 4 (KV whole)
])
def test_k7_at_tp4_local_heads(cuda, B, S, H, KVH, D):
    """K7 at the heads one rank of a (1, 4) mesh runs, bf16."""
    gen = torch.Generator(device=cuda).manual_seed(H * D)
    q, k, v = (torch.randn((B, S, n, D), generator=gen, device=cuda).to(
        torch.bfloat16) for n in (H, KVH, KVH))
    o, m, l = flash_attention_kernel(q, k, v)
    op, mp, lp = flash_attention_plain(q, k, v)
    torch.testing.assert_close(o.float(), op.float(), rtol=1e-2, atol=5e-3)
    torch.testing.assert_close(m, mp, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(l, lp, rtol=1e-5, atol=0.0)


def test_single_nccl_rank_mesh_changes_nothing(cuda, tmp_path):
    """One NCCL rank with a (1, 1) mesh: prefill and decode through
    ``rules=`` run the model's program under the mesh (its specs and
    coordinates read from the NCCL mesh, every collective skipped at size
    1) and give the unsharded logits bit for bit, at a small width."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.distributed import compat
    from repro_torch.distributed.sharding import MeshRules

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        rules = MeshRules(compat.make_mesh((1, 1), ("data", "model")))
        cfg = dataclasses.replace(smoke_config("qwen2_5_32b"), d_model=256,
                                  num_heads=8, num_kv_heads=2, head_dim=32)
        params = T.init_params(cfg, seed=0, device=cuda)
        toks = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda)
        outs = []
        for r in (None, rules):
            with torch.inference_mode():
                logits, caches, n = T.prefill(params, cfg, toks,
                                              cache_len=44, rules=r)
                got = [logits]
                for _ in range(3):
                    logits, caches, n = T.decode_step(
                        params, caches, n, cfg, got[0].argmax(-1), rules=r)
                    got.append(logits)
            outs.append(torch.stack(got))
        assert torch.equal(*outs)
    finally:
        dist.destroy_process_group()


def _sharded_rank(rank, world, rdzv, out_path, args):
    """A rank of a (1, 4) mesh on cuda:0 over gloo: the sharded prefill
    and three decode steps of each case, gathered, and the unsharded run
    on rank 0."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.distributed import compat
    from repro_torch.distributed.sharding import MeshRules, shard_params

    dist.init_process_group("gloo", init_method=rdzv, rank=rank,
                            world_size=world)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    errs = {}
    try:
        rules = MeshRules(compat.make_mesh((1, 4), ("data", "model")))
        for arch, flags, S in args:
            cfg = dataclasses.replace(smoke_config(arch), dtype_str="float32",
                                      **flags)
            if cfg.moe_num_experts:  # drop-free
                cfg = dataclasses.replace(
                    cfg, capacity_factor=float(cfg.moe_num_experts))
            params = T.init_params(cfg, seed=0, device=dev)
            g = torch.Generator().manual_seed(1)
            toks = torch.randint(0, cfg.vocab_size, (4, S + 3),
                                 generator=g).to(dev)
            local = shard_params(params, rules, cfg)
            got, want = [], []
            with torch.inference_mode():
                for p, r, out in ((local, rules, got), (params, None, want)):
                    logits, caches, n = T.prefill(p, cfg, toks[:, :S],
                                                  cache_len=S + 4, rules=r)
                    out.append(T.gather_logits(logits, cfg, r))
                    for i in range(3):
                        logits, caches, n = T.decode_step(
                            p, caches, n, cfg, toks[:, S + i], rules=r)
                        out.append(T.gather_logits(logits, cfg, r))
            errs[arch] = max(float((a - b).abs().max() / b.abs().max())
                             for a, b in zip(got, want))
        if rank == 0:
            torch.save(errs, out_path)
    finally:
        dist.destroy_process_group()


def test_sharded_serving_on_the_card_matches_unsharded(cuda):
    """Four gloo ranks on one card, a (1, 4) mesh, float32 smoke configs:
    the context-parallel windowed prefill (ppermute through the host),
    expert parallelism, the mixed q/KV heads and RG-LRU's channel split,
    each within 1e-5 of max|logits| of the unsharded run."""
    from repro_torch.distributed.multihost import spawn_ranks

    cases = (("h2o_danube3_4b", {"seq_parallel_prefill": True}, 64),
             ("qwen3_moe_235b", {}, 32), ("recurrentgemma_9b", {}, 32),
             ("deepseek_v2_lite", {"mla_absorb": True}, 32))
    errs = spawn_ranks(4, _sharded_rank, cases, deadline_s=300)
    assert all(e <= 1e-5 for e in errs.values()), errs


# -- gradients under a mesh (loss_fn(rules=), mesh_train_step) ----------------
@pytest.mark.parametrize("B,S,H,KVH,D", [
    (1, 2048, 10, 2, 128),  # Qwen2.5-32B's 40/8 at tp 4
    (1, 2048, 16, 1, 128),  # Qwen3-MoE's 64/4 at tp 4
    (1, 2048, 4, 1, 256),   # RecurrentGemma's 16/1 at tp 4 (KV whole)
])
def test_k8_tp4_local_heads(cuda, B, S, H, KVH, D):
    """K8a/K8b at the heads one rank's backward runs under a (1, 4) mesh,
    bf16, against their plain versions."""
    gen = torch.Generator(device=cuda).manual_seed(H * D + 1)
    q, k, v, do = (torch.randn((B, S, n, D), generator=gen, device=cuda)
                   .to(torch.bfloat16) for n in (H, KVH, KVH, H))
    with torch.no_grad():
        o, m, l = flash_attention_kernel(q, k, v)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, m, 1.0 / torch.clamp(l, min=1e-30), delta)
    got = (flash_dq_kernel(*args), *flash_dkdv_kernel(*args))
    want = (flash_dq_plain(*args), *flash_dkdv_plain(*args))
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs()
        assert bool((err <= 5e-3 + 1e-2 * w.float().abs()).all()), \
            float(err.max())


def test_nccl_train_mesh_of_one_is_unsharded(cuda, tmp_path):
    """One NCCL rank with a (1, 1) mesh: three ``mesh_train_step`` calls
    through ``rules=`` (every collective skipped at size 1) give the
    metrics and parameters of the same calls without rules bit for bit,
    at a small width in bf16 with remat."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.core.flatbuf import tree_flatten
    from repro_torch.distributed import compat
    from repro_torch.distributed.sharding import MeshRules
    from repro_torch.launch.train import corpus_batch, mesh_train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        rules = MeshRules(compat.make_mesh((1, 1), ("data", "model")))
        cfg = dataclasses.replace(smoke_config("qwen2_5_32b"), d_model=256,
                                  num_heads=8, num_kv_heads=2, head_dim=32,
                                  dtype_str="bfloat16", remat=True)
        outs = []
        for r in (None, rules):
            params = T.init_params(cfg, seed=0, device=cuda)
            state = adamw_init(params)
            ms = []
            for step in range(3):
                params, state, m = mesh_train_step(
                    params, state, corpus_batch(0, step, 4, 64,
                                                cfg.vocab_size, cuda),
                    cfg, AdamWConfig(lr=1e-3), rules=r)
                ms.append(m)
            outs.append((ms, tree_flatten(params)[0]))
        (ma, pa), (mb, pb) = outs
        assert ma == mb
        assert all(torch.equal(a, b) for a, b in zip(pa, pb))
    finally:
        dist.destroy_process_group()


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _train_rank(rank, world, rdzv, out_path, args):
    """A rank of a (1, ntp) mesh on ``device`` over gloo: ``loss_fn``'s
    gradient of each case on its blocks there, against the unsharded
    gradient on the CPU cut to its blocks (the largest error of a leaf
    over its max|g|)."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.core.flatbuf import tree_flatten, tree_unflatten
    from repro_torch.distributed import compat
    from repro_torch.distributed.sharding import MeshRules, shard_params
    from repro_torch.launch.train import _value_and_grad

    dist.init_process_group("gloo", init_method=rdzv, rank=rank,
                            world_size=world)
    device, ntp, cases = args
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    errs = {}
    try:
        rules = MeshRules(compat.make_mesh((1, ntp), ("data", "model")))
        for arch, flags, S in cases:
            cfg = dataclasses.replace(smoke_config(arch), dtype_str="float32",
                                      remat=True, **flags)
            if cfg.moe_num_experts:  # drop-free
                cfg = dataclasses.replace(
                    cfg, capacity_factor=float(cfg.moe_num_experts))
            params = T.init_params(cfg, seed=0, device="cpu")
            g = torch.Generator().manual_seed(1)
            toks = torch.randint(0, cfg.vocab_size, (4, S + 1), generator=g)
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            _, _, got = _value_and_grad(
                _to(shard_params(params, rules, cfg), dev),
                _to(batch, dev), cfg, rules)
            _, _, whole = _value_and_grad(params, batch, cfg)
            want = tree_flatten(shard_params(tree_unflatten(
                tree_flatten(params)[1], whole), rules, cfg))[0]
            errs[arch] = max(float((a.cpu() - b).abs().max())
                             / max(float(w.abs().max()), 1e-30)
                             for a, b, w in zip(got, want, whole))
        gathered = [None] * world
        dist.all_gather_object(gathered, errs)
        if rank == 0:
            torch.save(gathered, out_path)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("ntp", [2, 4])
def test_train_tp4_gradients_on_the_card_match_the_cpu(cuda, ntp):
    """Gloo ranks on one card, a (1, 2) and a (1, 4) mesh, float32 smoke
    configs with remat: each rank's ``loss_fn`` gradient blocks on the
    card (its collectives and their backward through the host, K7/K8's
    plain-version twins replaced by the kernels) within 1e-4 of max|g|
    of the unsharded gradient on the CPU; the context-parallel windowed
    attention, expert parallelism, the mixed q/KV heads and RG-LRU's
    channel split among them."""
    from repro_torch.distributed.multihost import spawn_ranks

    cases = (("qwen2_5_32b", {}, 32),
             ("h2o_danube3_4b", {"seq_parallel_prefill": True}, 64),
             ("qwen3_moe_235b", {}, 32), ("recurrentgemma_9b", {}, 32),
             ("deepseek_v2_lite", {}, 32))
    ranks = spawn_ranks(ntp, _train_rank, ("cuda:0", ntp, cases),
                        deadline_s=300)
    for errs in ranks:
        assert all(e <= 1e-4 for e in errs.values()), errs


# -- the shape dry run: knobs and the counter on the card ---------------------


def test_knob_model_equals_the_compiled_kernels(cuda):
    """Every one of the 42 instantiations' model (``kernels/tuning.py``)
    equals ``cudaFuncGetAttributes`` and the occupancy API (static and
    dynamic shared memory, threads a block, blocks an SM from the compiled
    registers, the registers within the launch bounds' cap), and the flash
    kernels' dynamic shared memory equals ``repro_k7_smem_bytes`` and
    ``repro_k8_smem_bytes`` at every head dim."""
    from repro_torch.analysis.lints import lint_kernel_knobs
    from repro_torch.kernels import _build, tuning

    attrs = tuning.compiled_attributes()
    assert len(attrs) == 42
    families = tuning.check_compiled(attributes=attrs)
    assert sum(f["instantiations"] for f in families.values()) == 42
    assert lint_kernel_knobs(registers={
        n: a["registers"] for n, a in attrs.items()}).ok
    lib = _build.library()
    for fam in ("K7", "K8a", "K8b"):
        for inst in tuning.instantiations(tuning.DEFAULT_KNOBS[fam]):
            _, kind, dim = inst.name.split()
            d, bf16 = int(dim[1:]), int(kind == "bf16")
            got = (lib.repro_k7_smem_bytes(d, bf16) if fam == "K7" else
                   lib.repro_k8_smem_bytes(int(fam == "K8b"), d, bf16))
            assert got == inst.dynamic_smem, inst


def test_counter_on_meta_equals_the_card(cuda):
    """One smoke train step (bf16, remat, small width) counted on ``meta``
    and on the card: the same FLOPs and kernel calls, and the card's
    launches K7 twice and K8a, K8b once a layer."""
    import dataclasses

    from repro_torch.launch.cost_analysis import CostCounter
    from repro_torch.launch.train import _value_and_grad, corpus_batch

    cfg = dataclasses.replace(smoke_config("qwen2_5_32b"), d_model=256,
                              num_heads=8, num_kv_heads=2, head_dim=32,
                              dtype_str="bfloat16", remat=True)
    counts = []
    for dev in (torch.device("meta"), cuda):
        params = (T.abstract_params(cfg) if dev.type == "meta"
                  else T.init_params(cfg, seed=0, device=dev))
        batch = {k: (torch.empty(v.shape, dtype=v.dtype, device=dev)
                     if dev.type == "meta" else v)
                 for k, v in corpus_batch(0, 0, 4, 64, cfg.vocab_size,
                                          cuda).items()}
        for k in (flash_attention_kernel, flash_dq_kernel,
                  flash_dkdv_kernel):
            k.launches = 0
        with CostCounter() as counter:
            _value_and_grad(params, batch, cfg)
        counts.append((counter.flops, dict(counter.kernel_calls),
                       [k.launches for k in (flash_attention_kernel,
                                             flash_dq_kernel,
                                             flash_dkdv_kernel)]))
    (f_meta, calls_meta, launch_meta), (f_card, calls_card, launch_card) = \
        counts
    assert f_meta == f_card
    assert calls_meta == calls_card == {"K7": 4, "K8a": 2, "K8b": 2}
    assert launch_meta == [0, 0, 0] and launch_card == [4, 2, 2]
