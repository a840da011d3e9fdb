"""The plain reference against hand-worked cases, the frozen work counts at
each cell's shapes, and the comparison's verdicts."""
import math
import types

import numpy as np
import pytest
import torch

import bench_testutil as tu
from pbench import compare, reference, readers, work

F64 = torch.float64


def _two_rows():
    """Rows (x=1, y=1) and (x=-1, y=0): the deviance is 4 log(1 + e^-b),
    so the optimum of 4 log(1 + e^-b) + lam b^2 solves lam b = 2 s(-b)."""
    return [(torch.tensor([[1.0]], dtype=F64), torch.tensor([1.0], dtype=F64)),
            (torch.tensor([[-1.0]], dtype=F64), torch.tensor([0.0],
                                                             dtype=F64))]


def test_summaries_at_zero_by_hand():
    H, g, dev = reference.summaries(_two_rows(), torch.zeros(1, dtype=F64))
    # p = 1/2 on both rows: g = 1 * 1/2 + (-1)(-1/2), H = 2 * 1/4
    assert float(g) == 1.0 and float(H) == 0.5
    assert float(dev) == pytest.approx(4 * math.log(2), rel=1e-15)


def test_irls_solves_the_hand_worked_optimum():
    fit = reference.irls(_two_rows(), lam=1.0)
    b = float(fit.beta)
    assert b == pytest.approx(2.0 / (1.0 + math.exp(b)), abs=1e-14)
    assert 0.6747 < b < 0.6749
    assert fit.objective == pytest.approx(4 * math.log1p(math.exp(-b))
                                          + b * b, rel=1e-14)


def test_masks_select_rows():
    parts = _two_rows()
    masks = [torch.ones(1, dtype=F64), torch.zeros(1, dtype=F64)]
    _, g, dev = reference.summaries(parts, torch.zeros(1, dtype=F64), masks)
    assert float(g) == 0.5
    assert float(dev) == pytest.approx(2 * math.log(2), rel=1e-15)


def test_one_se_rule_by_hand():
    cv_mean = np.array([1.00, 0.95, 0.90, 0.91])
    cv_se = np.array([0.01, 0.01, 0.06, 0.01])
    # best is index 2; its bar 0.96 first met (descending λ) at index 1
    assert reference.one_se_rule(cv_mean, cv_se) == (2, 1)


def test_fold_rule_is_balanced_and_the_protocols():
    from repro_torch.selection.folds import assign_folds

    for n, k, name, seed in ((1000, 5, 0, 0), (997, 5, 3, 2**31 - 1),
                             (64, 4, 7, 123456789)):
        got = reference.fold_ids(n, k, name, seed)
        counts = torch.bincount(got.long(), minlength=k)
        assert int(counts.max() - counts.min()) <= 1
        assert torch.equal(got, assign_folds(n, k, name, seed))


@pytest.mark.parametrize("d, want_fit, want_path", [
    # the program's own wire constants at d 128 (chip_smoke.py)
    (128, 3_342_336, 16_711_680),
    (500, 48_168_960, 240_844_800),
    (28, 196_608, 983_040),
])
def test_round_bytes_by_hand(d, want_fit, want_path):
    cfg = dict(tu.spec().cell("pascal_alpha_s8.fit").config, features=d)
    assert reference.round_bytes(cfg) == want_fit
    assert reference.round_bytes(cfg, configs=5, include_count=True,
                                 extra_scalars=3) == want_path


def test_frozen_work_counts_at_each_cells_shapes():
    k3 = work.k3_fused_irls(500_000, 500, 8)
    assert (k3.bytes, k3.tf32, k3.f64) == (
        2_012_036_064, 375_750_000_000, 1_015_000_000)
    k5 = work.k5_fused_irls_cv(500_000, 2_000_000, 500, 5, 8)
    assert (k5.bytes, k5.tf32, k5.f64) == (
        2_046_181_300, 1_503_000_000_000, 4_575_000_000)
    h3 = work.k3_fused_irls(11_000_000, 28, 8)
    assert (h3.bytes, h3.tf32, h3.f64) == (2_552_027_168, 26_796_000_000,
                                           1_562_000_000)
    h5 = work.k5_fused_irls_cv(11_000_000, 44_000_000, 28, 5, 8)
    assert (h5.bytes, h5.tf32, h5.f64) == (2_596_136_820, 107_184_000_000,
                                           7_194_000_000)
    # pascal's K3 bound by the TF32 Gram, HIGGS's by the bytes
    assert k3.least_s() == pytest.approx(375.75e9 / 495e12)
    assert h3.least_s() == pytest.approx(2_552_027_168 / 3.35e12)
    assert k5.least_s() == pytest.approx(1.503e12 / 495e12)
    assert work.lu_solve(500).f64 == 2 * 500 ** 3 // 3 + 2 * 500 ** 2


def test_round_work_matches_the_cells():
    cell = tu.spec().cell("pascal_alpha_s8.path")
    ctx = readers.Context(cell.config, cell.traffic, True, 0.0, 1.0, [])
    k5 = readers.sweep_round(ctx)[0]
    assert k5 == work.k5_fused_irls_cv(500_000, 2_000_000, 500, 5, 8)
    assert readers.refit_round(ctx)[0] == work.k5_fused_irls_cv(
        500_000, 500_000, 500, 1, 8)


def _fit_answers(parts, lam, beta, config, rounds=5):
    fit = reference.irls(parts, lam)
    res = types.SimpleNamespace(
        beta=beta(fit.beta).numpy(), iterations=rounds, converged=True,
        deviance_trace=[fit.objective],
        bytes_transmitted=rounds * reference.round_bytes(config))
    return [({"lam": lam}, res)]


def test_compare_passes_the_reference_and_fails_a_moved_beta():
    cell = tu.tiny_cell("higgs_s8.fit")
    gen = torch.Generator().manual_seed(3)
    X = torch.randn((300, 6), generator=gen, dtype=F64)
    y = (torch.rand(300, generator=gen, dtype=F64) < 0.5).to(F64)
    parts = [(X[:150], y[:150]), (X[150:], y[150:])]
    same = _fit_answers(parts, 1.0, lambda b: b, cell.config)
    ok, checks, failed = compare.judge(
        compare.fit_checks(cell.config, parts, same, [0]), cell.limits)
    assert ok and failed == 0 and checks["beta_gap"]["value"] == 0.0
    moved = _fit_answers(parts, 1.0, lambda b: b * (1 + 1e-4), cell.config)
    ok, checks, failed = compare.judge(
        compare.fit_checks(cell.config, parts, moved, [0]), cell.limits)
    assert not ok and failed == 1
    assert checks["beta_gap"]["value"] == pytest.approx(1e-4, rel=1e-6)


def test_judge_counts_and_fails_a_nan():
    limits = {"beta_gap": {"limit": 1e-6}, "wire_mismatch": {"limit": 0}}
    per_job = {0: {"beta_gap": float("nan"), "wire_mismatch": 0},
               1: {"beta_gap": 1e-9, "wire_mismatch": 1}}
    ok, checks, failed = compare.judge(per_job, limits)
    assert not ok and failed == 2 and checks["wire_mismatch"]["value"] == 1
    with pytest.raises(ValueError):
        compare.judge(per_job, {"beta_gap": {"limit": 1.0}})
