"""The example twins on the card against the same twins on the CPU.

Marked ``gpu``: without a CUDA card the test skips.  The file imports
neither JAX nor the JAX package, so on a machine with a card and no JAX it
runs on its own:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda_twins.py

The quickstart twin's and the consortium twin's fits on the same
CPU-drawn parts take the same iterations, wire bytes and supervised
rounds on the card and the CPU, their betas within the fixed-point
quantization (S+1)/2^28 (the card's summaries sum in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.fused_irls import fused_irls_kernel
from repro_torch.kernels.shamir_poly import encode_share_kernel
from repro_torch.kernels.shamir_reconstruct import reconstruct_kernel

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _twin(name):
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_twins_on_the_card_match_the_cpu(cuda):
    """The quickstart and consortium twins on the same CPU-drawn parts, on
    the card and on the CPU: the same iterations, wire bytes and
    supervised rounds, beta within (S+1)/2^28; the consortium's fused
    rounds launch K1 and K2 once a round on the card (no K3: the
    coordinator's reference summaries)."""
    from repro_torch.data import generate_synthetic

    qs = _twin("torch_quickstart")
    parts = generate_synthetic(0, 5, 2_000, 8, device="cpu").parts
    card, cpu = qs.run(cuda, parts=parts), qs.run("cpu", parts=parts)
    assert card["secure"].iterations == cpu["secure"].iterations
    assert card["secure"].bytes_transmitted == cpu["secure"].bytes_transmitted
    np.testing.assert_allclose(card["secure"].beta, cpu["secure"].beta,
                               rtol=0, atol=6 / 2**28)

    ftc = _twin("torch_fault_tolerant_consortium")
    parts = generate_synthetic(3, 9, 1_500, 10, device="cpu").parts
    for k in (encode_share_kernel, reconstruct_kernel, fused_irls_kernel):
        k.launches = 0
    card = ftc.run(cuda, parts=parts)
    n = card["coord"].iteration
    assert (encode_share_kernel.launches, reconstruct_kernel.launches,
            fused_irls_kernel.launches) == (n, n, 0)
    cpu = ftc.run("cpu", parts=parts)

    def rounds(out):
        return [(r.round_no, r.retries, r.degraded, r.backoff_seconds,
                 list(r.report.responders), list(r.report.stragglers),
                 list(r.report.centers_used), list(r.suspected_dead))
                for r in out["supervisor"].rounds]

    assert rounds(card) == rounds(cpu) and n == cpu["coord"].iteration
    np.testing.assert_allclose(card["coord"].beta.cpu().numpy(),
                               cpu["coord"].beta.numpy(), rtol=0,
                               atol=9 / 2**28)
