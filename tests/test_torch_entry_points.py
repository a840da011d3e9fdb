"""``chip_smoke.py`` phase 22 (the normal entry points) rehearsed on the
CPU at smoke scale: the four example twins, ``python
examples/torch_quickstart.py``, ``launch.train``'s command lines on the
paper's four studies at ``--scale 0.02`` and ``launch.serve``'s, with
every check the phase makes that does not need the card (the launch
counts and the block's copy back to the host are the card's)."""
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_kernel  # noqa: E402,E501
from repro_torch.kernels.flash_attention_bwd import (  # noqa: E402
    flash_dkdv_kernel,
    flash_dq_kernel,
)
from repro_torch.kernels.fused_irls import (  # noqa: E402
    fused_irls_cv_kernel,
    fused_irls_kernel,
    gram_hessian_kernel,
)
from repro_torch.kernels.shamir_poly import (  # noqa: E402
    encode_share_kernel,
    share_kernel,
)
from repro_torch.kernels.shamir_reconstruct import reconstruct_kernel  # noqa: E402,E501

KERNELS = (encode_share_kernel, reconstruct_kernel, fused_irls_kernel,
           fused_irls_cv_kernel, share_kernel, gram_hessian_kernel,
           flash_attention_kernel, flash_dq_kernel, flash_dkdv_kernel)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's runs: the suite's parallel
    workers share the cores, and several processes each running a full
    OpenMP team stall each other (six copies of the smart-grid twin took
    486 s each with 8 threads, 1.1-1.7 s with one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_phase_22_rehearsal_on_the_cpu():
    def reset():
        for k in KERNELS:
            k.launches = 0

    def read():
        return {k.__name__: k.launches for k in KERNELS}

    out = chip_smoke.entry_points_phase(torch.device("cpu"), "cpu",
                                        (reset, read), smoke=True)
    runs = out["runs"]
    assert out["scale"] == 0.02
    assert {"quickstart", "quickstart_subprocess", "consortium",
            "smart_grid", "secure_lm", "secure_lm_resume_check",
            "train_scan_synthetic", "train_scan_synthetic_counted",
            "train_select_insurance", "train_l1_parkinsons_total",
            "train_checkpointed_parkinsons_total",
            "train_resumed_parkinsons_total", "train_lm_fail_compress",
            "serve_qwen2_5_32b", "serve_deepseek_v2_lite", "serve_rwkv6_3b",
            "cpu_institutions"} <= set(runs)
    assert {f"train_fused_{s}" for s in chip_smoke.EP_STUDIES} <= set(runs)
    # the plain versions launch nothing
    assert all(not r["launches"] for r in runs.values() if "launches" in r)
    assert runs["secure_lm_resume_check"]["losses_equal"]
    assert runs["secure_lm_resume_check"]["state_equal"]
    assert runs["train_resumed_parkinsons_total"]["beta_bit_identical"]
    assert runs["smart_grid"]["selected"] == list(range(7))
    # a scalar read a slot and a headroom maximum a round (the block's
    # copy back is no copy on the CPU)
    reads = runs["train_scan_synthetic_counted"]["fit_host_reads_by_site"]
    assert reads["core/scanfit.py:scan_rounds"] == 50
    assert reads["core/fixed_point.py:check_headroom"] == runs[
        "train_scan_synthetic"]["iterations"]
