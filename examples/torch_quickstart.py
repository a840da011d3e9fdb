"""Quickstart on the PyTorch port: the paper's protocol in a few calls.

Five hospitals jointly fit an L2-regularized logistic regression without
sharing records OR unprotected summary statistics, and verify the result
matches the pooled centralized fit exactly (paper Fig. 2).  The twin of
``examples/quickstart.py``: the same sizes, settings, lines and asserts,
on the CUDA card unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.core.collective import SecureCollective  # noqa: E402
from repro_torch.core.newton import centralized_fit, secure_fit  # noqa: E402
from repro_torch.core.shamir import ShamirScheme  # noqa: E402
from repro_torch.data.synthetic import generate_synthetic  # noqa: E402


def run(device=None, parts=None) -> dict:
    """The example's flow; prints its lines and returns them with the
    fits.  ``parts`` ([(X_j, y_j)], numpy or tensors) replaces the
    seeded study, e.g. with the JAX example's draw."""
    dev = resolve_device(device)
    # 1. Five institutions, 2k records each, 8 covariates (Algorithm 3).
    if parts is None:
        parts = generate_synthetic(
            0, num_institutions=5, records_per_institution=2_000, dim=8,
            device=dev,
        ).parts
    parts = [(torch.as_tensor(X, dtype=torch.float64, device=dev),
              torch.as_tensor(y, dtype=torch.float64, device=dev))
             for X, y in parts]

    # 2. Secure fit: summaries are Shamir-shared 2-of-3 across Computation
    #    Centers; only the *global* aggregates are ever reconstructed.
    #    overflow_check arms the fixed-point headroom check on every
    #    protect: a value past capacity raises instead of saturating into
    #    a plausible-but-wrong reveal.
    agg = SecureCollective(scheme=ShamirScheme(threshold=2, num_shares=3),
                           overflow_check=True)
    secure = secure_fit(parts, lam=1.0, protect="gradient", aggregator=agg,
                        device=dev)

    # 3. Gold standard: pooled IRLS on the concatenated data (no privacy).
    gold = centralized_fit(torch.cat([X for X, _ in parts]),
                           torch.cat([y for _, y in parts]), lam=1.0,
                           device=dev)

    r2 = float(np.corrcoef(secure.beta, gold.beta)[0, 1] ** 2)
    lines = [
        f"secure fit:    {secure.iterations} iterations, "
        f"converged={secure.converged}",
        f"gold standard: {gold.iterations} iterations",
        f"R^2(secure, gold) = {r2:.10f}   (paper Fig 2: 1.00)",
        f"max |beta_sec - beta_gold| = "
        f"{np.max(np.abs(secure.beta - gold.beta)):.2e}",
        f"bytes transmitted: {secure.bytes_transmitted:,}",
    ]
    for line in lines:
        print(line)
    assert r2 > 0.999999
    assert secure.iterations <= 10  # paper Fig 3: 6-8
    print("OK")
    return {"lines": lines + ["OK"], "secure": secure, "gold": gold,
            "r2": r2, "device": str(dev)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
