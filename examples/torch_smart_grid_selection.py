"""Smart-grid analytics with private model selection, on the PyTorch port.

Ten utility companies hold household smart-meter features and want to
jointly learn which features predict supply-contract churn, without
sharing household records, per-utility summary statistics, or even
per-utility *validation scores*.  The twin of
``examples/smart_grid_selection.py``: the same sizes, settings, lines and
asserts, on the CUDA card unless ``--device cpu`` is given.  The selection
subsystem runs a descending λ path with 5-fold cross-validation composed
into the secure batched rounds (K5 computes every (λ, fold) summary, K1
shares, K2 reveals), picks λ by the 1-SE rule and refits warm-started on
all data.  The data is drawn on the device from a seeded
``torch.Generator``.

  PYTHONPATH=src python examples/torch_smart_grid_selection.py \\
      [--device cpu]
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.core import Institution  # noqa: E402
from repro_torch.data.partition import partition_rows  # noqa: E402
from repro_torch.selection import SelectionCoordinator  # noqa: E402

N, D, D_TRUE = 12_000, 24, 6
# Descending L2 grid spanning clear underfit (λ ~ n/4) down to nearly
# unregularized; the L1 term is held fixed — feature selection comes from
# the prox-Newton solver at the centers, zero extra privacy surface.
LAMBDAS = [3000.0, 1000.0, 300.0, 100.0, 30.0, 10.0, 3.0]


def draw(dev, seed: int = 11):
    """24 features, only 6 truly predictive (and the intercept)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    X = torch.cat([torch.ones((N, 1), dtype=torch.float64, device=dev),
                   torch.randn((N, D - 1), generator=gen,
                               dtype=torch.float64, device=dev)], dim=1)
    beta_true = torch.zeros((D,), dtype=torch.float64, device=dev)
    beta_true[:D_TRUE + 1] = 0.6 + 0.8 * torch.rand(
        (D_TRUE + 1,), generator=gen, dtype=torch.float64, device=dev)
    y = torch.bernoulli(torch.sigmoid(X @ beta_true), generator=gen)
    return X, y


def run(device=None, X=None, y=None, state=None) -> dict:
    """The example's flow; prints its lines and returns them with the
    report.  ``X``, ``y`` (numpy or tensors) replace the seeded draw, and
    ``state`` is a ``SelectionCoordinator`` checkpoint the path starts
    from (e.g. the JAX run's, carrying its fold ids)."""
    dev = resolve_device(device)
    lines = []

    def say(line=""):
        print(line)
        lines.append(line)

    if X is None:
        X, y = draw(dev)
    X = torch.as_tensor(X, dtype=torch.float64, device=dev)
    y = torch.as_tensor(y, dtype=torch.float64, device=dev)
    parts = partition_rows(X, y, 10)  # 10 utilities
    utilities = [Institution(f"utility{j:02d}", Xj, yj)
                 for j, (Xj, yj) in enumerate(parts)]

    # --- secure cross-validated λ path across the 10 utilities ----------
    coord = SelectionCoordinator(
        utilities, LAMBDAS, num_folds=5, l1=100.0, protect="gradient",
        seed=0, device=dev,
    )
    if state is not None:
        coord.load_state_dict(state)
    report = coord.run_path()

    say("secure 5-fold CV curve (all values are cohort aggregates —")
    say("no utility's validation score was ever revealed):")
    say()
    for line in report.summary_lines():
        say(line)
    say()
    say(f"best λ = {report.lambda_best:g}, "
        f"1-SE pick λ = {report.lambda_1se:g}")
    say(f"secure rounds: {report.rounds_total} "
        f"({report.bytes_per_round} wire bytes/round)")

    # --- the selected model: full-data refit at the 1-SE λ --------------
    beta = np.asarray(report.beta)
    selected = np.where(np.abs(beta) > 1e-6)[0]
    truth = set(range(D_TRUE + 1))
    recovered = truth & set(selected.tolist())
    spurious = set(selected.tolist()) - truth

    say()
    say(f"selected features: {sorted(selected.tolist())}")
    say(f"ground-truth features: {sorted(truth)}")
    say(f"recovered {len(recovered)}/{len(truth)}; "
        f"spurious: {len(spurious)}")
    assert report.lambda_1se >= report.lambda_best  # 1-SE never under-regularizes
    assert len(recovered) >= D_TRUE  # all true signals kept
    assert len(spurious) == 0        # penalty prunes all noise dims
    # the under-fit end of the path must look worse than the pick on
    # held-out data, i.e. the CV curve actually carried information
    assert report.cv_mean[0] > report.cv_mean[report.one_se_index]
    ok = ("OK — λ chosen by secure cross-validation; joint feature "
          "selection without sharing a single household record, summary, "
          "or fold score")
    print(ok)
    lines.append(ok)
    return {"lines": lines, "report": report, "coord": coord,
            "selected": sorted(selected.tolist()), "device": str(dev)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
