"""A research consortium surviving stragglers, center loss and churn, on
the PyTorch port.

The twin of ``examples/fault_tolerant_consortium.py``: the same sizes,
schedule, lines and asserts, on the CUDA card unless ``--device cpu`` is
given.  A ``RoundSupervisor`` drives the deployment-shaped
``StudyCoordinator`` (fused cohort rounds on the kernel wire: K1 encodes
and shares, K2 reveals) through a deterministic ``FailureInjector``
chaos schedule while

  * hospital-7 is a chronic straggler (always misses the round deadline),
  * hospital-3 flaps for 2.5 simulated seconds at round 3 (stops
    heartbeating, self-heals, rejoins without losing its data),
  * Computation Center 2 dies BETWEEN protect and reveal at round 2
    (2-of-4 Shamir absorbs it: the survivors' points reconstruct the
    identical aggregate; nothing is re-run),
  * a replacement center is provisioned at round 5 on the consortium's
    SPARE evaluation point 4, restoring full redundancy,
  * a new institution joins between Newton iterations (elastic
    membership),

and the study still converges to the responding cohort's centralized
beta, with a per-round ``SupervisedRound`` audit trail, the fixed-point
overflow check armed, and a span summary from ``repro_torch.obs.trace``.

  PYTHONPATH=src python examples/torch_fault_tolerant_consortium.py \\
      [--device cpu]
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.core.collective import SecureCollective  # noqa: E402
from repro_torch.core.newton import centralized_fit  # noqa: E402
from repro_torch.core.protocol import Institution, StudyCoordinator  # noqa: E402,E501
from repro_torch.core.shamir import ShamirScheme  # noqa: E402
from repro_torch.data.synthetic import generate_synthetic  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    FailureInjector,
    FaultPolicy,
    RoundSupervisor,
)

SCHEDULE = {
    2: [("center_midround", 2)],        # dies between protect and reveal
    3: [("flap", "hospital-3", 2.5)],   # transient outage, self-heals
    5: [("provision_center", 4)],       # replacement at the spare point
}


def run(device=None, parts=None) -> dict:
    """The example's flow; prints its lines and returns them with the
    coordinator and the supervisor.  ``parts`` (nine [(X_j, y_j)],
    numpy or tensors) replaces the seeded study, e.g. with the JAX
    example's draw."""
    dev = resolve_device(device)
    lines = []

    def say(line=""):
        print(line)
        lines.append(line)

    # record round/newton/retry/protect spans for the end-of-run summary
    # table; disabled tracing is the default and costs one branch per span
    trace.enable()
    if parts is None:
        parts = generate_synthetic(
            3, num_institutions=9, records_per_institution=1_500, dim=10,
            device=dev,
        ).parts
    parts = [(torch.as_tensor(X, dtype=torch.float64, device=dev),
              torch.as_tensor(y, dtype=torch.float64, device=dev))
             for X, y in parts]

    insts = [Institution(f"hospital-{j}", X, y, latency=0.5)
             for j, (X, y) in enumerate(parts[:8])]
    insts[7].latency = 99.0  # chronic straggler: always misses the deadline

    # 2-of-4 Shamir with only 3 centers stood up: evaluation point 4 is
    # the consortium's spare, held back for re-provisioning after a loss
    coord = StudyCoordinator(
        insts, lam=1.0, protect="gradient",
        deadline=2.0, min_responders=4, num_centers=3,
        aggregator=SecureCollective(
            scheme=ShamirScheme(threshold=2, num_shares=4, backend="kernel"),
            overflow_check=True,
        ),
        fused=True, device=dev,
    )
    sup = RoundSupervisor(
        coord,
        policy=FaultPolicy(max_retries=3, round_seconds=1.0,
                           heartbeat_timeout=5.0, reprovision_after=0),
        injector=FailureInjector(SCHEDULE),
    )

    for _ in range(30):
        if coord.converged:
            break
        if sup.round_no + 1 == 4:
            X9, y9 = parts[8]
            coord.add_institution(
                Institution("hospital-8(new)", X9, y9, latency=0.5)
            )
            say(">> hospital-8 JOINED mid-study")
        rec = sup.step()
        rep = rec.report
        flags = []
        if rec.events:
            flags.append("events=" + ",".join(e[0] for e in rec.events))
        if rec.retries:
            flags.append(f"retries={rec.retries} "
                         f"backoff={rec.backoff_seconds:.0f}s")
        if rec.suspected_dead:
            flags.append(f"suspected_dead={rec.suspected_dead}")
        say(f"round {rec.round_no:2d}: obj={rep.objective:.6f} "
            f"|g|={rep.grad_norm:.2e} "
            f"responders={len(rep.responders)} stragglers={rep.stragglers} "
            f"centers={rep.centers_used} "
            f"degraded={'Y' if rec.degraded else 'n'}"
            + (" | " + " ".join(flags) if flags else ""))

    beta = coord.beta.cpu().numpy()
    # the final cohort = hospitals 0-6 + hospital-8 (7 never responds; 3's
    # flap healed before convergence, so its data is fully represented)
    cohort_parts = parts[:7] + [parts[8]]
    gold = centralized_fit(torch.cat([X for X, _ in cohort_parts]),
                           torch.cat([y for _, y in cohort_parts]),
                           lam=1.0, device=dev)
    r2 = float(np.corrcoef(beta, gold.beta)[0, 1] ** 2)
    degraded = sum(1 for r in sup.rounds if r.degraded)
    say()
    say(f"converged={coord.converged} after {coord.iteration} rounds "
        f"({degraded} degraded, {sup.total_retries} retries, "
        f"{sup.total_backoff:.0f}s simulated backoff)")
    say(f"centers now at points "
        f"{sorted(c.index for c in coord.centers if c.online)} "
        f"(spare point 4 in service)")
    say(f"R^2 vs centralized-fit-on-responding-cohort = {r2:.8f}")

    tracer = trace.disable()
    say()
    say("per-round span summary (repro_torch.obs.trace):")
    for line in tracer.summary_lines():
        say("  " + line)

    assert coord.converged and r2 > 0.999
    print("OK")
    lines.append("OK")
    return {"lines": lines, "coord": coord, "supervisor": sup,
            "gold": gold, "r2": r2, "device": str(dev)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
