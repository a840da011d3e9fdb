"""Privacy gate + protocol lints: the port's standing gate.

The port's counterpart of the JAX package's ``analysis/``.  The JAX gate
walks traced jaxprs; the port runs eagerly, so its gate runs each driver
round once on tiny inputs under a taint interpreter (on the CPU or the
card), and its lints read the Python sources and configuration
arithmetic.  Run the whole gate with::

    PYTHONPATH=src python -m repro_torch.analysis [--device cpu|cuda]

Module map:

* ``taint``    — the taint interpreter: institution-local inputs are
  SECRET, the encode+share boundary makes PROTECTED share buffers,
  Algorithm 2 (the institution-axis sum or a pod-axis collective) makes
  them PROTECTED_AGG, and the threshold Lagrange reveal (or an annotated
  ``declassify_sum``) is the only way back to PUBLIC.  SECRET or share
  material reaching an output, a host read, or a reveal in the wrong
  state is an error.  What a dispatcher cannot see (the boundaries, the
  named-axis collectives, every CUDA kernel) is declared to it at its
  host wrapper (``repro_torch/obs/gate.py``).
* ``lints``    — the protocol lints: one host sync per round or block
  (AST), the host reads of a certified round against their marked sites,
  the fixed-point headroom proof, the mesh-axis allowlist, the
  boundary-ownership pass, the obs purity pass, and the kernels'
  launch-knob lint (``kernels/tuning.py``'s H100 budget in place of
  JAX's Pallas VMEM model).
* ``drivers``  — the certified surface: a ``DriverSpec`` for each of the
  JAX package's twelve (fused, scan, selection sweep, 1D/2D
  ``secure_psum``) with the taint labels of its inputs; the psum specs
  run on a spawned gloo world of their mesh.
* ``fixtures`` — deliberately leaky driver variants the gate must FAIL on
  (negative controls, run by the CLI on every invocation).
* ``report``   — ``Finding``/``AnalysisReport`` records, with the
  declassification audit trail.
* ``__main__`` — the CLI gate: certifies every driver spec, runs the
  lints, then the leak fixtures; exit status 0 only if all drivers are
  clean AND every fixture is caught.

Everything hangs off one chain: every driver routes through
:class:`repro_torch.core.collective.SecureCollective`, whose four named
boundaries are at once the taint rules' anchors, the runtime ledger's
hook points (``repro_torch.obs.ledger``) and the census the runtime audit
reconciles (``python -m repro_torch.obs audit``); the ownership lint
turns any bypass into a gate error.
"""
from .report import AnalysisReport, Finding
from .taint import (PROTECTED, PROTECTED_AGG, PUBLIC, SECRET, GateTrace,
                    verify_run)

__all__ = [
    "AnalysisReport",
    "Finding",
    "GateTrace",
    "PUBLIC",
    "PROTECTED_AGG",
    "PROTECTED",
    "SECRET",
    "verify_run",
]
