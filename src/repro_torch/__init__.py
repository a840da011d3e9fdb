"""PyTorch + CUDA port of the secure regularized logistic regression system.

The JAX package ``repro`` is the reference; this package mirrors its
module names (``core/field.py``, ``kernels/ops.py``, ...) so a reader
finds each counterpart, and imports nothing of it and nothing of JAX.
Its kernels are hand-written CUDA for Hopper (``csrc/``), built with
nvcc at first use.  Entry points run on the CUDA card unless the caller
passes ``device="cpu"``:

* ``secure_fit`` / ``SecureFitDriver`` (``core/newton.py``) — one fit,
  per round or in scan blocks (``rounds="scan"``);
* ``StudyCoordinator`` (``core/protocol.py``) — the deployment shape
  with stragglers, center failures and elastic membership;
* ``secure_cv_path`` / ``SelectionCoordinator`` (``selection/``) — the
  cross-validated λ path and its 1-SE pick;
* ``RoundSupervisor`` (``runtime/``) — any of those drivers under a
  schedule of institution and center faults;
* ``run_multistudy_rounds`` (``core/multistudy.py``) — M studies advanced
  by one collective round.
"""
from .core import SecureCollective, centralized_fit, secure_fit  # noqa: F401
from .core.newton import SecureFitDriver  # noqa: F401
from .core.protocol import Institution, StudyCoordinator  # noqa: F401
from .data import generate_synthetic  # noqa: F401
from .selection import SelectionCoordinator, secure_cv_path  # noqa: F401

__all__ = ["Institution", "SecureCollective", "SecureFitDriver",
           "SelectionCoordinator", "StudyCoordinator", "centralized_fit",
           "generate_synthetic", "secure_cv_path", "secure_fit"]
