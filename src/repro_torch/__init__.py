"""PyTorch + CUDA port of the secure regularized logistic regression system.

The JAX package ``repro`` is the reference; this package mirrors its
module names (``core/field.py``, ``kernels/ops.py``, ...) so a reader
finds each counterpart, and imports nothing of it and nothing of JAX.
Its kernels are hand-written CUDA for Hopper (``csrc/``), built with
nvcc at first use.  Entry points run on the CUDA card unless the caller
passes ``device="cpu"``.
"""
from .core import SecureCollective, centralized_fit, secure_fit  # noqa: F401
from .core.newton import SecureFitDriver  # noqa: F401
from .data import generate_synthetic  # noqa: F401

__all__ = ["SecureCollective", "SecureFitDriver", "centralized_fit",
           "generate_synthetic", "secure_fit"]
