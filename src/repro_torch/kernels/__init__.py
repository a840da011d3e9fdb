"""Hand-written CUDA kernels for the port's hot spots (Hopper, sm_90a).

Each kernel: a CUDA source in ``csrc/``, a Python module here with the
kernel's wrapper (launch counter, checks, ctypes call) and its plain
PyTorch version side by side, and a public wrapper in ``ops.py``.

* K1 ``shamir_poly``        — fused fixed-point encode + Shamir shares;
* K2 ``shamir_reconstruct`` — Lagrange reveal + CRT/Garner decode (or the
  reconstructed residues);
* K3 ``fused_irls``         — all institutions' IRLS summaries;
* K4 ``shamir_poly``        — leaf-wise shares of encoded field elements;
* K5 ``fused_irls_cv``      — the same over (configuration, institution)
  pairs with cross-validation fold masks;
* K6 ``fused_irls``         — the weighted Gram X^T diag(w) X.

Nothing here builds or imports CUDA code at import time: the library is
compiled at the first launch (``_build.library``).
"""
from . import ops, ref  # noqa: F401
