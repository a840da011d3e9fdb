"""What the two secure logistic-regression entries (``secure_fit``,
``secure_cv_path``) share: the port's entry point configured as the cell's
configuration states, and the frame of the control that the comparison
has to reject.
"""
from __future__ import annotations

import torch

from . import reference

# the configuration's settings that every entry point takes; a mix's
# ``args`` (the entry's own keyword arguments) and a job's (its λ and
# seeds) are merged over them
ENTRY_SETTINGS = ("protect", "tol", "summaries_backend")


class Program:
    """The system under test: the port's entry point named by the mix,
    configured as the cell's configuration states (and refusing to run
    where the program's protocol differs from it)."""

    def __init__(self, config: dict, mix: dict, device):
        from repro_torch.core.collective import SecureCollective

        self.config, self.mix, self.device = config, mix, device
        self.agg = SecureCollective(backend=config["backend"])
        scheme, codec = self.agg.scheme, self.agg.codec
        runs = {"threshold": scheme.threshold, "centers": scheme.num_shares,
                "moduli": list(scheme.field.moduli),
                "frac_bits": codec.frac_bits}
        stated = {k: config[k] for k in runs}
        if runs != stated:
            raise ValueError(f"the program's protocol {runs} is not the "
                             f"configuration's {stated}")

    def __call__(self, parts, job):
        import repro_torch

        kwargs = {k: self.config[k] for k in ENTRY_SETTINGS}
        kwargs.update(self.mix["args"])
        kwargs.update({k: v for k, v in job.items() if k != "index"})
        return getattr(repro_torch, self.mix["entry"])(
            parts, aggregator=self.agg, device=self.device, **kwargs)

    def load_kernels(self) -> None:
        """Build the program's kernels, or load the build the checkout
        already holds (on the card; off it the program runs none)."""
        if self.device.type == "cuda":
            from repro_torch.kernels import _build

            _build.library()

    @staticmethod
    def counters() -> dict:
        from repro_torch.kernels import fused_irls

        return {"k3_launches": fused_irls.fused_irls_kernel.launches,
                "k5_launches": fused_irls.fused_irls_cv_kernel.launches}

    def free(self) -> None:
        from repro_torch.core.batched_summaries import pack_cache_clear

        pack_cache_clear()
        self.agg = None


class Control:
    """The reference put in the program's place, in float32 with TF32 on:
    the control that the comparison has to reject.  Each entry's control
    answers with the fields its comparison reads, the wire and the rounds
    as the protocol counts them."""

    dtype = torch.float32

    def __init__(self, config: dict, mix: dict, device):
        self.config, self.mix, self.device = config, mix, device
        self._parts = None

    def _low(self, parts):
        if self._parts is None or self._parts[0] is not parts:
            self._parts = (parts, reference.as_dtype(parts, self.dtype))
        return self._parts[1]

    def load_kernels(self) -> None:
        pass

    @staticmethod
    def counters() -> dict:
        return {"k3_launches": 0, "k5_launches": 0}

    def free(self) -> None:
        self._parts = None
