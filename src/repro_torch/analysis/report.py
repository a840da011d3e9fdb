"""Findings and reports for the privacy gate.

The port's copy of the JAX package's ``analysis/report.py``.  A pass (the
taint interpreter or a protocol lint) produces :class:`Finding` records;
one analyzed target (a certified driver run, a source file, a config)
collects them into an :class:`AnalysisReport`.  The report is the unit
``python -m repro_torch.analysis`` prints and gates on: ``ok`` iff no
finding at severity "error".

Severities:

* ``error``   — a privacy-flow violation or protocol-invariant break;
  the gate fails.
* ``warning`` — the pass could not prove the property (e.g. an unknown
  mesh-axis size); surfaced but non-fatal.
* ``info``    — a proved positive fact worth recording (e.g. a
  sanctioned declassification site, a headroom margin).
"""
from __future__ import annotations

import dataclasses

__all__ = ["Finding", "AnalysisReport", "SEVERITIES"]

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One fact a pass established about one program point.

    ``where`` names the boundary, collective, op or host read and its
    Python source line (e.g. ``_reveal_flat@repro_torch/core/
    collective.py:566 <- repro_torch/analysis/fixtures.py:71``), an
    output of the certified run, or a ``file:line`` location for
    source-level lints.
    """

    pass_name: str   # "taint", "host-sync", "headroom", "mesh-axes", ...
    severity: str    # one of SEVERITIES
    where: str       # boundary/op and source line, or file:line
    message: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}")

    def format(self) -> str:
        return f"[{self.severity}] {self.pass_name}: {self.where}: " \
               f"{self.message}"


@dataclasses.dataclass
class AnalysisReport:
    """All findings for one analyzed target."""

    target: str
    findings: list = dataclasses.field(default_factory=list)
    # sanctioned declassification sites the taint pass certified: the
    # audit trail of every place SECRET data legally became PUBLIC
    declassifications: list = dataclasses.field(default_factory=list)

    def add(self, finding: Finding):
        if finding not in self.findings:
            self.findings.append(finding)

    def extend(self, findings):
        for f in findings:
            self.add(f)

    @property
    def ok(self) -> bool:
        return not any(f.severity == "error" for f in self.findings)

    def errors(self) -> list:
        return [f for f in self.findings if f.severity == "error"]

    def format(self, verbose: bool = False) -> str:
        status = "PASS" if self.ok else "FAIL"
        lines = [f"{status}  {self.target}"]
        for f in self.findings:
            if f.severity == "info" and not verbose:
                continue
            lines.append(f"  {f.format()}")
        if verbose:
            for d in self.declassifications:
                lines.append(f"  [declassified] {d}")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {
            "target": self.target,
            "ok": self.ok,
            "findings": [dataclasses.asdict(f) for f in self.findings],
            "declassifications": list(self.declassifications),
        }
