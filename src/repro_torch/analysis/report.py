"""Finding/Report containers shared by the three checkers.

A *finding* is one diagnostic (severity, stable code, optional node index,
message); a *report* is an ordered list of findings with an ``ok`` verdict
(no error-severity findings).  All three checkers — effects, plan verifier,
lowering conformance — speak this type, so ``plan_lint`` can merge their
output into one JSON artifact.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional

SEVERITIES = ("error", "warning", "info")


class PlanVerificationError(RuntimeError):
    """A plan failed static verification (``repro_torch.analysis``).

    Raised by ``plan_function(..., verify=True)`` and the launch-time
    ``REPRO_VERIFY_PLANS=1`` hook; the message is the failing report's
    rendered findings.
    """


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic from a checker.

    Attributes:
      severity: "error" (plan is unsound), "warning" (needs attention),
        "info" (context worth surfacing).
      code: stable kebab-case identifier, e.g. ``"tainted-recompute"``.
      message: human-readable, actionable description.
      node: graph node / equation index the finding anchors to, if any.
    """

    severity: str
    code: str
    message: str
    node: Optional[int] = None

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    def to_dict(self) -> dict:
        return {
            "severity": self.severity,
            "code": self.code,
            "message": self.message,
            "node": self.node,
        }


@dataclasses.dataclass
class Report:
    """Outcome of one checker run over one target."""

    checker: str
    findings: List[Finding] = dataclasses.field(default_factory=list)

    def add(self, severity: str, code: str, message: str,
            node: Optional[int] = None) -> None:
        self.findings.append(Finding(severity, code, message, node))

    def extend(self, findings: Iterable[Finding]) -> None:
        self.findings.extend(findings)

    @property
    def ok(self) -> bool:
        return not any(f.severity == "error" for f in self.findings)

    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    def merge(self, other: "Report") -> "Report":
        """New report holding both checkers' findings."""
        out = Report(checker=f"{self.checker}+{other.checker}")
        out.findings = list(self.findings) + list(other.findings)
        return out

    def to_dict(self) -> dict:
        return {
            "checker": self.checker,
            "ok": self.ok,
            "findings": [f.to_dict() for f in self.findings],
        }

    def __str__(self) -> str:
        lines = [f"[{self.checker}] {'OK' if self.ok else 'FAIL'}"]
        for f in self.findings:
            where = f" @node {f.node}" if f.node is not None else ""
            lines.append(f"  {f.severity}: {f.code}{where}: {f.message}")
        return "\n".join(lines)
