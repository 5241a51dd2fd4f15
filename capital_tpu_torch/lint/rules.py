"""The lint rules engine: findings, severities, baselines-aware gating
(counterpart of capital_tpu/lint/rules.py, unchanged in behaviour).

The port's coding rules and the serve plane's threading contract are
checked statically, on any source file, and its ledger identities under
seeded interleavings; this module is the policy-free core the passes
share:

* `Finding` — one rule violation, with a stable `fingerprint` that survives
  line-number churn (rule + target + message, not line), so the baseline
  file keeps suppressing a finding while unrelated code moves around it.
* severities — ``error`` (invariant broken), ``warn`` (smells that need a
  human), ``info`` (context the CLI prints but never gates on).
* `gate` — the exit-code policy for ``--fail-on``.

Rule implementations live in `capital_tpu_torch.lint.source` (AST rules),
`concurrency` (guarded-by and lock order) and `schedule` (the
interleaving explorer); the baseline file format in `baseline`.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterable, Optional

ERROR = "error"
WARN = "warn"
INFO = "info"

#: Gate thresholds, most severe first.  ``--fail-on warn`` fails on warn OR
#: error; info never gates (it is context, not a violation).
SEVERITIES = (ERROR, WARN, INFO)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation.

    ``target`` is a source path for the static passes, a scenario name
    (``schedule:submit-vs-pump``) for the interleaving explorer; ``line`` is
    1-based for source findings and 0 where there is no single line.  ``message`` must identify the violation *content-wise* (the
    primitive, the tag, the constant's shape) because the fingerprint hangs
    off it — two different violations must not share a message within one
    (rule, target)."""

    rule: str
    severity: str
    target: str
    line: int
    message: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"unknown severity {self.severity!r}; use one of {SEVERITIES}"
            )

    @property
    def fingerprint(self) -> str:
        """Stable identity for baseline matching: deliberately excludes the
        line number so unrelated edits above a finding don't un-suppress
        it.  The cost is that N identical violations in one file share a
        fingerprint — acceptable: the baseline suppresses the *class*, and
        fixing one of N still leaves the rest suppressed until a
        --update-baseline refresh."""
        ident = f"{self.rule}|{self.target}|{self.message}"
        return hashlib.sha1(ident.encode()).hexdigest()[:16]

    def render(self) -> str:
        loc = f"{self.target}:{self.line}" if self.line else self.target
        return f"{self.severity.upper():5s} {self.rule:24s} {loc}: {self.message}"

    def asdict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fingerprint"] = self.fingerprint
        return d


def summarize(findings: Iterable[Finding]) -> dict[str, int]:
    """Severity -> count, with every severity present (zeros included) so
    the ledger block has a fixed shape."""
    out = {s: 0 for s in SEVERITIES}
    for f in findings:
        out[f.severity] += 1
    return out


def gate(findings: Iterable[Finding], fail_on: str = ERROR) -> bool:
    """True when the findings pass the gate (no finding at or above the
    ``fail_on`` severity).  ``fail_on`` is 'error' (default: warns pass) or
    'warn' (warns fail too); info never fails a gate."""
    if fail_on not in (ERROR, WARN):
        raise ValueError(f"--fail-on must be 'warn' or 'error', got {fail_on!r}")
    failing = (ERROR,) if fail_on == ERROR else (ERROR, WARN)
    return not any(f.severity in failing for f in findings)


def sort_findings(findings: Iterable[Finding]) -> list[Finding]:
    """Stable report order: severity (errors first), then target, line."""
    rank = {s: i for i, s in enumerate(SEVERITIES)}
    return sorted(
        findings, key=lambda f: (rank[f.severity], f.target, f.line, f.rule)
    )


def make(rule: str, severity: str, target: str, message: str,
         line: int = 0) -> Finding:
    """Terse constructor used by the rule implementations."""
    return Finding(rule=rule, severity=severity, target=target, line=line,
                   message=message)


@dataclasses.dataclass
class Report:
    """One pass's outcome after baseline application: what the CLI prints,
    gates on, and writes to the ledger."""

    pass_name: str  # "source" | "concurrency"
    fresh: list[Finding]
    suppressed: list[Finding]
    baseline_path: Optional[str]

    def ok(self, fail_on: str = ERROR) -> bool:
        return gate(self.fresh, fail_on)

    def counts(self) -> dict[str, int]:
        return summarize(self.fresh)

    def block(self, fail_on: str = ERROR) -> dict:
        """The schema-tagged ``lint_report`` ledger payload
        (obs/ledger.validate_lint_report is the consumer contract)."""
        from capital_tpu_torch.obs import ledger  # local: obs imports nothing from lint

        return {
            "schema_version": ledger.SCHEMA_VERSION,
            "pass": self.pass_name,
            "fail_on": fail_on,
            "ok": self.ok(fail_on),
            "counts": self.counts(),
            "suppressed": len(self.suppressed),
            "findings": [f.asdict() for f in sort_findings(self.fresh)],
        }
