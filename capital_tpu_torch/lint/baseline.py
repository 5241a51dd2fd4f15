"""The port's baseline/suppression file (counterpart of
capital_tpu/lint/baseline.py; the file is the port's own,
``capital_tpu_torch/lint/baseline.jsonl``, never the reference's
``lint_baseline.jsonl``).

A lint gate that blocks on day-one findings never gets adopted; a gate that
silently grandfathers them never gets fixed.  The baseline is the middle
path: one JSONL record per *accepted* pre-existing finding (fingerprint +
enough human-readable context to review it in a diff).  Findings whose
fingerprint appears in the baseline are reported as ``suppressed`` and
don't gate; every fresh finding gates immediately.

Workflow:

* ``python -m capital_tpu_torch.lint source --update-baseline`` rewrites
  the file from the current findings — run it when accepting a debt item,
  and review the diff like code (each line names the rule and message).
  A line may carry a ``reason`` (why the finding is accepted); a rewrite
  keeps the reason of every fingerprint that survives.
* ``--no-baseline`` ignores the file: the full-debt view, used by the tests
  to prove a suppressed finding still *exists* (baseline round-trip).
* Fixing a finding makes its baseline line dead weight; ``--update-baseline``
  garbage-collects it.

Fingerprints exclude line numbers on purpose (see rules.Finding.fingerprint)
so the baseline survives unrelated edits.  Their targets are paths relative
to the working directory, so the passes run from the repository root.
"""

from __future__ import annotations

import json
import os
from typing import Iterable

from capital_tpu_torch.lint import rules

#: The port's baseline, beside this module (found from any working
#: directory; its fingerprints name paths relative to the repository root).
DEFAULT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline.jsonl")


def _records(path: str) -> list[dict]:
    """The baseline's records; [] when the file does not exist (a missing
    baseline means no accepted debt, not an error)."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                str(rec["fingerprint"])
            except (json.JSONDecodeError, KeyError, TypeError) as e:
                raise ValueError(
                    f"{path}:{i + 1}: malformed baseline line ({e}); fix or "
                    "regenerate with --update-baseline"
                ) from e
            out.append(rec)
    return out


def load(path: str) -> set[str]:
    """Fingerprint set of the baseline at `path`."""
    return {str(rec["fingerprint"]) for rec in _records(path)}


def write(path: str, findings: Iterable[rules.Finding]) -> int:
    """Rewrite the baseline from `findings` (sorted, one JSON line each,
    deduplicated by fingerprint), keeping the ``reason`` of each
    fingerprint the old file had.  Returns the number of lines written."""
    reasons = {str(rec["fingerprint"]): rec["reason"] for rec in _records(path) if rec.get("reason")}
    seen: dict[str, rules.Finding] = {}
    for f in rules.sort_findings(findings):
        seen.setdefault(f.fingerprint, f)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as fh:
        for fp, f in sorted(seen.items(), key=lambda kv: (kv[1].rule, kv[1].target, kv[1].message)):
            rec = {"fingerprint": fp, "rule": f.rule, "severity": f.severity, "target": f.target,
                   "message": f.message}
            if fp in reasons:
                rec["reason"] = reasons[fp]
            fh.write(json.dumps(rec) + "\n")
    return len(seen)


def apply(
    findings: Iterable[rules.Finding], fingerprints: set[str]
) -> tuple[list[rules.Finding], list[rules.Finding]]:
    """Split findings into (fresh, suppressed) against a fingerprint set."""
    fresh, suppressed = [], []
    for f in findings:
        (suppressed if f.fingerprint in fingerprints else fresh).append(f)
    return fresh, suppressed
