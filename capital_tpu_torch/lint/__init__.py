"""capital_tpu_torch.lint — the port's source lint and serve-plane
concurrency sanitizer (counterpart of capital_tpu/lint/, less the
jaxpr/HLO program sanitizer and its targets).

* ``lint.source`` — AST rules over the package source: no bare/broad
  excepts, no FLOP-bearing torch compute outside tracing scopes in
  models/parallel/ops, no unregistered phase-tag literals, no device
  runtime imported at module level by a host-only module.
* ``lint.concurrency`` — the guarded-by / lock-order / blocking-under-lock
  static pass over the serve host plane.
* ``lint.schedule`` — the seeded interleaving explorer that holds the
  ledger identities of ``lint.invariants`` at every step.

CLI: ``python -m capital_tpu_torch.lint {source,concurrency}``, with the
port's baseline (``capital_tpu_torch/lint/baseline.jsonl``) suppressing
accepted pre-existing findings and ``lint:report`` ledger records feeding
``python -m capital_tpu_torch.obs lint-report``.  Host-only: importing it
loads no torch.
"""

from capital_tpu_torch.lint.rules import (  # noqa: F401
    ERROR, INFO, WARN, Finding, Report, gate, sort_findings, summarize,
)
from capital_tpu_torch.lint import baseline, rules, source  # noqa: F401
