"""Observability for the port (counterpart of capital_tpu/obs/): the
per-request span chains of the serve tier (`spans`), the JSONL run ledger
with its writers, validators and `diff` (`ledger`), and the CLI
``python -m capital_tpu_torch.obs {diff, robust-gate, serve-report,
lint-report, trace-report, timeline}``.  All of it is host-only: importing
it loads no torch.  The reference's XLA program audit (`xla_audit`, the
``audit`` command) reads compiled HLO and has no counterpart here."""
