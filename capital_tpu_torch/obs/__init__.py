"""Observability for the port (counterpart of capital_tpu/obs/): the
per-request span chains of the serve tier (`spans`) and the JSONL run
ledger's writers (`ledger`).  The reference's program audits, validators
and `diff` wait for ROADMAP Queue A item 9."""
