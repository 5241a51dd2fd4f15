"""The serve tier (counterpart of capital_tpu/serve/): so far the batched
bucket programs of the small-N solves (`api`), the dense bucketing that
feeds them (`batching`) and the engine's `ServeConfig` (`engine`).  The
engine itself, its scheduler, caches and telemetry wait for ROADMAP Queue A
item 8."""
