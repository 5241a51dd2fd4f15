"""The serve tier (counterpart of capital_tpu/serve/): the solve engine
(`SolveEngine`, `ServeConfig`), its continuous scheduler, executor and
program cache (with the persistent warm-up manifest behind
``ServeConfig.persist_dir``), the batched bucket programs of the small-N
and structured solves (`api`), the bucketing that feeds them (`batching`),
the request stats (`stats`) and rolling-window telemetry (`telemetry`),
factor residency (`factorcache.FactorCache`, the engine's `factor_token=`)
and streaming sessions (`sessions.SessionManager`).  On the card each
capturable bucket program is one CUDA graph (`program`).

The front end: `router.Router` over N `replica` workers (threads, or
spawned engine processes that share the card), `loadgen` (the closed-loop
A/B harnesses) and the CLI, ``python -m capital_tpu_torch.serve
smoke|loadgen|replicas``.

    from capital_tpu_torch import Grid
    from capital_tpu_torch.serve import ServeConfig, SessionManager, SolveEngine

    eng = SolveEngine(Grid.square(device="cpu"), ServeConfig(buckets=(16, 32)))
    ticket = eng.submit("posv", A, B)
    eng.drain()
    x = ticket.result().x
    r = eng.solve("posv_cached", A, B, factor_token="a")   # seeds "a"
    r = eng.solve("chol_update", V, factor_token="a")      # ships V only
    mgr = SessionManager(eng)
    mgr.open("s", D, C); mgr.append("s", D2, C2); mgr.solve("s", Bw)

    r = Router(RouterConfig(policy="bucket_affinity"))
    for i in range(2):
        r.add_replica(make_replica("process", f"r{i}", cfg, device="cuda"))
    r.warmup(specs); r.start()
    x = r.submit("posv", A, B).result(timeout=60).x

Exports resolve lazily (PEP 562): the engine names import torch on first
touch, while the router, replica, loadgen and telemetry modules stay
importable from host-only processes (router pumps, loadgen clients).
"""

from __future__ import annotations

#: attribute -> defining submodule; the engine-side names import torch
#: transitively, the router side stays host-only.
_EXPORTS = {
    "ExecutableCache": "capital_tpu_torch.serve.cache",
    "ServeConfig": "capital_tpu_torch.serve.engine",
    "SolveEngine": "capital_tpu_torch.serve.engine",
    "Executor": "capital_tpu_torch.serve.executor",
    "Response": "capital_tpu_torch.serve.executor",
    "Ticket": "capital_tpu_torch.serve.executor",
    "FactorCache": "capital_tpu_torch.serve.factorcache",
    "Scheduler": "capital_tpu_torch.serve.scheduler",
    "SessionEvicted": "capital_tpu_torch.serve.sessions",
    "SessionManager": "capital_tpu_torch.serve.sessions",
    "EngineReplica": "capital_tpu_torch.serve.replica",
    "ProcessReplica": "capital_tpu_torch.serve.replica",
    "Result": "capital_tpu_torch.serve.replica",
    "ThreadReplica": "capital_tpu_torch.serve.replica",
    "make_replica": "capital_tpu_torch.serve.replica",
    "Router": "capital_tpu_torch.serve.router",
    "RouterConfig": "capital_tpu_torch.serve.router",
    "RouterTicket": "capital_tpu_torch.serve.router",
    "WindowAggregator": "capital_tpu_torch.serve.telemetry",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    value = getattr(importlib.import_module(module), name)
    globals()[name] = value  # cache: the next access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
