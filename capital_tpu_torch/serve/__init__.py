"""The serve tier (counterpart of capital_tpu/serve/): the solve engine
(`SolveEngine`, `ServeConfig`), its continuous scheduler, executor and
program cache, the batched bucket programs of the small-N and structured
solves (`api`), the bucketing that feeds them (`batching`), the request
stats (`stats`), factor residency (`factorcache.FactorCache`, the engine's
`factor_token=`) and streaming sessions (`sessions.SessionManager`).  On
the card each capturable bucket program is one CUDA graph (`program`).
Telemetry, the persistent tier, the router and loadgen wait for ROADMAP
Queue A item 8's front end.

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
"""

from capital_tpu_torch.serve.cache import ExecutableCache
from capital_tpu_torch.serve.engine import ServeConfig, SolveEngine
from capital_tpu_torch.serve.executor import Executor, Response, Ticket
from capital_tpu_torch.serve.factorcache import FactorCache
from capital_tpu_torch.serve.scheduler import Scheduler
from capital_tpu_torch.serve.sessions import SessionEvicted, SessionManager

__all__ = ["ExecutableCache", "Executor", "FactorCache", "Response", "Scheduler", "ServeConfig",
           "SessionEvicted", "SessionManager", "SolveEngine", "Ticket"]
