"""The serve tier (counterpart of capital_tpu/serve/): the solve engine
(`SolveEngine`, `ServeConfig`), its continuous scheduler, executor and
program cache, the batched bucket programs of the small-N and structured
solves (`api`), the bucketing that feeds them (`batching`) and the request
stats (`stats`).  On the card each capturable bucket program is one CUDA
graph (`program`).  Factor residency, streaming sessions, telemetry, the
persistent tier, the router and loadgen wait for ROADMAP Queue A item 8.

    from capital_tpu_torch import Grid
    from capital_tpu_torch.serve import ServeConfig, SolveEngine

    eng = SolveEngine(Grid.square(device="cpu"), ServeConfig(buckets=(16, 32)))
    ticket = eng.submit("posv", A, B)
    eng.drain()
    x = ticket.result().x
"""

from capital_tpu_torch.serve.cache import ExecutableCache
from capital_tpu_torch.serve.engine import ServeConfig, SolveEngine
from capital_tpu_torch.serve.executor import Executor, Response, Ticket
from capital_tpu_torch.serve.scheduler import Scheduler

__all__ = ["ExecutableCache", "Executor", "Response", "Scheduler", "ServeConfig",
           "SolveEngine", "Ticket"]
