"""SolveEngine: the continuously-batched, shape-bucketed solve service
(counterpart of capital_tpu/serve/engine.py) — the facade over serve's
three pieces:

* **scheduler.py** — admission into in-flight bucket batches, staging of
  the padded operands onto the card at submit, overlapping dispatch of
  consecutive buckets under a bounded in-flight window, deadline flushes.
  ``ServeConfig.scheduler="sync"`` is the stop-and-go loop, kept as the
  A/B baseline.

* **cache.py / program.py** — the program cache: every bucket program is
  built once under an explicit key (op, dtype, shape bucket, grid,
  config hash), with hit/miss counters that make "steady-state traffic
  builds nothing" assertable.  On the card a capturable bucket's program
  (`program.capturable`) is one CUDA graph, captured once — the
  counterpart of the reference's AOT executable; the rest, and every
  program on the CPU, are closures.

* **executor.py** — dispatch, donation, fault containment, result
  landing.  Batched dispatch does not synchronize (a CUDA event marks the
  batch); landing stamps each request's queue-wait/device split into the
  stats.

The engine keeps the public surface (`submit`/`pump`/`drain`/`solve`/
`warmup`/`cache_stats`/`emit_stats`/`emit_trace`) plus the policies that
need the whole picture: request validation, the host-side
``serve::ingest`` fault tap (a planted fault corrupts exactly one request
and never a cached program), bucket resolution and the config hash.

`SolveEngine(grid=None, cfg)` runs on the CUDA card (`Grid.square()`,
which raises without one); pass ``Grid.square(device="cpu")`` to run the
plain versions on the host.  Not ported yet, each raising
NotImplementedError naming its ROADMAP item: the factor-residency ops and
methods (Queue A item 8, factor residency), the streaming-session ops
(item 8, sessions), rolling-window telemetry (`enable_telemetry`, item 8's
front end) and the persistent disk tier (`ServeConfig.persist_dir`, item
8's persistent tier).
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Optional

import numpy as np
import torch

from capital_tpu_torch.models import blocktri
from capital_tpu_torch.obs import spans
from capital_tpu_torch.ops import batched_small
from capital_tpu_torch.parallel.topology import Grid
from capital_tpu_torch.robust import faultinject
from capital_tpu_torch.robust.config import RobustConfig
from capital_tpu_torch.serve import api, batching, program, stats
from capital_tpu_torch.serve.cache import ExecutableCache
from capital_tpu_torch.serve.executor import Executor, Response, Ticket, _Pending
from capital_tpu_torch.serve.scheduler import Scheduler
from capital_tpu_torch.utils import tracing

#: precision names the models accept (CholinvConfig.precision)
PRECISIONS = (None, "default", "high", "highest")

SCHEDULERS = ("continuous", "sync")

#: the ROADMAP items of what the engine refuses
TELEMETRY_ITEM = "Queue A item 8, serve tier (front end: rolling-window telemetry)"
PERSIST_ITEM = "Queue A item 8, serve tier (persistent tier)"


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine policy knobs (the reference's docstring has each in full).

    buckets: the n ladder (SPD dimension / lstsq columns).
    rows_buckets: the lstsq m ladder (requests bucket at m + column-pad).
    nrhs_buckets: the RHS-columns ladder.
    nblocks_buckets, block_buckets, border_buckets: the posv_blocktri /
        posv_arrowhead ladders (chain length, block size, border width).
    blocktri_impl: the chain algorithm of those programs ('auto', 'scan',
        'partitioned'); blocktri_partitions: its split count (0 = default).
    max_batch: per-bucket batch capacity — one program per bucket at this
        fixed batch size.
    max_delay_s: oldest-request age that forces a flush.
    precision: matmul precision inside the programs ('highest' is IEEE f32).
    robust: per-request breakdown flagging.
    donate, oversize, tail_fuse_depth, scheduler, max_inflight, persist_dir,
        factor_cache_bytes: engine knobs (Queue A item 8).
    small_n_impl: which batched implementation the bucket programs use
        (serve/api.batched): 'auto', 'vmap', 'pallas' or 'pallas_split'.
    """

    buckets: tuple[int, ...] = (256, 512, 1024)
    rows_buckets: tuple[int, ...] = (4096, 16384, 65536)
    nrhs_buckets: tuple[int, ...] = (1, 8, 64)
    nblocks_buckets: tuple[int, ...] = (8, 32, 64)
    block_buckets: tuple[int, ...] = (32, 64, 128)
    border_buckets: tuple[int, ...] = (8, 16, 32)
    blocktri_impl: str = "auto"
    blocktri_partitions: int = 0
    max_batch: int = 8
    max_delay_s: float = 0.005
    precision: Optional[str] = "highest"
    robust: Optional[RobustConfig] = None
    donate: Optional[bool] = None
    oversize: str = "models"
    small_n_impl: str = "auto"
    tail_fuse_depth: int = 0
    scheduler: str = "continuous"
    max_inflight: int = 2
    persist_dir: Optional[str] = None
    factor_cache_bytes: int = 256 << 20

    def __post_init__(self):
        for name in ("buckets", "rows_buckets", "nrhs_buckets", "nblocks_buckets",
                     "block_buckets", "border_buckets"):
            ladder = getattr(self, name)
            if (not isinstance(ladder, tuple) or not ladder
                    or not all(isinstance(v, int) and v >= 1 for v in ladder)):
                raise ValueError(
                    f"{name} must be a non-empty tuple of positive ints, got {ladder!r}"
                )
        if not isinstance(self.max_batch, int) or self.max_batch < 1:
            raise ValueError(f"max_batch must be an int >= 1, got {self.max_batch!r}")
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {self.precision!r}")
        if self.small_n_impl not in batched_small.IMPLS:
            raise ValueError(
                f"unknown small_n_impl {self.small_n_impl!r}: expected one "
                f"of {batched_small.IMPLS}"
            )
        if self.blocktri_impl not in blocktri.ALGORITHMS:
            raise ValueError(
                f"unknown blocktri_impl {self.blocktri_impl!r}: expected one of "
                f"{blocktri.ALGORITHMS}"
            )
        if not isinstance(self.blocktri_partitions, int) or self.blocktri_partitions < 0:
            raise ValueError(f"blocktri_partitions must be >= 0, got {self.blocktri_partitions!r}")


def _dtype_name(dtype) -> str:
    """'float32'-style name of a torch, numpy or named dtype."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


class SolveEngine:
    """See module docstring.  One engine per (grid, ServeConfig); not
    thread-safe (a single dispatch loop owns it)."""

    def __init__(self, grid: Optional[Grid] = None,
                 cfg: ServeConfig = ServeConfig(), *,
                 validate: bool = False):
        if cfg.oversize not in ("models", "reject"):
            raise ValueError(f"unknown oversize policy {cfg.oversize!r}")
        if cfg.small_n_impl not in batched_small.IMPLS:
            raise ValueError(
                f"unknown small_n_impl {cfg.small_n_impl!r}: expected one "
                f"of {batched_small.IMPLS}"
            )
        if cfg.blocktri_impl not in blocktri.ALGORITHMS:
            raise ValueError(
                f"unknown blocktri_impl {cfg.blocktri_impl!r}: expected "
                f"one of {blocktri.ALGORITHMS}"
            )
        if cfg.blocktri_partitions < 0:
            raise ValueError(
                f"blocktri_partitions must be >= 0, got "
                f"{cfg.blocktri_partitions}"
            )
        if cfg.scheduler not in SCHEDULERS:
            raise ValueError(
                f"unknown scheduler {cfg.scheduler!r}: expected one of "
                f"{SCHEDULERS}"
            )
        if cfg.max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got "
                             f"{cfg.max_inflight}")
        if cfg.persist_dir is not None:
            raise NotImplementedError(
                f"ServeConfig.persist_dir: the persistent program tier is not "
                f"ported yet (ROADMAP {PERSIST_ITEM})")
        self.grid = grid or Grid.square()  # guarded-by: <frozen>
        self.cfg = cfg  # guarded-by: <frozen>
        # validate: check every declared donation at cache insert (the
        # primary output must live in the donated input's buffer)
        self.validate = validate  # guarded-by: <frozen>
        self.stats = stats.Collector()  # guarded-by: <owner-thread>
        self.cache = ExecutableCache()  # guarded-by: <owner-thread>
        self.executor = Executor(cfg, self.grid, self.stats)  # guarded-by: <owner-thread>
        self.scheduler = Scheduler(cfg, self.executor, self._resolve_bucket)  # guarded-by: <owner-thread>
        # per-request span traces (obs/spans.py): every submit() starts a
        # RequestTrace, stamped host-side as the request moves
        self.trace_log = spans.TraceLog()  # guarded-by: <owner-thread>
        self.telemetry = None  # guarded-by: <owner-thread>
        self._next_id = 0  # guarded-by: <owner-thread>
        # config hash: everything that changes the built programs or the
        # padding geometry — two engines differing here never share cache
        # entries.  scheduler / max_inflight / persist_dir are absent: they
        # change when and where programs run, never what was built.
        ident = repr((cfg.buckets, cfg.rows_buckets, cfg.nrhs_buckets,
                      cfg.nblocks_buckets, cfg.block_buckets,
                      cfg.border_buckets,
                      cfg.max_batch, cfg.precision, cfg.robust,
                      cfg.small_n_impl, cfg.tail_fuse_depth,
                      cfg.blocktri_impl, cfg.blocktri_partitions))
        self._cfg_hash = hashlib.sha1(ident.encode()).hexdigest()[:12]  # guarded-by: <frozen>
        self._grid_key = (self.grid.dx, self.grid.dy, self.grid.c,  # guarded-by: <frozen>
                          self.grid.platform)

    # ---- cache -------------------------------------------------------------

    def _small_route(self, bucket: batching.Bucket) -> bool:
        """Whether this bucket's program runs the batched kernels
        (program.small_route on the grid's side of the envelope question,
        as api._host_side asks it) — the stats collector's small split."""
        return program.small_route(bucket, self.cfg,
                                   interpret=self.grid.device.type != "cuda")

    def _blocktri_algorithm(self, nblocks: int, dtype) -> str:
        """Which chain algorithm a chain bucket program runs ('scan' or
        'partitioned'), for the stats collector's impl split."""
        return program.blocktri_algorithm(nblocks, dtype, self.cfg)

    def _resolve_bucket(self, bucket: batching.Bucket) -> tuple:
        """The scheduler's get_exe callback: (program, small_route)."""
        return self._get_batched(bucket), self._small_route(bucket)

    def _get_batched(self, bucket: batching.Bucket, warmup: bool = False):
        key = ("batch", bucket.key, self._grid_key, self._cfg_hash)
        dn = self.executor.donate_argnums(bucket)

        def build():
            fn = api.batched(bucket.op, self.cfg.precision,
                             self.cfg.small_n_impl,
                             blocktri_impl=self.cfg.blocktri_impl,
                             blocktri_partitions=self.cfg.blocktri_partitions,
                             tier=bucket.tier)
            capture = (self.grid.device.type == "cuda"
                       and program.capturable(bucket, self.cfg))
            prog = program.Program(fn, bucket, self.grid.device,
                                   capture=capture, donate_argnums=dn)
            if self.validate and dn:
                probs = prog.check_donation()
                if probs:
                    raise AssertionError(
                        "donation dropped at cache insert: " + "; ".join(probs))
            return prog

        return self.cache.get(key, build, warmup=warmup)

    def _get_single(self, op: str, a_shape, b_shape, dtype: str,
                    warmup: bool = False):
        """The oversize single route's callable, built once per exact
        shape (never captured: the models' host loops run eagerly)."""
        key = ("single", op, dtype, tuple(a_shape),
               tuple(b_shape) if b_shape is not None else None,
               self._grid_key, self._cfg_hash)

        def build():
            return api.single(op, self.grid, self.cfg.precision,
                              self.cfg.robust,
                              tail_fuse_depth=self.cfg.tail_fuse_depth)

        return self.cache.get(key, build, warmup=warmup)

    def cache_stats(self) -> dict:
        """Hit/miss counters over request-driven program lookups plus the
        build counters (serve/cache.py).  warmup() builds count
        separately: hit_rate measures steady-state traffic."""
        return self.cache.stats()

    def warmup(self, specs) -> int:
        """Build the programs for example request shapes.  `specs` is an
        iterable of (op, a_shape, b_shape, dtype) or (op, a_shape, b_shape,
        dtype, accuracy_tier) — b_shape None for inv, tier defaulting to
        'balanced'.  Shapes resolve through the same bucket ladder as
        submit(); oversize shapes warm their exact-shape single route.
        Returns the number of fresh builds."""
        before = self.cache.warmup_compiles
        for op, a_shape, b_shape, dtype, *rest in specs:
            tier = rest[0] if rest else "balanced"
            dt = _dtype_name(dtype)
            bucket = batching.bucket_for(
                op, tuple(a_shape), tuple(b_shape) if b_shape else None,
                dt, self.cfg, tier=tier,
            )
            if bucket is not None:
                self._get_batched(bucket, warmup=True)
            elif self.cfg.oversize == "models":
                self._get_single(op, a_shape, b_shape if b_shape else None, dt,
                                 warmup=True)
        return self.cache.warmup_compiles - before

    # ---- request path ------------------------------------------------------

    def submit(self, op: str, A, B=None, *,
               factor_token: Optional[str] = None,
               accuracy_tier: str = "balanced",
               deadline_ms: Optional[float] = None) -> Ticket:
        """Enqueue one solve request; returns a Ticket that resolves when
        its batch lands.  A capacity-full bucket dispatches inside this
        call; under the continuous scheduler the dispatch is issued
        without waiting (the ticket is `done`, and `result()`/`pump()`/
        `drain()` land it).  A and B are tensors or arrays; they go to the
        grid's device here.

        `accuracy_tier` ('balanced', 'fast', 'guaranteed'; posv, lstsq,
        posv_blocktri only) picks the tiered program: 'fast' factors one
        dtype down, 'guaranteed' refines back to the request dtype's
        backward error and fails the request loudly if it does not
        converge.  `deadline_ms` stamps the request's trace (slack at
        dispatch, violation attribution); it never changes scheduling.
        `factor_token` and the residency and session ops are not ported
        yet (NotImplementedError naming the ROADMAP item)."""
        t_enq = time.monotonic()
        tid = self._next_id
        self._next_id += 1
        ticket = Ticket(tid, t_enq)
        ticket.deadline_ms = (float(deadline_ms)
                              if deadline_ms is not None else None)
        if A is None and op != "session_close":
            raise ValueError(f"{op} requires an A operand")
        if op not in batching.OPS and op not in batching.SESSION_OPS:
            raise ValueError(
                f"unknown serve op {op!r}; expected one of "
                f"{batching.OPS + batching.SESSION_OPS}"
            )
        if accuracy_tier != "balanced" and op not in api.TIER_OPS:
            raise ValueError(
                f"accuracy_tier={accuracy_tier!r} is only defined for "
                f"{api.TIER_OPS}, got op {op!r}"
            )
        batching.check_op(op)  # the residency and session ops raise here
        if factor_token is not None:
            raise NotImplementedError(
                f"factor_token= is not ported yet (ROADMAP {batching.RESIDENCY_ITEM})")
        A = torch.as_tensor(A, device=self.grid.device)
        B = torch.as_tensor(B, device=self.grid.device) if B is not None else None
        if op == "posv_blocktri":
            if (A.ndim != 4 or A.shape[0] != 2
                    or A.shape[2] != A.shape[3]):
                raise ValueError(
                    f"posv_blocktri needs A = (2, nblocks, b, b) — "
                    f"[diagonal blocks, sub-diagonal blocks] — got "
                    f"{tuple(A.shape)}"
                )
            if B is None or B.ndim != 3 or B.shape[:2] != A.shape[1:3]:
                raise ValueError(
                    f"posv_blocktri needs B = (nblocks, b, nrhs) riding "
                    f"A {tuple(A.shape)}, got {None if B is None else tuple(B.shape)}"
                )
        if op == "posv_arrowhead":
            if (A.ndim != 4 or A.shape[0] != 2
                    or A.shape[2] != A.shape[3]):
                raise ValueError(
                    f"posv_arrowhead needs A = (2, nblocks, b, b) — "
                    f"[diagonal blocks, sub-diagonal blocks], the "
                    f"posv_blocktri chain pack — got {tuple(A.shape)}"
                )
            n_t = A.shape[1] * A.shape[2]
            if (B is None or B.ndim != 2 or B.shape[0] <= n_t
                    or B.shape[1] <= B.shape[0] - n_t):
                raise ValueError(
                    f"posv_arrowhead needs the packed tail B = "
                    f"(nblocks·b + s, s + nrhs) with s >= 1, nrhs >= 1 "
                    f"(models/arrowhead.pack) riding A {tuple(A.shape)} "
                    f"(nblocks·b = {n_t}), got "
                    f"{None if B is None else tuple(B.shape)}"
                )
        if op in ("posv", "lstsq") and (B is None or B.ndim != 2
                                        or B.shape[0] != A.shape[0]):
            raise ValueError(
                f"{op} needs a 2D RHS with {A.shape[0]} rows, got "
                f"{None if B is None else tuple(B.shape)}"
            )
        if op in ("posv", "inv") and A.shape[0] != A.shape[1]:
            raise ValueError(f"{op} needs a square SPD operand, got {tuple(A.shape)}")
        if op == "lstsq" and A.shape[0] < A.shape[1]:
            raise ValueError(f"lstsq expects tall input, got {tuple(A.shape)}")
        # the trace starts after the raise-validation above: a rejected
        # call never entered the serve path
        self._start_trace(ticket, op, accuracy_tier)
        try:
            # host-side per-request fault tap on the concrete operand: a
            # fault corrupts exactly one request, never a cached program
            A = faultinject.tap(A, point="serve::ingest")
        except faultinject.FaultInjected as e:
            self.executor.fail(ticket, op, str(e), t_enq)
            return ticket
        dt = _dtype_name(A.dtype)
        bucket = batching.bucket_for(
            op, tuple(A.shape), tuple(B.shape) if B is not None else None,
            dt, self.cfg, tier=accuracy_tier,
        )
        if bucket is None and accuracy_tier != "balanced":
            # the oversize route has no tiered program: fail loud rather
            # than serve the request at another precision
            self.executor.fail(
                ticket, op,
                f"no bucket for {op} {tuple(A.shape)}: accuracy_tier="
                f"{accuracy_tier!r} requests have no oversize route",
                t_enq,
            )
            return ticket
        if op in ("posv_blocktri", "posv_arrowhead"):
            # the bucketed program follows the engine's algorithm knobs; the
            # oversize single route runs posv's own defaults (api.single)
            self.stats.note_blocktri_impl(
                self._blocktri_algorithm(bucket.a_shape[1], bucket.dtype)
                if bucket is not None
                else blocktri.posv_algorithm(A.shape[1], A.dtype))
        if bucket is None:
            if self.cfg.oversize == "reject":
                self.executor.fail(
                    ticket, op,
                    f"no bucket for {op} {tuple(A.shape)} and oversize='reject'",
                    t_enq,
                )
            else:
                self._run_single(ticket, op, A, B, t_enq)
            return ticket
        pa, pb = batching.pad_operands(op, A, B, bucket)
        if bucket.tier == "guaranteed":
            sink = self._refine_sink(op)
        elif op == "posv_arrowhead":
            sink = self._arrowhead_sink(tuple(A.shape), tuple(B.shape))
        else:
            sink = None
        self._admit(ticket, bucket, pa, pb, tuple(A.shape),
                    tuple(B.shape) if B is not None else None, t_enq,
                    sink=sink)
        return ticket

    def pump(self, now: Optional[float] = None) -> int:
        """Deadline flush + opportunistic landing: dispatch every bucket
        whose oldest request has aged past max_delay_s, and land every
        in-flight batch whose results are ready.  Returns the number of
        batches flushed."""
        now = time.monotonic() if now is None else now
        return self.scheduler.pump(now)

    def drain(self) -> int:
        """Flush every non-empty queue regardless of age and land every
        in-flight batch (shutdown / test barrier).  Returns the number of
        batches flushed."""
        return self.scheduler.drain()

    def solve(self, op: str, A, B=None, *,
              factor_token: Optional[str] = None,
              accuracy_tier: str = "balanced",
              deadline_ms: Optional[float] = None) -> Response:
        """Convenience synchronous path: submit + drain + result."""
        ticket = self.submit(op, A, B, factor_token=factor_token,
                             accuracy_tier=accuracy_tier,
                             deadline_ms=deadline_ms)
        if not ticket.done:
            self.drain()
        return ticket.result()

    def queue_depth(self) -> int:
        return self.scheduler.queue_depth()

    def emit_stats(self, path: Optional[str] = None, **extra) -> dict:
        """Snapshot telemetry + cache counters into one serve:request_stats
        ledger record (appended to `path` when given)."""
        return self.stats.emit(
            path, grid=self.grid, config=self.cfg,
            cache=self.cache_stats(), **extra,
        )

    def emit_trace(self, path: Optional[str] = None, *,
                   bubble_tol_ms: float = spans.DEFAULT_BUBBLE_TOL_MS,
                   **extra) -> dict:
        """Export the run's span chains as one serve:trace ledger record
        (appended to `path` when given)."""
        return self.trace_log.emit(
            path, grid=self.grid, config=self.cfg,
            bubble_tol_ms=bubble_tol_ms, **extra,
        )

    def enable_telemetry(self, window_s: float = 1.0, *, sample_cap: Optional[int] = None):
        """Rolling-window telemetry is not ported yet."""
        raise NotImplementedError(
            f"SolveEngine.enable_telemetry is not ported yet (ROADMAP {TELEMETRY_ITEM})")

    def install_factor(self, token: str, R):
        """Factor residency is not ported yet."""
        raise NotImplementedError(
            f"SolveEngine.install_factor is not ported yet (ROADMAP {batching.RESIDENCY_ITEM})")

    def release_factor(self, token: str):
        """Factor residency is not ported yet."""
        raise NotImplementedError(
            f"SolveEngine.release_factor is not ported yet (ROADMAP {batching.RESIDENCY_ITEM})")

    def factor_stats(self):
        """Factor residency is not ported yet."""
        raise NotImplementedError(
            f"SolveEngine.factor_stats is not ported yet (ROADMAP {batching.RESIDENCY_ITEM})")

    def _start_trace(self, ticket: Ticket, op: str,
                     tier: str) -> spans.RequestTrace:
        tr = self.trace_log.start(
            ticket.request_id, op, ticket.t_enq,
            deadline_ms=ticket.deadline_ms,
            tier=tier, cfg_hash=self._cfg_hash,
            replica_id=self.stats.replica_id,
        )
        ticket.trace = tr
        return tr

    # ---- internals ---------------------------------------------------------

    def _admit(self, ticket: Ticket, bucket: batching.Bucket, pa, pb,
               a_shape, b_shape, t_enq: float, client_op=None,
               sink=None) -> None:
        """Stage + enqueue one padded request."""
        if self.cfg.scheduler == "continuous":
            # staging ahead of dispatch: the copy overlaps whatever batch is
            # executing (a no-op when the operands already lie on the card)
            with tracing.scope("SV::stage"):
                pa = pa.to(self.grid.device, non_blocking=True)
                if pb is not None:
                    pb = pb.to(self.grid.device, non_blocking=True)
        if ticket.trace is not None:
            # admit covers validation + fault tap + pad + stage; stamped
            # before scheduler.admit because a capacity flush dispatches
            # inside it (the enqueue span must start here)
            ticket.trace.tag(bucket=batching.bucket_label(bucket),
                             tier=bucket.tier)
            ticket.trace.extend("admit")
        self.scheduler.admit(bucket, _Pending(
            ticket, pa, pb, a_shape, b_shape, t_enq,
            client_op=client_op, sink=sink,
        ))
        self.stats.note_queue_depth(self.queue_depth())

    def _arrowhead_sink(self, a_shape, b_shape):
        """Landing hook for posv_arrowhead: the 3-output bucket program
        (api._batched_arrowhead) lands the blocked chain half through
        batching.crop with the padded corner half in the extras slot;
        crop the corner and concatenate the flat (nblocks·b + s, nrhs)
        response — the layout the oversize single route returns."""
        nblocks, b = a_shape[1], a_shape[2]
        s = b_shape[0] - nblocks * b
        k = b_shape[1] - s

        def sink(x, extras, raw_info):
            flat = torch.cat(
                [x.reshape(nblocks * b, k), extras[0][:s, :k]], dim=0)
            return flat, raw_info, None

        return sink

    def _refine_sink(self, op: str):
        """Landing hook for accuracy_tier='guaranteed' buckets: the tiered
        program (api._batched_refine) lands (X, iters, converged, resid)
        per request.  Record the measured refinement cost into the stats
        and fail the request loudly when the refinement loop froze before
        reaching the correction dtype's backward-error tolerance."""

        def sink(x, extras, raw_info):
            it, conv, resid = (int(extras[0]), int(extras[1]),
                               float(extras[2]))
            self.stats.note_refine(it, bool(conv), resid)
            if not conv:
                return x, raw_info, (
                    f"accuracy_tier='guaranteed' {op} did not converge: "
                    f"refinement froze after {it} sweep(s) at backward "
                    f"error {resid:.3e} (stalled or diverging — the "
                    "operand is likely too ill-conditioned for the "
                    "factor dtype; resubmit at tier='balanced' in a "
                    "wider dtype)"
                )
            return x, raw_info, None

        return sink

    def _run_single(self, ticket: Ticket, op: str, A, B,
                    t_enq: float) -> None:
        tr = ticket.trace
        if tr is not None:
            # oversize singles never queue or batch: the chain collapses
            # to admit -> cache_lookup -> device -> respond
            tr.kind = "single"
            tr.extend("admit")
        exe = self._get_single(op, tuple(A.shape),
                               tuple(B.shape) if B is not None else None,
                               _dtype_name(A.dtype))
        if tr is not None:
            tr.extend("cache_lookup")
        self.executor.run_single(ticket, op, A, B, exe, t_enq)
