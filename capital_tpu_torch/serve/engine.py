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

Factor residency and streaming sessions (the reference's docs/SERVING.md
"Factor residency", "Streaming sessions"): `factor_token=` names a resident
factor in the engine's `FactorCache` (serve/factorcache.py).  chol_update /
chol_downdate ship only the rank-k panel V against it, posv_cached solves
against it (a miss refactors and installs), blocktri_extend appends chain
blocks from its carry, and the session ops (serve/sessions.py drives them)
open, append to, solve against, contract and close a resident chain.
Residency resolves host-side at submit, before padding: the bucket programs
never see a token, so residency changes never rebuild a program.  Every
case that cannot be served lands a loud failed Response, never a silent
wrong answer.

Rolling-window telemetry (`enable_telemetry`, serve/telemetry.py) rides
the stats collector; ``ServeConfig.persist_dir`` turns on the program
cache's persistent warm-up manifest (serve/cache.py): a warm-up on a warm
directory also builds every program an earlier engine of the same config
and fingerprint built there.

`SolveEngine(grid=None, cfg)` runs on the CUDA card (`Grid.square()`,
which raises without one); pass ``Grid.square(device="cpu")`` to run the
plain versions on the host.
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
from capital_tpu_torch.ops import batched_small, lapack
from capital_tpu_torch.parallel.topology import Grid
from capital_tpu_torch.robust import faultinject
from capital_tpu_torch.robust.config import RobustConfig, RobustInfo
from capital_tpu_torch.serve import api, batching, program, stats
from capital_tpu_torch.serve.cache import ExecutableCache, fingerprint
from capital_tpu_torch.serve.executor import Executor, Response, Ticket, _Pending
from capital_tpu_torch.serve.factorcache import FactorCache
from capital_tpu_torch.serve.scheduler import Scheduler
from capital_tpu_torch.utils import tracing

#: precision names the models accept (CholinvConfig.precision)
PRECISIONS = (None, "default", "high", "highest")

SCHEDULERS = ("continuous", "sync")

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
    donate, oversize, tail_fuse_depth, scheduler, max_inflight: engine knobs.
    persist_dir: the directory of the program cache's warm-up manifest
        (serve/cache.py), shareable by every engine on the card; None keeps
        the cache in memory only.
    factor_cache_bytes: byte budget of the resident-factor pool
        (serve/factorcache.py).  Not in the config hash: residency is
        runtime policy (which factors are remembered), the bucket programs
        are keyed by shape alone.
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
        self.grid = grid or Grid.square()  # guarded-by: <frozen>
        self.cfg = cfg  # guarded-by: <frozen>
        # validate: check every declared donation at cache insert (the
        # primary output must live in the donated input's buffer)
        self.validate = validate  # guarded-by: <frozen>
        self.stats = stats.Collector()  # guarded-by: <owner-thread>
        # host-side resident-factor pool: no program sees it, so residency
        # changes never rebuild one; its copies live on the grid's device
        self.factors = FactorCache(cfg.factor_cache_bytes, device=self.grid.device)  # guarded-by: <owner-thread>
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
        # change when and where programs run, never what was built, and
        # factor_cache_bytes is runtime residency policy.
        ident = repr((cfg.buckets, cfg.rows_buckets, cfg.nrhs_buckets,
                      cfg.nblocks_buckets, cfg.block_buckets,
                      cfg.border_buckets,
                      cfg.max_batch, cfg.precision, cfg.robust,
                      cfg.small_n_impl, cfg.tail_fuse_depth,
                      cfg.blocktri_impl, cfg.blocktri_partitions))
        self._cfg_hash = hashlib.sha1(ident.encode()).hexdigest()[:12]  # guarded-by: <frozen>
        self._grid_key = (self.grid.dx, self.grid.dy, self.grid.c,  # guarded-by: <frozen>
                          self.grid.platform)
        self.cache = ExecutableCache(  # guarded-by: <owner-thread>
            cfg.persist_dir, scope=repr((self._grid_key, self._cfg_hash)),
            fingerprint=fingerprint(self.grid.device) if cfg.persist_dir else None)

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

        spec = {"kind": "batch", "bucket": list(bucket.key)}
        return self.cache.get(key, build, warmup=warmup, spec=spec)

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

        spec = {"kind": "single", "op": op, "dtype": dtype, "a_shape": list(a_shape),
                "b_shape": None if b_shape is None else list(b_shape)}
        return self.cache.get(key, build, warmup=warmup, spec=spec)

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
        With ``persist_dir`` it then builds every program the warm-up
        manifest holds for this engine's config and fingerprint (an earlier
        engine's, or a peer replica's).  Returns the number of builds the
        manifest did not foresee."""
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
        for spec in self.cache.foreseen_specs():
            if spec["kind"] == "batch":
                op, dt, a_shape, b_shape, capacity, tier = spec["bucket"]
                self._get_batched(batching.Bucket(
                    op, dt, tuple(a_shape), None if b_shape is None else tuple(b_shape),
                    capacity, tier), warmup=True)
            elif self.cfg.oversize == "models":
                b_shape = spec["b_shape"]
                self._get_single(spec["op"], tuple(spec["a_shape"]),
                                 None if b_shape is None else tuple(b_shape),
                                 spec["dtype"], warmup=True)
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

        `factor_token` names a resident factor (module docstring):
        chol_update / chol_downdate submit only the rank-k panel A = V
        (n, k); posv_cached submits the full (A, B) so a miss can seed the
        factor; blocktri_extend submits the appended chain pack A = (2,
        nblocks, b, b) — a never-seen token seeds a fresh chain, an evicted
        one fails loudly.  The session ops take the session id."""
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
        A = torch.as_tensor(A, device=self.grid.device) if A is not None else None
        B = torch.as_tensor(B, device=self.grid.device) if B is not None else None
        if op in batching.SESSION_OPS:
            if factor_token is None:
                raise ValueError(
                    f"{op} requires factor_token= (the session id — "
                    "docs/SERVING.md 'Streaming sessions')"
                )
            return self._submit_session(ticket, op, A, B, str(factor_token),
                                        accuracy_tier, t_enq)
        if op in batching.FACTOR_OPS:
            if factor_token is None:
                raise ValueError(
                    f"{op} requires factor_token= (docs/SERVING.md "
                    "'Factor residency')"
                )
            return self._submit_factor(ticket, op, A, B, str(factor_token), t_enq)
        if factor_token is not None:
            raise ValueError(
                f"factor_token is only valid for {batching.FACTOR_OPS}, "
                f"got op {op!r}"
            )
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
            cache=self.cache_stats(), factor_cache=self.factors.stats(),
            **extra,
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
        """Attach a rolling-window aggregator (serve/telemetry.py) to the
        stats tap: every request / batch / queue-depth note also lands in
        the current time window, and `self.telemetry.emit(path)` appends
        one serve:window record per closed window.  Host-side counters
        only — never part of the config hash, never a program's concern.
        Returns the aggregator."""
        from capital_tpu_torch.serve import telemetry

        kw = {} if sample_cap is None else {"sample_cap": sample_cap}
        self.telemetry = telemetry.WindowAggregator(window_s, **kw)
        self.stats.window = self.telemetry
        return self.telemetry

    # ---- factor residency ----------------------------------------------------

    def install_factor(self, token: str, R) -> list[str]:
        """Out-of-band seeding: install an upper-triangular R (A = RᵀR, the
        lapack.potrf uplo='U' convention) as the resident dense factor for
        `token` (a copy on the grid's device: later writes to R do not
        reach it).  Returns the tokens the byte budget evicted."""
        R = torch.as_tensor(R)
        if R.ndim != 2 or R.shape[0] != R.shape[1]:
            raise ValueError(
                f"install_factor needs a square (n, n) factor, got {tuple(R.shape)}"
            )
        return self.factors.put(
            token, "dense", (R,),
            {"n": int(R.shape[0]), "dtype": _dtype_name(R.dtype)},
        )

    def release_factor(self, token: str) -> bool:
        """Explicit client drop of a resident factor (clears any eviction
        tombstone).  Returns whether an entry was resident."""
        return self.factors.release(token)

    def factor_stats(self) -> dict:
        """The FactorCache counter block, also emitted inside every
        serve:request_stats record once factor traffic exists."""
        return self.factors.stats()

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

    def _lose(self, ticket: Ticket, op: str, msg: str, t_enq: float) -> Ticket:
        """Land a request the residency protocol cannot serve as a loud
        failure (never a silent wrong answer)."""
        self.executor.fail(ticket, op, msg, t_enq)
        return ticket

    def _submit_factor(self, ticket: Ticket, op: str, A, B, token: str,
                       t_enq: float) -> Ticket:
        """The factor-residency submit path (the reference's, case for
        case).  Residency resolves here, host-side, before padding: an
        update / downdate against a non-resident token, any kind / shape /
        dtype mismatch with the resident entry, an extend against an
        evicted chain and any oversize shape land a loud failed Response."""
        if op in batching.UPDATE_OPS:
            if A.ndim != 2 or B is not None:
                raise ValueError(
                    f"{op} needs A = V (n, k), no B — the resident factor "
                    f"is the other operand; got A {tuple(A.shape)}"
                    + ("" if B is None else f", B {tuple(B.shape)}")
                )
        elif op == "posv_cached":
            if A.ndim != 2 or A.shape[0] != A.shape[1]:
                raise ValueError(
                    f"posv_cached needs a square SPD operand, got {tuple(A.shape)}"
                )
            if B is None or B.ndim != 2 or B.shape[0] != A.shape[0]:
                raise ValueError(
                    f"posv_cached needs a 2D RHS with {A.shape[0]} rows, "
                    f"got {None if B is None else tuple(B.shape)}"
                )
        else:  # blocktri_extend
            if A.ndim != 4 or A.shape[0] != 2 or A.shape[2] != A.shape[3]:
                raise ValueError(
                    f"blocktri_extend needs A = (2, nblocks, b, b) appended "
                    f"[diagonal, sub-diagonal] blocks, got {tuple(A.shape)}"
                )
            if B is not None:
                raise ValueError(
                    f"blocktri_extend takes no B (the resident carry is "
                    f"the second operand), got B {tuple(B.shape)}"
                )
        # traced only once past the raise-validation, as submit()
        self._start_trace(ticket, op, "balanced")
        try:
            # the per-request tap: a planted fault corrupts one request's
            # operand, never a cached program or a resident factor (the
            # sinks refuse to install flagged results)
            A = faultinject.tap(A, point="serve::ingest")
        except faultinject.FaultInjected as e:
            return self._lose(ticket, op, str(e), t_enq)
        dt = _dtype_name(A.dtype)
        ent = self.factors.lookup(token)

        def lose(msg: str) -> Ticket:
            return self._lose(ticket, op, msg + " (docs/SERVING.md 'Factor residency')", t_enq)

        if op in batching.UPDATE_OPS:
            if ent is None:
                why = "evicted" if self.factors.evicted(token) else "never seeded"
                return lose(
                    f"factor_token {token!r} not resident ({why}): {op} "
                    "ships only the rank-k panel V, so there is nothing to "
                    "update — seed with posv_cached or install_factor()"
                )
            if ent.kind != "dense":
                return lose(f"factor_token {token!r} holds a {ent.kind} factor; {op} needs a dense one")
            R = ent.arrays[0]
            n = int(R.shape[0])
            if A.shape[0] != n or _dtype_name(R.dtype) != dt:
                return lose(
                    f"V {tuple(A.shape)}/{dt} does not ride the resident factor "
                    f"({n}, {n})/{_dtype_name(R.dtype)} under token {token!r}"
                )
            bucket = batching.bucket_for(op, (n, n), tuple(A.shape), dt, self.cfg)
            if bucket is None:
                return lose(f"no bucket for {op} n={n} k={A.shape[1]}: factor ops have no oversize route")
            pa, pb = batching.pad_operands(op, R, A, bucket)
            self._admit(ticket, bucket, pa, pb, (n, n), tuple(A.shape), t_enq,
                        client_op=op, sink=self._update_sink(op, token, n, A))
            return ticket

        if op == "posv_cached":
            n = int(A.shape[0])
            if ent is not None:
                if ent.kind != "dense":
                    return lose(
                        f"factor_token {token!r} holds a {ent.kind} factor; posv_cached needs a dense one")
                R = ent.arrays[0]
                if int(R.shape[0]) != n or _dtype_name(R.dtype) != dt:
                    return lose(
                        f"operand {tuple(A.shape)}/{dt} does not match the resident factor "
                        f"{tuple(R.shape)}/{_dtype_name(R.dtype)} under token {token!r}"
                    )
                bucket = batching.bucket_for("posv_cached", (n, n), tuple(B.shape), dt, self.cfg)
                if bucket is None:
                    return lose(f"no bucket for posv_cached n={n} nrhs={B.shape[1]}: factor ops have "
                                "no oversize route")
                pa, pb = batching.pad_operands("posv_cached", R, B, bucket)
                self._admit(ticket, bucket, pa, pb, (n, n), tuple(B.shape), t_enq,
                            client_op="posv_cached")
                return ticket
            # miss: seed by refactoring through the 3-output miss program
            # (X, R, info); the full operand is on the wire, so re-seeding
            # is safe even for an evicted token
            bucket = batching.bucket_for("posv_cached_miss", tuple(A.shape), tuple(B.shape), dt, self.cfg)
            if bucket is None:
                return lose(f"no bucket for posv_cached n={n} nrhs={B.shape[1]}: factor ops have no "
                            "oversize route")
            pa, pb = batching.pad_operands("posv_cached_miss", A, B, bucket)
            self._admit(ticket, bucket, pa, pb, tuple(A.shape), tuple(B.shape), t_enq,
                        client_op="posv_cached", sink=self._seed_sink(token, n))
            return ticket

        # blocktri_extend
        nblocks, b = int(A.shape[1]), int(A.shape[2])
        if ent is not None:
            if ent.kind != "blocktri":
                return lose(f"factor_token {token!r} holds a {ent.kind} factor; blocktri_extend needs a "
                            "blocktri chain")
            if int(ent.meta["b"]) != b or ent.meta["dtype"] != dt:
                return lose(
                    f"appended blocks {tuple(A.shape)}/{dt} do not ride the resident chain "
                    f"b={ent.meta['b']}/{ent.meta['dtype']} under token {token!r}"
                )
            carry = ent.arrays[2]
            prior = int(ent.meta["nblocks"])
        else:
            if self.factors.evicted(token):
                return lose(
                    f"factor_token {token!r} was EVICTED: extending a "
                    "silently re-seeded identity chain would be a wrong "
                    "answer — resubmit the full chain under a fresh token"
                )
            # fresh chain: identity carry and a zeroed first coupling run
            # the same program as a continuation (the client's A is kept)
            carry = torch.eye(b, dtype=A.dtype, device=A.device)
            A = A.clone()
            A[1, 0] = 0
            prior = 0
        bucket = batching.bucket_for("blocktri_extend", tuple(A.shape), (b, b), dt, self.cfg)
        if bucket is None:
            return lose(f"no bucket for blocktri_extend nblocks={nblocks} b={b}: factor ops have no "
                        "oversize route")
        pa, pb = batching.pad_operands("blocktri_extend", A, carry, bucket)
        self._admit(ticket, bucket, pa, pb, tuple(A.shape), (b, b), t_enq,
                    client_op="blocktri_extend", sink=self._extend_sink(token, b, prior))
        return ticket

    def _submit_session(self, ticket: Ticket, op: str, A, B, token: str,
                        tier: str, t_enq: float) -> Ticket:
        """The session protocol's submit path (serve/sessions.py drives
        it).  Wire shapes: session_open / session_append take the window
        blocks A = (2, nblocks, b, b) ([D; C]; C[:, 0] live for append,
        zeroed here for open) and no B; session_solve takes the current
        window A = (2, nblocks, b, b) and B = (nblocks, b, nrhs), and the
        engine stacks [D; C; L; Wt] on the grid's device from the resident
        factor; session_contract takes A = k (a scalar: the oldest blocks
        to drop) and returns the new head diagonal factor block L_k (b, b);
        session_close takes no operands and returns a 0/1 released flag.

        A request against an evicted session fails with a
        ``SessionEvicted:`` error (re-seed with session_open, which clears
        the tombstone); one against a never-opened session fails as 'not
        open'.  Both are failed Responses, never silent identity answers."""
        if op in ("session_open", "session_append"):
            if A.ndim != 4 or A.shape[0] != 2 or A.shape[2] != A.shape[3]:
                raise ValueError(
                    f"{op} needs A = (2, nblocks, b, b) window blocks "
                    f"[diagonal, sub-diagonal], got {tuple(A.shape)}"
                )
            if B is not None:
                raise ValueError(f"{op} takes no B (the carry is resident), got B {tuple(B.shape)}")
        elif op == "session_solve":
            if A.ndim != 4 or A.shape[0] != 2 or A.shape[2] != A.shape[3]:
                raise ValueError(
                    f"session_solve needs A = (2, nblocks, b, b) — the "
                    f"session's current [D; C] window — got {tuple(A.shape)}"
                )
            if B is None or B.ndim != 3 or B.shape[:2] != A.shape[1:3]:
                raise ValueError(
                    f"session_solve needs B = (nblocks, b, nrhs) riding "
                    f"A {tuple(A.shape)}, got {None if B is None else tuple(B.shape)}"
                )
        elif op == "session_contract":
            if A.ndim != 0:
                raise ValueError(
                    f"session_contract needs a scalar A = k (blocks to drop), got shape {tuple(A.shape)}")
            if B is not None:
                raise ValueError("session_contract takes no B")
        else:  # session_close
            if A is not None or B is not None:
                raise ValueError("session_close takes no operands")
        self._start_trace(ticket, op, tier)

        def lose(msg: str) -> Ticket:
            return self._lose(ticket, op, msg + " (docs/SERVING.md 'Streaming sessions')", t_enq)

        def lose_missing() -> Ticket:
            if self.factors.evicted(token):
                return lose(
                    f"SessionEvicted: session {token!r} lost its resident "
                    "factor to cache pressure — re-seed the window with "
                    "session_open"
                )
            return lose(f"session {token!r} is not open")

        # host-side administrative ops: no program runs; the span chain is
        # admit -> cache_lookup -> respond under the 'session' trace kind
        if op == "session_close":
            if ticket.trace is not None:
                ticket.trace.kind = "session"
                ticket.trace.extend("admit")
            released = self.factors.release(token)
            if ticket.trace is not None:
                ticket.trace.extend("cache_lookup")
            flag = torch.tensor(1 if released else 0, dtype=torch.int32, device=self.grid.device)
            return self._finish_host(ticket, op, flag, t_enq)
        if op == "session_contract":
            if ticket.trace is not None:
                ticket.trace.kind = "session"
                ticket.trace.extend("admit")
            ent = self.factors.lookup(token)
            if ticket.trace is not None:
                ticket.trace.extend("cache_lookup")
            if ent is None:
                return lose_missing()
            if ent.kind != "session":
                return lose(f"factor_token {token!r} holds a {ent.kind} factor; session ops need a "
                            "session chain")
            k = int(A)
            nblocks = int(ent.meta["nblocks"])
            if not 0 < k < nblocks:
                return lose(
                    f"session_contract k={k} must satisfy 0 < k < "
                    f"nblocks={nblocks} (contracting the whole chain is "
                    "session_close)"
                )
            Lc, Wtc = blocktri.contract(ent.arrays[0][None], ent.arrays[1][None], k)
            self.factors.put(
                token, "session", (Lc[0], Wtc[0], ent.arrays[2]),
                {"b": int(ent.meta["b"]), "nblocks": nblocks - k,
                 "dtype": ent.meta["dtype"],
                 "dropped": int(ent.meta.get("dropped", 0)) + k},
            )
            # the new head diagonal factor block: what the client needs to
            # marginalize its window head (D[0] <- L_k·L_kᵀ)
            return self._finish_host(ticket, op, Lc[0, 0].clone(), t_enq)

        try:
            A = faultinject.tap(A, point="serve::ingest")
        except faultinject.FaultInjected as e:
            return self._lose(ticket, op, str(e), t_enq)
        dt = _dtype_name(A.dtype)

        if op == "session_open":
            nblocks, b = int(A.shape[1]), int(A.shape[2])
            # open is the re-seed path: drop any prior incarnation and
            # clear an eviction tombstone
            self.factors.release(token)
            carry = torch.eye(b, dtype=A.dtype, device=A.device)
            A = A.clone()
            A[1, 0] = 0
            bucket = batching.bucket_for("session_extend", tuple(A.shape), (b, b), dt, self.cfg)
            if bucket is None:
                return lose(f"no bucket for session window nblocks={nblocks} b={b}: session ops have "
                            "no oversize route")
            pa, pb = batching.pad_operands("session_extend", A, carry, bucket)
            self._admit(ticket, bucket, pa, pb, tuple(A.shape), (b, b), t_enq,
                        client_op="session_open", sink=self._session_extend_sink(op, token, b))
            return ticket

        ent = self.factors.lookup(token)
        if ent is None:
            return lose_missing()
        if ent.kind != "session":
            return lose(f"factor_token {token!r} holds a {ent.kind} factor; session ops need a session "
                        "chain")
        if int(ent.meta["b"]) != int(A.shape[2]) or ent.meta["dtype"] != dt:
            return lose(
                f"operand {tuple(A.shape)}/{dt} does not ride the resident "
                f"session chain b={ent.meta['b']}/{ent.meta['dtype']} "
                f"under token {token!r}"
            )

        if op == "session_append":
            nblocks, b = int(A.shape[1]), int(A.shape[2])
            bucket = batching.bucket_for("session_extend", tuple(A.shape), (b, b), dt, self.cfg)
            if bucket is None:
                return lose(f"no bucket for session append nblocks={nblocks} b={b}: session ops have "
                            "no oversize route")
            pa, pb = batching.pad_operands("session_extend", A, ent.arrays[2], bucket)
            self._admit(ticket, bucket, pa, pb, tuple(A.shape), (b, b), t_enq,
                        client_op="session_append", sink=self._session_extend_sink(op, token, b))
            return ticket

        # session_solve
        nblocks, b = int(A.shape[1]), int(A.shape[2])
        if int(ent.meta["nblocks"]) != nblocks:
            return lose(
                f"session_solve window has {nblocks} blocks but the "
                f"resident chain under {token!r} has "
                f"{ent.meta['nblocks']} — the client window is out of "
                "sync (append/contract landed without updating it?)"
            )
        A4 = torch.stack([A[0], A[1], ent.arrays[0], ent.arrays[1]])
        bucket = batching.bucket_for("session_solve", tuple(A4.shape), tuple(B.shape), dt, self.cfg,
                                     tier=tier)
        if bucket is None:
            return lose(f"no bucket for session_solve nblocks={nblocks} b={b} nrhs={B.shape[2]}: "
                        "session ops have no oversize route")
        pa, pb = batching.pad_operands("session_solve", A4, B, bucket)
        sink = self._refine_sink("session_solve") if bucket.tier == "guaranteed" else None
        self._admit(ticket, bucket, pa, pb, tuple(A4.shape), tuple(B.shape), t_enq,
                    client_op="session_solve", sink=sink)
        return ticket

    def _finish_host(self, ticket: Ticket, op: str, x, t_enq: float) -> Ticket:
        """Land a host-side session op (contract / close): no dispatch
        happened, so the latency has no queue-wait / device split."""
        t_land = time.monotonic()
        ticket.response = Response(
            request_id=ticket.request_id, op=op, ok=True, x=x, info=None,
            error=None, bucket=None, batched=False, latency_s=t_land - t_enq,
        )
        if ticket.trace is not None:
            ticket.trace.extend("respond")
            ticket.response.trace = ticket.trace
        self.stats.record_request(op, t_land - t_enq, ok=True)
        return ticket

    def _session_extend_sink(self, op: str, token: str, b: int):
        """Landing hook for session_open / session_append: install (open)
        or concatenate (append) the landed (L, Wt) and roll the carry.
        Sessions are stateful, so a flagged extend fails the request
        loudly even under robust=None, and a chain evicted between dispatch
        and landing fails it as SessionEvicted (installing the suffix alone
        would re-seed a truncated chain)."""

        def sink(x, extras, raw_info):
            i = int(raw_info)
            if i != 0:
                return x, raw_info, (
                    f"{op} flagged breakdown (info={i}, segment-relative "
                    "to the submitted window blocks): the window is not "
                    f"SPD-consistent; resident session chain {token!r} "
                    "left unchanged" + (
                        " (open failed — the session is closed)"
                        if op == "session_open" else "")
                )
            L, Wt = x[0], x[1]
            dropped, nblocks = 0, int(L.shape[0])
            ent = self.factors.peek(token)
            if ent is None and op != "session_open" and self.factors.evicted(token):
                return x, raw_info, (
                    f"SessionEvicted: resident chain {token!r} was evicted "
                    f"mid-flight (before this {op} landed); the suffix was "
                    "NOT installed — reopen the session and replay"
                )
            if ent is not None and ent.kind == "session":
                nblocks += int(ent.arrays[0].shape[0])
                dropped = int(ent.meta.get("dropped", 0))
            self.factors.append_blocks(
                token, "session", L, Wt,
                {"b": b, "nblocks": nblocks,
                 "dtype": _dtype_name(L.dtype), "dropped": dropped},
            )
            return x, raw_info, None

        return sink

    def _update_sink(self, op: str, token: str, n: int, V):
        """Landing hook for chol_update / chol_downdate: install R' on a
        clean info, refuse to install on breakdown.  A flagged downdate
        degrades to a fresh refactor S = RᵀR − VVᵀ from the still-resident
        old factor (put() runs only on success, and the resident R is never
        the donated batch buffer: the batch is a stacked copy); only if that
        also fails does the request fail loudly."""

        def sink(x, extras, raw_info):
            i = int(raw_info)
            if i == 0:
                self.factors.put(token, "dense", (x,), {"n": n, "dtype": _dtype_name(x.dtype)})
                return x, raw_info, None
            if op == "chol_update":
                # a rank-k update of an SPD matrix cannot break down in
                # exact arithmetic: a flag means a poisoned operand
                return x, raw_info, (
                    f"chol_update flagged breakdown (info={i}) — operand "
                    f"is not finite-SPD-consistent; resident factor "
                    f"{token!r} left unchanged"
                )
            ent = self.factors.peek(token)
            if ent is None:
                return x, raw_info, (
                    f"chol_downdate breakdown (info={i}) and token "
                    f"{token!r} was released/evicted mid-flight: no "
                    "resident state to degrade from"
                )
            self.factors.note_downdate_degrade()
            fn = self._get_degrade(n, int(V.shape[1]), _dtype_name(V.dtype))
            R2, info2 = fn(ent.arrays[0], V)
            if int(info2) == 0:
                self.factors.put(token, "dense", (R2,), {"n": n, "dtype": _dtype_name(R2.dtype)})
                return R2, RobustInfo(info=0, breakdown=1, shifted=0, sigma=0.0,
                                      escalated=1, ortho=-1.0), None
            return x, raw_info, (
                f"chol_downdate breakdown (info={i}) and the degrade "
                f"refactor ALSO failed (potrf info={int(info2)}): "
                "A − VVᵀ is not positive definite — resident factor "
                f"{token!r} left at its pre-downdate state"
            )

        return sink

    def _seed_sink(self, token: str, n: int):
        """Landing hook for the posv_cached miss program: install the
        refactored R (cropped from its padded batch slot) on a clean info
        only — a flagged refactor never becomes resident truth."""

        def sink(x, extras, raw_info):
            if int(raw_info) == 0:
                R = extras[0][:n, :n]
                self.factors.put(token, "dense", (R,), {"n": n, "dtype": _dtype_name(R.dtype)})
            return x, raw_info, None

        return sink

    def _extend_sink(self, token: str, b: int, prior: int):
        """Landing hook for blocktri_extend: append the new (L, Wt) blocks
        to the resident chain and roll the carry.  A flagged extend
        installs nothing (the prefix stays valid; the landed info is
        segment-relative); a prefix evicted between dispatch and landing
        fails the extend loudly."""

        def sink(x, extras, raw_info):
            if int(raw_info) != 0:
                return x, raw_info, None
            L, Wt = x[0], x[1]
            ent = self.factors.peek(token)
            if ent is None and prior > 0 and self.factors.evicted(token):
                return x, raw_info, (
                    f"resident blocktri chain {token!r} was evicted "
                    "mid-flight (before this extend landed); the suffix "
                    "was NOT installed — re-factor the full chain"
                )
            nblocks = int(L.shape[0])
            if ent is not None and ent.kind == "blocktri":
                nblocks += int(ent.arrays[0].shape[0])
            self.factors.append_blocks(
                token, "blocktri", L, Wt,
                {"b": b, "nblocks": nblocks, "dtype": _dtype_name(L.dtype)},
            )
            return x, raw_info, None

        return sink

    def _get_degrade(self, n: int, k: int, dtype: str):
        """The downdate-degrade program: refactor S = RᵀR − VVᵀ from
        scratch (lapack.potrf upper, with info).  Built once per shape like
        the oversize single route, and counted as a warm-up build: an
        exceptional path's build must not read as a steady-state rebuild."""
        key = ("degrade", n, k, dtype, self._grid_key, self._cfg_hash)

        def build():
            def fn(R, V):
                with tracing.scope("UP::downdate"):
                    S = R.mT @ R - V @ V.mT
                    return lapack.potrf(S, uplo="U", with_info=True)

            return fn

        return self.cache.get(key, build, warmup=True)

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
