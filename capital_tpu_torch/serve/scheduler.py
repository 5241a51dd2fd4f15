"""Continuous-batching admission: in-flight bucket batches, overlapped
dispatch, deadline flushes (counterpart of capital_tpu/serve/scheduler.py,
the whole module).

The continuous scheduler (``ServeConfig.scheduler="continuous"``):

* **admission into in-flight batches** — `admit()` queues per bucket; a
  capacity-full bucket dispatches immediately, but `flush()` returns as
  soon as the program call is issued (its kernels, or its CUDA graph's
  replay, queued on the stream) — the batch goes onto the in-flight deque
  instead of blocking the host;
* **overlapping dispatch of consecutive buckets** — while batch k
  executes, the host stages, pads and dispatches batch k+1; there is no
  synchronization between flushes;
* **bounded in-flight depth** — at most `max_inflight` unlanded batches;
  beyond that the oldest is landed first, so device queueing and
  batch-buffer memory stay bounded under a submit storm;
* **opportunistic landing** — `pump()` lands any in-flight batch whose
  event reports complete (`torch.cuda.Event.query`, non-blocking) in
  addition to running deadline flushes.

``scheduler="sync"`` is the stop-and-go loop (dispatch + immediate land,
no staging, no in-flight window), kept as the A/B baseline.

This module owns no programs and no padding: the engine resolves the
bucket program via its cache (`get_exe` callback) and pads/stages at
submit; the executor dispatches and lands.  Single-problem (oversize)
requests never enter the scheduler.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable

from capital_tpu_torch.serve import batching
from capital_tpu_torch.serve.executor import Executor, InFlight, _Pending


class Scheduler:
    """Per-bucket queues + the in-flight window.  `get_exe(bucket)`
    returns ``(executable, small_route)`` — the engine's cache lookup."""

    def __init__(self, cfg, executor: Executor,
                 get_exe: Callable[[batching.Bucket], tuple]):
        self.cfg = cfg  # guarded-by: <frozen>
        self.executor = executor  # guarded-by: <frozen>
        self._get_exe = get_exe  # guarded-by: <frozen>
        self._queues: dict[batching.Bucket, list[_Pending]] = {}  # guarded-by: <owner-thread>
        self._inflight: deque[InFlight] = deque()  # guarded-by: <owner-thread>

    # ---- admission ---------------------------------------------------------

    def admit(self, bucket: batching.Bucket, p: _Pending) -> None:
        """Queue one padded request; dispatch the bucket when it reaches
        capacity (the capacity-flush path — inside submit())."""
        q = self._queues.setdefault(bucket, [])
        q.append(p)
        if len(q) >= bucket.capacity:
            self.flush(bucket)

    def queue_depth(self) -> int:
        return sum(len(q) for q in self._queues.values())

    @property
    def inflight_depth(self) -> int:
        return sum(1 for fl in self._inflight if not fl.landed)

    # ---- dispatch ----------------------------------------------------------

    def flush(self, bucket: batching.Bucket) -> bool:
        """Dispatch one bucket's queue.  Continuous: issue and return
        (results land later); sync: land before returning (the stop-and-go
        behavior).  Returns True when a batch was dispatched."""
        q = self._queues.pop(bucket, [])
        if not q:
            return False
        t_form = time.monotonic()
        exe, small = self._get_exe(bucket)
        t_exe = time.monotonic()
        for p in q:
            if p.ticket.trace is not None:
                # enqueue = parked in the bucket queue until this flush;
                # cache_lookup = executable resolution (a compile lands
                # its full cost HERE — the attribution the zero-recompile
                # gates key on)
                p.ticket.trace.extend("enqueue", t_form)
                p.ticket.trace.extend("cache_lookup", t_exe)
        fl = self.executor.dispatch(bucket, exe, q, small)
        if self.cfg.scheduler == "sync":
            self.executor.land(fl)
            return True
        for p in q:
            p.ticket._entry = fl
            p.ticket._land = self.land
        self._inflight.append(fl)
        # bound the window: collect the oldest before over-queuing the
        # device (also bounds live batch-buffer memory)
        while self.inflight_depth > self.cfg.max_inflight:
            self.land(self._oldest_unlanded())
        return True

    def _oldest_unlanded(self) -> InFlight:
        for fl in self._inflight:
            if not fl.landed:
                return fl
        raise AssertionError("no unlanded in-flight batch")  # unreachable

    # ---- landing -----------------------------------------------------------

    def land(self, fl: InFlight) -> None:
        """Land one in-flight batch (idempotent; also the Ticket.result()
        callback) and drop collected entries from the window."""
        self.executor.land(fl)
        while self._inflight and self._inflight[0].landed:
            self._inflight.popleft()

    def reap(self) -> int:
        """Land every in-flight batch whose outputs report ready — the
        non-blocking half of pump().  Returns the number landed."""
        n = 0
        for fl in list(self._inflight):
            if not fl.landed and self.executor.ready(fl):
                self.land(fl)
                n += 1
        return n

    # ---- the loop verbs ----------------------------------------------------

    def pump(self, now: float) -> int:
        """Deadline flush + opportunistic landing.  Returns the number of
        batches flushed (deadline-triggered): the reference's pump()
        contract."""
        flushed = 0
        for bucket in list(self._queues):
            q = self._queues.get(bucket)
            if q and now - q[0].t_enq >= self.cfg.max_delay_s:
                if self.flush(bucket):
                    flushed += 1
        self.reap()
        return flushed

    def drain(self) -> int:
        """Flush every non-empty queue and land every in-flight batch
        (shutdown / test barrier).  Returns the number of batches flushed
        by this call."""
        flushed = 0
        for bucket in list(self._queues):
            if self.flush(bucket):
                flushed += 1
        while self._inflight:
            self.land(self._inflight[0])
        return flushed
