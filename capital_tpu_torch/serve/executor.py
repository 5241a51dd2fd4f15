"""Dispatch, donation, fault containment and result landing (counterpart
of capital_tpu/serve/executor.py).

The executor turns an assembled bucket batch into a program call, and a
program call into per-request `Response`s.  `dispatch()` returns an
`InFlight` handle without synchronizing: on the card the program's
kernels (or its graph replay) are queued on the current stream and a
`torch.cuda.Event` recorded behind them, so the scheduler can stage and
dispatch the next bucket while this one executes; `ready()` asks the
event (`Event.query()`, never blocking) and `land()` waits on it only when
someone needs the results.

Timing contract (the queue-wait/device split serve/stats.py reports):

* ``t_enq`` — request enqueue time (set at `submit()`);
* ``t0`` — dispatch time (set here once the program call is issued);
* landing time — when `land()` observed the batch's event.

``queue_wait_s = t0 - t_enq`` is scheduling policy; ``device_s = t_land -
t0`` is compute + transfer + any slack the scheduler chose not to collect
earlier.

Donation keeps the reference's rule (`donate_argnums`): engine-built batch
buffers only, off by default unless the grid is a TPU — so off on the card
and on the CPU — posv's RHS, inv's operand, never lstsq's.  Fault
containment likewise: `fail()` lands host-side ingest faults as failed
Responses, and the per-problem `info` vector flags breakdowns one request
at a time.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from capital_tpu_torch.obs import spans
from capital_tpu_torch.robust.config import RobustInfo
from capital_tpu_torch.serve import batching
from capital_tpu_torch.utils import tracing


@dataclasses.dataclass
class Response:
    """One finished request.  `x` is the cropped solution (None only when
    `ok` is False with `error` set).  `info` is a RobustInfo under
    ServeConfig.robust (breakdown != 0 means x is flagged garbage), else
    None.  `latency_s` is enqueue-to-landing; `queue_wait_s`/`device_s`
    are its two halves (None when no dispatch happened)."""

    request_id: int
    op: str
    ok: bool
    x: Optional[torch.Tensor]
    info: Optional[RobustInfo]
    error: Optional[str]
    bucket: Optional[tuple]
    batched: bool
    latency_s: float
    queue_wait_s: Optional[float] = None
    device_s: Optional[float] = None
    trace: Optional[spans.RequestTrace] = None


class Ticket:
    """Handle returned by submit().  Carries the request's clock marks
    (`t_enq` at submit, `t0` at dispatch) and resolves when its batch
    lands.  Under the continuous scheduler a capacity flush dispatches the
    batch without waiting for it: the ticket is `done`, and `result()`
    lands the batch on demand if `pump()`/`drain()` hasn't already."""

    __slots__ = ("request_id", "t_enq", "t0", "response", "trace",
                 "deadline_ms", "_entry", "_land")

    def __init__(self, request_id: int, t_enq: float = 0.0):
        self.request_id = request_id
        self.t_enq = t_enq
        self.t0: Optional[float] = None  # stamped at dispatch
        self.response: Optional[Response] = None
        self.trace: Optional[spans.RequestTrace] = None
        self.deadline_ms: Optional[float] = None
        self._entry = None  # InFlight carrying this ticket, once dispatched
        self._land = None  # scheduler callback that lands _entry

    @property
    def done(self) -> bool:
        """True once a Response landed or the batch is dispatched and in
        flight (result() will land it)."""
        return self.response is not None or self._entry is not None

    def result(self) -> Response:
        if self.response is None:
            if self._entry is None:
                raise RuntimeError(
                    f"request {self.request_id} not flushed yet — call "
                    "engine.pump() (deadline flush) or engine.drain()"
                )
            self._land(self._entry)  # lands the whole batch, fills response
        return self.response


@dataclasses.dataclass
class _Pending:
    """One queued request: its ticket plus the padded, staged operands.
    `client_op` is the op the client submitted when the bucket runs an
    internal program on its behalf; `sink` is the engine's landing hook —
    called with (cropped_x, extra_outputs, raw_info), it may rewrite the
    landed result or fail it loudly; returns (x, info, error)."""

    ticket: Ticket
    pa: torch.Tensor
    pb: Optional[torch.Tensor]
    a_shape: tuple[int, ...]
    b_shape: Optional[tuple[int, ...]]
    t_enq: float
    client_op: Optional[str] = None
    sink: Optional[object] = None


@dataclasses.dataclass
class InFlight:
    """One dispatched-but-not-landed bucket batch."""

    bucket: batching.Bucket
    pending: list[_Pending]
    outputs: tuple  # the program's output tensors, possibly still computing
    t0: float  # dispatch time
    small: bool  # served by the batched kernels (stats split)
    event: Optional[torch.cuda.Event] = None  # recorded behind the call (card only)
    landed: bool = False


class Executor:
    """Dispatch + landing.  Owns no queues and no cache — the scheduler
    decides when, the engine decides what program; this class runs it and
    lands the results into Responses/stats."""

    def __init__(self, cfg, grid, stats):
        self.cfg = cfg
        self.grid = grid
        self.stats = stats

    # ---- donation ----------------------------------------------------------

    def donate(self) -> bool:
        d = self.cfg.donate
        return self.grid.platform == "tpu" if d is None else d

    def donate_argnums(self, bucket: batching.Bucket) -> tuple[int, ...]:
        """The donation declaration for one bucket program (the
        reference's rule): posv's RHS batch, inv's operand batch, nothing
        for lstsq (its (m, nrhs) RHS cannot hold the (n, nrhs) solution).
        chol_update / chol_downdate donate the assembled factor batch —
        `batching.assemble` stacks copies of the padded operands, so the
        resident factor in the FactorCache is never that buffer —
        posv_cached its RHS; the miss, extend and session programs and
        every tiered bucket donate nothing (session_solve's 4-stack holds
        the resident (L, Wt); the fast program downcasts its inputs, the
        guaranteed one keeps both operands live across every sweep)."""
        if not self.donate():
            return ()
        if bucket.tier != "balanced":
            return ()
        if bucket.op in ("chol_update", "chol_downdate"):
            return (0,)
        if bucket.op == "posv_cached":
            return (1,)
        if bucket.op in ("posv_cached_miss", "blocktri_extend",
                         "session_extend", "session_solve"):
            return ()
        if bucket.b_shape is not None:
            return (1,) if bucket.op == "posv" else ()
        return (0,)

    # ---- batched dispatch + landing ---------------------------------------

    def dispatch(self, bucket: batching.Bucket, exe,
                 pending: list[_Pending], small: bool) -> InFlight:
        """Assemble and call one bucket batch without synchronizing.  The
        returned InFlight's outputs may still be computing; land()
        collects them."""
        dev = self.grid.device
        Ab, Bb, occupancy = batching.assemble(
            [p.pa.to(dev) for p in pending],
            [None if p.pb is None else p.pb.to(dev) for p in pending],
            bucket, device=dev,
        )
        with tracing.scope("SV::dispatch"):
            outputs = exe(Ab) if Bb is None else exe(Ab, Bb)
        event = None
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        t0 = time.monotonic()
        fl = InFlight(bucket=bucket, pending=list(pending), outputs=tuple(outputs),
                      t0=t0, small=small, event=event)
        for p in pending:
            p.ticket.t0 = t0
            if p.ticket.trace is not None:
                # assemble + call issue; host-side stamp only
                p.ticket.trace.extend("batch_form", t0)
        self.stats.note_batch(occupancy, bucket=batching.bucket_label(bucket))
        return fl

    def ready(self, fl: InFlight) -> bool:
        """Non-blocking readiness probe: the batch's event has completed
        (always ready on the CPU, where the call ran to its end)."""
        return fl.event is None or fl.event.query()

    def land(self, fl: InFlight) -> None:
        """Wait on one in-flight batch and land every request in it:
        crop, robust-flag, stamp the queue-wait/device split, feed stats.
        Idempotent (the scheduler, a Ticket.result() and drain() may all
        try)."""
        if fl.landed:
            return
        fl.landed = True
        if fl.event is not None:
            fl.event.synchronize()
        # programs return (X, info) or (X, extras..., info); per-problem
        # scalars (info, the refinement counters) come to the host once
        *xs, info = (x.cpu() if x.dim() == 1 else x for x in fl.outputs)
        t_land = time.monotonic()
        for i, p in enumerate(fl.pending):
            tr = p.ticket.trace
            if tr is not None:
                tr.extend("device", t_land)
            xi = batching.crop(fl.bucket.op, xs[0][i], p.a_shape, p.b_shape)
            ri = info[i]
            err = None
            if p.sink is not None:
                xi, ri, err = p.sink(xi, tuple(x[i] for x in xs[1:]), ri)
                if tr is not None:
                    tr.extend("refine")  # sink bookkeeping ran host-side
            op = p.client_op or fl.bucket.op
            if err is not None:
                # the sink refused the result: land it as a loud failure,
                # never a silent wrong answer
                lat = t_land - p.t_enq
                p.ticket.response = Response(
                    request_id=p.ticket.request_id, op=op, ok=False,
                    x=None, info=self._norm_info(ri), error=err,
                    bucket=fl.bucket.key, batched=True, latency_s=lat,
                    queue_wait_s=max(0.0, fl.t0 - p.t_enq),
                    device_s=max(0.0, t_land - fl.t0),
                    trace=tr,
                )
                if tr is not None:
                    tr.extend("respond")
                self.stats.record_request(
                    op, lat, ok=False, failed=True,
                    bucket=batching.bucket_label(fl.bucket))
                continue
            self._finish(
                p.ticket, op, xi, ri, fl.bucket.key,
                batched=True, t_enq=p.t_enq, t0=fl.t0, t_land=t_land,
                small=fl.small,
            )
        fl.pending = []
        fl.outputs = ()  # release the batch buffers

    # ---- single-problem (oversize) route ----------------------------------

    def run_single(self, ticket: Ticket, op: str, A, B, exe,
                   t_enq: float) -> None:
        """Oversize requests stay synchronous: one exact-shape problem
        through the models, landed immediately."""
        t0 = time.monotonic()
        ticket.t0 = t0
        x, raw = exe(A) if B is None else exe(A, B)
        if self.grid.device.type == "cuda":
            torch.cuda.synchronize(self.grid.device)
        t_land = time.monotonic()
        if ticket.trace is not None:
            ticket.trace.extend("device", t_land)
        self._finish(ticket, op, x, raw, None, batched=False, t_enq=t_enq,
                     t0=t0, t_land=t_land)

    # ---- landing internals -------------------------------------------------

    def fail(self, ticket: Ticket, op: str, error: str,
             t_enq: float) -> None:
        """Land a request that never reached a device: ingest fault or
        oversize-reject.  No queue-wait/device split exists for it."""
        now = time.monotonic()
        lat = now - t_enq
        tr = ticket.trace
        if tr is not None:
            # collapse to the failed chain: admit covers submit-to-fault,
            # respond is the Response/stats stamp happening right here
            tr.kind = "failed"
            if not tr.spans:
                tr.extend("admit", now)
            tr.extend("respond")
        ticket.response = Response(
            request_id=ticket.request_id, op=op, ok=False, x=None,
            info=None, error=error, bucket=None, batched=False,
            latency_s=lat, trace=tr,
        )
        self.stats.record_request(op, lat, ok=False, failed=True)

    def _norm_info(self, raw) -> Optional[RobustInfo]:
        if self.cfg.robust is None:
            return None
        if isinstance(raw, RobustInfo):
            return RobustInfo(
                info=int(raw.info), breakdown=int(raw.breakdown),
                shifted=int(raw.shifted), sigma=float(raw.sigma),
                escalated=int(raw.escalated), ortho=float(raw.ortho),
                gate=int(raw.gate),
            )
        i = int(raw)
        # detect-only sites surface the potrf convention; no recovery ran
        return RobustInfo(info=i, breakdown=int(i != 0), shifted=0,
                          sigma=0.0, escalated=0, ortho=-1.0)

    def _finish(self, ticket: Ticket, op: str, x, raw_info,
                bucket_key: Optional[tuple], batched: bool, t_enq: float,
                t0: float, t_land: float, small: bool = False) -> None:
        info = self._norm_info(raw_info)
        ok = info is None or info.info == 0
        queue_wait = max(0.0, t0 - t_enq)
        device = max(0.0, t_land - t0)
        ticket.response = Response(
            request_id=ticket.request_id, op=op, ok=ok, x=x, info=info,
            error=None, bucket=bucket_key, batched=batched,
            latency_s=t_land - t_enq,
            queue_wait_s=queue_wait, device_s=device,
            trace=ticket.trace,
        )
        if ticket.trace is not None:
            ticket.trace.extend("respond")
        self.stats.record_request(
            op, t_land - t_enq, ok=ok,
            flagged=(info is not None and not ok), small=small,
            queue_wait_s=queue_wait, device_s=device,
            bucket=(batching.bucket_label(bucket_key)
                    if bucket_key is not None else None),
        )
