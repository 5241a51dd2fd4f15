"""Per-request span tracing for the serve tier (counterpart of
capital_tpu/obs/spans.py, host-only, copied so the port imports nothing of
the JAX package).

Every request the SolveEngine admits carries a `RequestTrace`: an ordered
chain of monotonic-clock spans covering the request's whole life —

    admit -> enqueue -> cache_lookup -> batch_form -> device
          [-> refine] -> respond

`admit` is validation + fault tap + pad + stage (submit() entry to
scheduler admission); `enqueue` is time parked in the bucket queue until a
flush starts; `cache_lookup` is program resolution (near-zero on a cache
hit — a capture shows up HERE, which is exactly the attribution the
zero-recompile gates want); `batch_form` is assemble + the program call's
issue; `device` is dispatch to landing (the batch's CUDA event observed);
`refine` is the landing sink when one ran (guaranteed-tier refinement
bookkeeping, arrowhead re-pack); `respond` is Response construction +
stats stamping.  Oversize singles skip the queue/batch spans (kind
"single"), never-dispatched failures collapse to admit -> respond (kind
"failed").

Everything here is HOST-side pure Python — `time.monotonic()` stamps
around the dispatch path, never a device sync — and the module imports
neither torch nor numpy.

The ledger surface is the schema-tagged ``serve:trace`` record (one per
run, `build_block`/`emit`): per-trace tags (bucket/op/tier/replica/
cfg-hash), per-span start/duration, completeness + monotonicity verdicts
under a pinned bubble tolerance, and — when the request carried a
``deadline_ms`` — slack-at-dispatch and SLO-violation attribution (the
span that ate the budget).  The record keeps the reference's schema, so
the reference's `ledger.validate_serve_trace` reads it as it is.
`to_chrome` exports the same traces as Chrome-trace-event JSON.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

#: The full span vocabulary, in chain order.  Validation rejects names
#: outside it and out-of-order stamping within it.
CHAIN = ("admit", "enqueue", "cache_lookup", "batch_form", "device",
         "refine", "respond")

#: Required sub-chain per trace kind.  "refine" is optional everywhere
#: (present only when a landing sink ran).
REQUIRED = {
    "batched": ("admit", "enqueue", "cache_lookup", "batch_form",
                "device", "respond"),
    "single": ("admit", "cache_lookup", "device", "respond"),
    "failed": ("admit", "respond"),
    # host-side session administrative ops (session_contract/close):
    # residency resolves on the host, nothing is dispatched — the chain
    # collapses to the lookup (docs/SERVING.md 'Streaming sessions')
    "session": ("admit", "cache_lookup", "respond"),
}

#: Pinned bubble tolerance: the largest host-side gap (seconds of
#: un-spanned time between consecutive spans) a chain may carry and still
#: count as complete.  Spans are stamped contiguously (each starts where
#: the previous ended), so real gaps only appear when a stamping site is
#: missed or the host stalls between stamps — 25 ms absorbs GC pauses on
#: a loaded CPU rig while still catching a dropped span site.
DEFAULT_BUBBLE_TOL_MS = 25.0

#: Allowance for the float rounding `asdict` applies (µs-scale), used by
#: the overlap check — NOT a gap budget.
_OVERLAP_EPS_S = 1e-5

#: Default bound on traces a TraceLog retains (oldest dropped first, with
#: a visible `dropped` counter) — bounded memory for long-running
#: replicas, comfortably above any smoke/loadgen run's request count.
DEFAULT_TRACE_CAP = 4096


class Span:
    """One contiguous phase of a request's life, on the monotonic clock."""

    __slots__ = ("name", "t_start", "t_end")

    def __init__(self, name: str, t_start: float, t_end: float):
        self.name = name
        self.t_start = t_start
        self.t_end = t_end

    @property
    def dur_s(self) -> float:
        return self.t_end - self.t_start

    def __repr__(self) -> str:  # debugging aid only
        return f"Span({self.name!r}, {self.dur_s * 1e3:.3f}ms)"


class RequestTrace:
    """The span chain + tags for one request.

    Stamping contract: `extend(name)` appends a span running from the
    previous span's end (or `t_enq` for the first) to now — the serve
    path stamps chains contiguously, so chain gaps measure *missed
    stamping sites*, not scheduling (scheduling time lives INSIDE the
    enqueue/device spans).  `span(name, t0, t1)` exists for explicit
    intervals (tests, replay)."""

    __slots__ = ("request_id", "op", "kind", "t_enq", "deadline_ms",
                 "tags", "spans")

    def __init__(self, request_id: int, op: str, t_enq: float, *,
                 deadline_ms: Optional[float] = None, **tags):
        self.request_id = request_id  # guarded-by: <frozen>
        self.op = op  # guarded-by: <frozen>
        self.kind = "batched"  # guarded-by: <owner-thread>  (rewritten by the single/failed routes)
        self.t_enq = t_enq  # guarded-by: <frozen>
        self.deadline_ms = deadline_ms  # guarded-by: <frozen>
        # bucket / tier / replica_id / cfg_hash ride here (str or None)
        self.tags = {k: v for k, v in tags.items() if v is not None}  # guarded-by: <owner-thread>
        self.spans: list[Span] = []  # guarded-by: <owner-thread>

    # ---- stamping ----------------------------------------------------------

    def tag(self, **kv) -> None:
        for k, v in kv.items():
            if v is not None:
                self.tags[k] = v

    @property
    def last_end(self) -> float:
        return self.spans[-1].t_end if self.spans else self.t_enq

    def span(self, name: str, t_start: float, t_end: float) -> None:
        self.spans.append(Span(name, t_start, t_end))

    def extend(self, name: str, t_end: Optional[float] = None) -> None:
        t_end = time.monotonic() if t_end is None else t_end
        self.spans.append(Span(name, self.last_end, t_end))

    # ---- derived signals ---------------------------------------------------

    @property
    def latency_ms(self) -> float:
        return (self.last_end - self.t_enq) * 1e3

    def _device_start(self) -> Optional[float]:
        for sp in self.spans:
            if sp.name == "device":
                return sp.t_start
        return None

    @property
    def slack_at_dispatch_ms(self) -> Optional[float]:
        """Deadline budget left when the request hit the device — the
        number a deadline-aware scheduler sheds/downgrades on.  None
        without a deadline or before dispatch."""
        d0 = self._device_start()
        if self.deadline_ms is None or d0 is None:
            return None
        return self.deadline_ms - (d0 - self.t_enq) * 1e3

    @property
    def violated(self) -> bool:
        return (self.deadline_ms is not None
                and self.latency_ms > self.deadline_ms)

    @property
    def attribution(self) -> Optional[str]:
        """Which span ate the budget: the longest one, reported only for
        violated requests (attribution of a met deadline is noise)."""
        if not self.violated or not self.spans:
            return None
        return max(self.spans, key=lambda sp: sp.dur_s).name

    # ---- validation --------------------------------------------------------

    def problems(self, bubble_tol_ms: float = DEFAULT_BUBBLE_TOL_MS
                 ) -> list[str]:
        return _chain_problems(
            [(sp.name, sp.t_start, sp.t_end) for sp in self.spans],
            self.kind, self.t_enq, bubble_tol_ms,
        )

    def complete(self, bubble_tol_ms: float = DEFAULT_BUBBLE_TOL_MS
                 ) -> bool:
        return not self.problems(bubble_tol_ms)

    # ---- export ------------------------------------------------------------

    def asdict(self) -> dict:
        """The per-trace dict inside a ``serve:trace`` record (also the
        wire form a replica marshals back to the router).  Times stay on
        the monotonic clock — CLOCK_MONOTONIC is shared across processes
        on one host, so replica traces normalize alongside engine ones at
        export time."""
        return {
            "request_id": int(self.request_id),
            "op": self.op,
            "kind": self.kind,
            "bucket": self.tags.get("bucket"),
            "tier": self.tags.get("tier"),
            "replica_id": self.tags.get("replica_id"),
            "cfg_hash": self.tags.get("cfg_hash"),
            "deadline_ms": self.deadline_ms,
            "t_enq_s": round(self.t_enq, 6),
            "latency_ms": round(self.latency_ms, 4),
            "slack_at_dispatch_ms": (
                round(self.slack_at_dispatch_ms, 4)
                if self.slack_at_dispatch_ms is not None else None
            ),
            "violated": bool(self.violated),
            "attribution": self.attribution,
            "spans": [
                {"name": sp.name, "t_start_s": round(sp.t_start, 6),
                 "dur_ms": round(max(0.0, sp.dur_s) * 1e3, 4)}
                for sp in self.spans
            ],
        }


def _chain_problems(spans: list[tuple], kind: str, t_enq: float,
                    bubble_tol_ms: float) -> list[str]:
    """Shared chain validation over (name, t_start, t_end) triples —
    RequestTrace objects and ledger trace dicts both route here, so the
    in-run gate and `ledger.validate_serve_trace` can never disagree."""
    probs: list[str] = []
    if kind not in REQUIRED:
        return [f"unknown trace kind {kind!r}"]
    if not spans:
        return [f"empty span chain (kind {kind!r})"]
    names = [n for n, _, _ in spans]
    for n in names:
        if n not in CHAIN:
            probs.append(f"unknown span name {n!r}")
    order = [CHAIN.index(n) for n in names if n in CHAIN]
    if order != sorted(order):
        probs.append(f"span names out of chain order: {names}")
    it = iter(names)
    if not all(req in it for req in REQUIRED[kind]):
        probs.append(
            f"incomplete chain for kind {kind!r}: have {names}, need "
            f"{list(REQUIRED[kind])}"
        )
    tol_s = bubble_tol_ms / 1e3
    prev_end = t_enq
    for name, t0, t1 in spans:
        if t1 < t0 - _OVERLAP_EPS_S:
            probs.append(f"span {name!r} ends before it starts "
                         f"({t1:.6f} < {t0:.6f})")
        if t0 < prev_end - _OVERLAP_EPS_S:
            probs.append(
                f"span {name!r} starts at {t0:.6f}, before the previous "
                f"span ended ({prev_end:.6f}) — non-monotonic chain"
            )
        gap = t0 - prev_end
        if gap > tol_s:
            probs.append(
                f"{gap * 1e3:.3f} ms un-spanned gap before {name!r} "
                f"exceeds the {bubble_tol_ms} ms bubble tolerance"
            )
        prev_end = max(prev_end, t1)
    return probs


def trace_dict_problems(t: dict,
                        bubble_tol_ms: float = DEFAULT_BUBBLE_TOL_MS
                        ) -> list[str]:
    """Structural + chain validation of one exported trace dict (the
    `traces` entries of a ``serve:trace`` block).  Returns problem
    strings, [] when valid — the obs.ledger validator convention."""
    probs: list[str] = []
    if not isinstance(t, dict):
        return [f"trace entry is {type(t).__name__}, not a dict"]
    if not isinstance(t.get("request_id"), int):
        probs.append(f"request_id {t.get('request_id')!r} is not an int")
    if not isinstance(t.get("op"), str):
        probs.append(f"op {t.get('op')!r} is not a string")
    spans = t.get("spans")
    if not isinstance(spans, list):
        return probs + [f"spans is {type(spans).__name__}, not a list"]
    triples = []
    for i, sp in enumerate(spans):
        if not isinstance(sp, dict):
            probs.append(f"spans[{i}] is not a dict")
            continue
        name, t0, dur = sp.get("name"), sp.get("t_start_s"), sp.get("dur_ms")
        if not isinstance(name, str):
            probs.append(f"spans[{i}].name {name!r} is not a string")
            continue
        if not isinstance(t0, (int, float)) \
                or not isinstance(dur, (int, float)):
            probs.append(f"span {name!r} has non-numeric timing "
                         f"(t_start_s={t0!r}, dur_ms={dur!r})")
            continue
        if dur < 0:
            probs.append(f"span {name!r} has negative duration {dur}")
            continue
        triples.append((name, float(t0), float(t0) + float(dur) / 1e3))
    if not probs:
        t_enq = t.get("t_enq_s")
        t_enq = float(t_enq) if isinstance(t_enq, (int, float)) else (
            triples[0][1] if triples else 0.0)
        probs.extend(_chain_problems(triples, t.get("kind", "batched"),
                                     t_enq, bubble_tol_ms))
    dl = t.get("deadline_ms")
    if dl is not None and not isinstance(dl, (int, float)):
        probs.append(f"deadline_ms {dl!r} is not numeric")
    return probs


class TraceLog:
    """Bounded accumulator of a run's traces.  The engine `start()`s one
    RequestTrace per submitted request; a router `add()`s the already-
    exported dicts its replicas marshal back.  Oldest traces drop first
    past `cap`, counted visibly (`dropped`) so a truncated export can
    never read as a complete run."""

    def __init__(self, cap: int = DEFAULT_TRACE_CAP):
        if cap < 1:
            raise ValueError(f"trace cap must be >= 1, got {cap}")
        # single-owner by default; the Router shares ONE TraceLog between
        # its pump thread and client threads and guards every call with
        # its RLock (see serve/router.py emit_trace)
        self.cap = cap  # guarded-by: <frozen>
        self.total = 0  # guarded-by: <owner-thread>
        self._traces: deque = deque(maxlen=cap)  # guarded-by: <owner-thread>

    def start(self, request_id: int, op: str, t_enq: float, *,
              deadline_ms: Optional[float] = None, **tags) -> RequestTrace:
        tr = RequestTrace(request_id, op, t_enq,
                          deadline_ms=deadline_ms, **tags)
        self.total += 1
        self._traces.append(tr)
        return tr

    def add(self, trace_dict: dict) -> None:
        self.total += 1
        self._traces.append(trace_dict)

    @property
    def dropped(self) -> int:
        return self.total - len(self._traces)

    def trace_dicts(self) -> list[dict]:
        return [t.asdict() if isinstance(t, RequestTrace) else dict(t)
                for t in self._traces]

    def __len__(self) -> int:
        return len(self._traces)

    def block(self, bubble_tol_ms: float = DEFAULT_BUBBLE_TOL_MS) -> dict:
        return build_block(self.trace_dicts(), bubble_tol_ms=bubble_tol_ms,
                           dropped=self.dropped)

    def emit(self, path: Optional[str] = None, *, grid=None, config=None,
             bubble_tol_ms: float = DEFAULT_BUBBLE_TOL_MS,
             **extra) -> dict:
        """One schema-tagged ``serve:trace`` ledger record carrying the
        whole log (appended to `path` when given) — same manifest
        discipline as serve:request_stats."""
        from capital_tpu_torch.obs import ledger

        rec = ledger.record(
            "serve:trace",
            ledger.manifest(grid=grid, config=config),
            serve_trace=self.block(bubble_tol_ms),
            **extra,
        )
        if path:
            ledger.append(path, rec)
        return rec


def build_block(trace_dicts: list[dict], *,
                bubble_tol_ms: float = DEFAULT_BUBBLE_TOL_MS,
                dropped: int = 0) -> dict:
    """The ``serve_trace`` record block: the traces plus the aggregate
    verdicts the gates read (complete count under the pinned bubble
    tolerance, SLO violations)."""
    from capital_tpu_torch.obs.ledger import SCHEMA_VERSION

    complete = sum(
        1 for t in trace_dicts if not trace_dict_problems(t, bubble_tol_ms)
    )
    return {
        "schema_version": SCHEMA_VERSION,
        "bubble_tol_ms": float(bubble_tol_ms),
        "requests": len(trace_dicts),
        "complete": complete,
        "dropped": int(dropped),
        "violations": sum(1 for t in trace_dicts if t.get("violated")),
        "traces": trace_dicts,
    }


def to_chrome(trace_dicts: list[dict]) -> dict:
    """Chrome-trace-event JSON (the chrome://tracing / Perfetto format):
    one complete ("ph": "X") event per span, requests as threads, engines/
    replicas as named processes, timestamps normalized to the earliest
    span.  Deadline signals ride the event args so the waterfall shows
    which span ate a violated request's budget."""
    events: list[dict] = []
    pids: dict[str, int] = {}
    t0 = min(
        (sp["t_start_s"] for t in trace_dicts for sp in t.get("spans", ())
         if isinstance(sp.get("t_start_s"), (int, float))),
        default=0.0,
    )
    for t in trace_dicts:
        label = t.get("replica_id") or "engine"
        if label not in pids:
            pids[label] = len(pids) + 1
            events.append({
                "ph": "M", "name": "process_name", "pid": pids[label],
                "tid": 0, "args": {"name": f"serve:{label}"},
            })
        pid = pids[label]
        args = {
            "op": t.get("op"), "kind": t.get("kind"),
            "bucket": t.get("bucket"), "tier": t.get("tier"),
            "cfg_hash": t.get("cfg_hash"),
            "deadline_ms": t.get("deadline_ms"),
            "slack_at_dispatch_ms": t.get("slack_at_dispatch_ms"),
            "violated": t.get("violated", False),
            "attribution": t.get("attribution"),
        }
        for sp in t.get("spans", ()):
            events.append({
                "ph": "X",
                "name": sp["name"],
                "cat": str(t.get("op")),
                "ts": round((sp["t_start_s"] - t0) * 1e6, 3),
                "dur": round(sp["dur_ms"] * 1e3, 3),
                "pid": pid,
                "tid": int(t.get("request_id", 0)),
                "args": args,
            })
    return {"displayTimeUnit": "ms", "traceEvents": events}
