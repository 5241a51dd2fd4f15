"""EngineReplica: one SolveEngine behind a message transport
(counterpart of capital_tpu/serve/replica.py, the whole module).

A replica is the unit the Router (serve/router.py) dispatches to: a worker
that owns ONE engine exclusively (the engine is not thread-safe — "a single
dispatch loop owns it", engine.py) and speaks a small tuple protocol over
an inbox/outbox pair.  Two transports implement it:

* `ThreadReplica` — the engine worker is a daemon thread in this process,
  the transport a pair of ``queue.Queue``s.  This is the mode tier-1 tests
  exercise the full router logic in: deterministic, no process-spawn
  flakiness, and a `kill()` that abandons in-flight work exactly the way a
  crashed process would (the worker exits without landing or acking).
* `ProcessReplica` — the engine worker is a spawned subprocess (spawn:
  CUDA cannot be forked), the transport a duplex ``multiprocessing.Pipe``.
  The deployment mode: N processes sidestep the GIL, each with its own
  CUDA context on the one card, each loading the kernels from the shared
  nvcc build directory (ops/_build.py renames a build into place
  atomically, so two children building at once race benignly), and a
  shared ``ServeConfig.persist_dir`` means every replica past the first
  warms the programs its peers built (serve/cache.py's manifest).

Protocol (plain tuples, picklable for the pipe transport)::

    inbox:  ("submit", rid, op, A, B)     one request; A/B numpy
            ("warmup", tok, specs)        engine.warmup() over specs
            ("ping", tok)                 health probe
            ("stats", tok)                request_stats snapshot + cache
            ("drain", tok)                land the whole window, then ack
            ("stop",)                     drain, ack, exit clean
    outbox: ("result", rid, payload)      payload: plain-dict Response
            ("warmed", tok, info)         {"fresh": builds, "cache": ...}
            ("pong", tok, info)           {"outstanding": n, "queue_depth": n}
            ("stats", tok, snapshot)      stats.Collector.snapshot(...)
            ("drained", tok)
            ("stopped",)
            ("fatal", message)            worker died constructing/serving

The worker marshals every Response to a plain dict (`Result` on the router
side): ``x`` becomes a host numpy array (bf16 widened to f32), ``info`` a
plain dict of Python numbers — nothing device-resident crosses the
transport, which is also what makes the pipe mode possible at all.

The worker's engine runs on `device` ("cuda", the default, or "cpu").  A
worker that cannot build its engine there — a process replica with no
card — reports ``("fatal", message)`` and exits: it never serves on
another device.

HOST-ONLY MODULE: the dispatch path never builds a device program, so
this file does not import torch.  The engine is imported lazily inside the
worker, and in the process mode only ever inside the child, AFTER the env
overrides land in ``os.environ`` (``CUDA_VISIBLE_DEVICES`` and the like
are read when torch initializes CUDA).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np

#: Per-iteration wait bound for the worker loop's single blocking point —
#: small enough that a deadline flush (max_delay_s) is never late by more
#: than this, large enough not to spin an idle replica.
_IDLE_WAIT_S = 0.02


@dataclasses.dataclass
class Result:
    """One finished request as the router sees it: executor.Response with
    every field marshalled host-side (`x` numpy, `info` a plain dict), plus
    the id of the replica that served it."""

    request_id: int
    op: str
    ok: bool
    x: Optional[np.ndarray]
    info: Optional[dict]
    error: Optional[str]
    bucket: Optional[tuple]
    batched: bool
    latency_s: float
    queue_wait_s: Optional[float] = None
    device_s: Optional[float] = None
    replica_id: Optional[str] = None
    #: the request's exported span chain (spans.RequestTrace.asdict() —
    #: plain JSON-safe dict, so it crosses the pipe transport freely)
    trace: Optional[dict] = None


def _host(v):
    """One tensor (or number) -> host numpy (bf16 widened to f32, which
    numpy lacks) or a Python number for a 0-d value."""
    if hasattr(v, "detach"):
        v = v.detach()
        if str(v.dtype) == "torch.bfloat16":
            v = v.float()
        v = v.cpu().numpy()
    a = np.asarray(v)
    return a.item() if a.ndim == 0 else a


def _marshal(rid: int, resp) -> dict:
    """Response -> plain picklable dict (the ("result", rid, payload)
    payload).  rid is the ROUTER's request id — the engine's internal
    ticket ids are per-replica and meaningless across the transport."""
    info = resp.info
    if info is not None:
        info = {k: _host(v) for k, v in info._asdict().items()}
    trace = getattr(resp, "trace", None)
    if trace is not None:
        trace = dict(trace.asdict(), request_id=rid)
    return {
        "request_id": rid,
        "op": resp.op,
        "ok": bool(resp.ok),
        "x": _host(resp.x) if resp.x is not None else None,
        "info": info,
        "error": resp.error,
        "bucket": tuple(resp.bucket) if resp.bucket is not None else None,
        "batched": bool(resp.batched),
        "latency_s": float(resp.latency_s),
        "queue_wait_s": resp.queue_wait_s,
        "device_s": resp.device_s,
        "trace": trace,
    }


def _mk_engine(cfg_kwargs: dict, device: str):
    """The worker's engine on a one-device grid of `device`; raises when
    the device is a card this process cannot reach."""
    import torch

    from capital_tpu_torch.parallel.topology import Grid
    from capital_tpu_torch.serve.engine import ServeConfig, SolveEngine

    dev = torch.device(device)
    if dev.type == "cuda" and (dev.index or 0) >= torch.cuda.device_count():
        raise RuntimeError(f"replica device {device!r}: this process sees "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    robust = cfg_kwargs.get("robust")
    if isinstance(robust, dict):
        from capital_tpu_torch.robust.config import RobustConfig

        cfg_kwargs = dict(cfg_kwargs, robust=RobustConfig(**robust))
    return SolveEngine(Grid.square(device=device), ServeConfig(**cfg_kwargs))


def _serve_loop(replica_id: str, cfg_kwargs: dict,
                recv: Callable[[float], Optional[tuple]],
                send: Callable[[tuple], None],
                killed: Callable[[], bool], device: str = "cuda") -> None:
    """The worker: one engine, one loop.  `recv(timeout)` returns the next
    inbox tuple or None; `send` posts to the outbox; `killed()` polled each
    iteration simulates (thread mode) or observes (process mode never needs
    it) an abrupt crash — the loop exits WITHOUT landing or acking, which
    is exactly the failure the router's re-dispatch path exists for.  An
    engine that cannot be built on `device` is reported as fatal."""
    try:
        eng = _mk_engine(cfg_kwargs, device)
    except Exception as e:  # noqa: BLE001 — reported through the transport
        send(("fatal", f"{type(e).__name__}: {e}"))
        return
    eng.stats.replica_id = replica_id
    outstanding: dict[int, object] = {}  # rid -> Ticket, insertion-ordered

    def flush() -> bool:
        landed = [rid for rid, t in outstanding.items()
                  if t.response is not None]
        for rid in landed:
            t = outstanding.pop(rid)
            send(("result", rid, _marshal(rid, t.response)))
        return bool(landed)

    def handle(msg: tuple) -> bool:
        """Apply one inbox message; True means exit the loop."""
        kind = msg[0]
        if kind == "submit":
            # 5-tuple is the pre-tier wire format; trailing elements are
            # [tier] or [tier, deadline_ms] (tier sent explicitly — even
            # "balanced" — whenever a deadline rides along, so mixed
            # router/replica versions interoperate on plain traffic)
            _, rid, op, A, B, *rest = msg
            tier = rest[0] if rest else "balanced"
            deadline = rest[1] if len(rest) > 1 else None
            try:
                outstanding[rid] = eng.submit(op, A, B,
                                              accuracy_tier=tier,
                                              deadline_ms=deadline)
            except ValueError as e:
                send(("result", rid, {
                    "request_id": rid, "op": op, "ok": False, "x": None,
                    "info": None, "error": f"{type(e).__name__}: {e}",
                    "bucket": None, "batched": False, "latency_s": 0.0,
                    "queue_wait_s": None, "device_s": None,
                    "trace": None,
                }))
        elif kind == "warmup":
            fresh = eng.warmup(msg[2])
            send(("warmed", msg[1], {
                "fresh": fresh, "cache": eng.cache_stats(),
            }))
        elif kind == "ping":
            send(("pong", msg[1], {
                "outstanding": len(outstanding),
                "queue_depth": eng.queue_depth(),
            }))
        elif kind == "stats":
            send(("stats", msg[1],
                  eng.stats.snapshot(eng.cache_stats(), samples=True)))
        elif kind == "drain":
            eng.drain()
            flush()
            send(("drained", msg[1]))
        elif kind == "stop":
            eng.drain()
            flush()
            send(("stopped",))
            return True
        return False

    while True:
        if killed():
            return  # crash: outstanding work is abandoned, no acks
        wait = min(_IDLE_WAIT_S, eng.cfg.max_delay_s) \
            if outstanding or eng.queue_depth() else _IDLE_WAIT_S
        msg = recv(wait)
        try:
            while msg is not None:
                if handle(msg):
                    return
                if killed():
                    return
                msg = recv(0.0)
            eng.pump()
            if flush() or not outstanding:
                continue
            # stalled tail: nothing landed, nothing queued behind a
            # deadline — force the oldest dispatched batch to land so a
            # closed-loop client is never wedged behind the in-flight
            # window (same forcing rule as loadgen.run_closed_loop)
            if eng.queue_depth() == 0:
                oldest = next(iter(outstanding.values()))
                if oldest.done:
                    oldest.result()
                    flush()
        except Exception as e:  # noqa: BLE001 — the worker must report its
            # death through the transport (the router's circuit breaker is
            # the handler), never die silently holding the outbox.
            try:
                send(("fatal", f"{type(e).__name__}: {e}"))
            except Exception:  # lint: allow-broad-except — transport gone
                pass
            return


class EngineReplica:
    """Parent-side handle: lifecycle + transport for one engine worker.

    Subclasses provide `_send` / `_recv_nowait` / `alive` / `start` /
    `kill` / `join`; everything protocol-shaped lives here.  `poll()`
    returns every pending outbox message — the router interprets them; the
    synchronous helpers (`ping`/`warmup`/`request_stats`/`drain`) buffer
    non-matching messages so a sync call never swallows a result."""

    def __init__(self, replica_id: str, cfg, device: Optional[str] = None):
        self.replica_id = replica_id
        self.cfg = cfg
        #: the worker engine's device: "cuda" (the card) unless given
        self.device = device or "cuda"
        self._tok = 0
        self._buffered: list[tuple] = []
        self.fatal: Optional[str] = None

    # -- transport hooks (subclass) ---------------------------------------

    def start(self) -> None:
        raise NotImplementedError

    def alive(self) -> bool:
        raise NotImplementedError

    def kill(self) -> None:
        raise NotImplementedError

    def join(self, timeout: Optional[float] = None) -> None:
        raise NotImplementedError

    def _send(self, msg: tuple) -> None:
        raise NotImplementedError

    def _recv_nowait(self) -> Optional[tuple]:
        raise NotImplementedError

    # -- protocol ---------------------------------------------------------

    def ladders(self) -> dict:
        """The bucket ladders the router's affinity hash keys on — read
        from the replica's config, so router and replica can never
        disagree about what a bucket is."""
        return {
            "buckets": tuple(self.cfg.buckets),
            "rows_buckets": tuple(self.cfg.rows_buckets),
            "nrhs_buckets": tuple(self.cfg.nrhs_buckets),
        }

    def submit(self, rid: int, op: str, A, B=None,
               tier: str = "balanced",
               deadline_ms: Optional[float] = None) -> None:
        msg = ("submit", rid, op, np.asarray(A),
               np.asarray(B) if B is not None else None)
        if deadline_ms is not None:
            # deadline rides after the tier, so the tier goes on the wire
            # explicitly (even "balanced") whenever a deadline does
            msg = msg + (tier, float(deadline_ms))
        elif tier != "balanced":
            # trailing element only when non-balanced: balanced traffic
            # keeps the pre-tier 5-tuple wire format
            msg = msg + (tier,)
        self._send(msg)

    def poll(self) -> list[tuple]:
        """Every pending outbox message (buffered ones first).  A
        ("fatal", msg) is recorded on self.fatal and passed through."""
        out, self._buffered = self._buffered, []
        while True:
            msg = self._recv_nowait()
            if msg is None:
                break
            out.append(msg)
        for m in out:
            if m[0] == "fatal":
                self.fatal = m[1]
        return out

    def _await(self, kind: str, tok: int, timeout: float) -> Optional[tuple]:
        """Wait for one (kind, tok, ...) reply, buffering everything else
        for the next poll().  None on timeout or worker death."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            msg = self._recv_nowait()
            if msg is None:
                if not self.alive():
                    return None
                time.sleep(1e-3)
                continue
            if msg[0] == kind and len(msg) > 1 and msg[1] == tok:
                return msg
            if msg[0] == "fatal":
                self.fatal = msg[1]
            self._buffered.append(msg)
        return None

    def _roundtrip(self, req: str, reply: str, timeout: float,
                   *payload) -> Optional[tuple]:
        self._tok += 1
        tok = self._tok
        try:
            self._send((req, tok) + payload)
        except (OSError, ValueError):  # broken pipe / closed queue
            return None
        return self._await(reply, tok, timeout)

    def ping(self, timeout: float = 5.0) -> Optional[dict]:
        msg = self._roundtrip("ping", "pong", timeout)
        return msg[2] if msg else None

    def ping_async(self) -> int:
        """Fire-and-forget heartbeat: send a ping, return its token; the
        ("pong", token, info) arrives through poll() — the router's
        heartbeat uses this so a slow replica never blocks the pump."""
        self._tok += 1
        self._send(("ping", self._tok))
        return self._tok

    def warmup(self, specs, timeout: float = 300.0) -> Optional[dict]:
        """Warm the replica's engine over `specs` ((op, a_shape, b_shape,
        dtype) tuples); {"fresh": n, "cache": ...} or None on failure.
        Generous timeout: a replica builds every program here (a capture
        each on the card), its specs' and a warm persist_dir's manifest's."""
        msg = self._roundtrip("warmup", "warmed", timeout, list(specs))
        return msg[2] if msg else None

    def request_stats(self, timeout: float = 30.0) -> Optional[dict]:
        msg = self._roundtrip("stats", "stats", timeout)
        return msg[2] if msg else None

    def drain(self, timeout: float = 60.0) -> bool:
        """Land the whole in-flight window (results become pollable), ack.
        The replica stays alive — this is the rolling-restart barrier, not
        shutdown."""
        return self._roundtrip("drain", "drained", timeout) is not None

    def stop(self, timeout: float = 60.0) -> None:
        """Graceful shutdown: drain, ack, exit; then join the worker."""
        try:
            self._send(("stop",))
        except (OSError, ValueError):
            pass
        else:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline and self.alive():
                msg = self._recv_nowait()
                if msg is None:
                    time.sleep(1e-3)
                elif msg[0] != "stopped":
                    self._buffered.append(msg)
                else:
                    break
        self.join(timeout)


class ThreadReplica(EngineReplica):
    """In-process replica: engine worker on a daemon thread, queue
    transport.  The tier-1 test mode — full router semantics, no process
    spawn.  `kill()` flips a flag the worker polls between messages and
    exits on WITHOUT landing anything: the closest a thread can come to a
    process crash (results already posted to the outbox stay visible,
    which is exactly the crash race the router's first-wins rule covers).
    """

    def __init__(self, replica_id: str, cfg, device: Optional[str] = None):
        super().__init__(replica_id, cfg, device)
        self._inbox: queue.Queue = queue.Queue()
        self._outbox: queue.Queue = queue.Queue()
        self._killed = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        cfg_kwargs = dataclasses.asdict(self.cfg)

        def recv(timeout: float) -> Optional[tuple]:
            try:
                return self._inbox.get(timeout=timeout) if timeout > 0 \
                    else self._inbox.get_nowait()
            except queue.Empty:
                return None

        self._thread = threading.Thread(
            target=_serve_loop,
            args=(self.replica_id, cfg_kwargs, recv, self._outbox.put,
                  self._killed.is_set, self.device),
            name=f"replica-{self.replica_id}",
            daemon=True,
        )
        self._thread.start()

    def alive(self) -> bool:
        return (self._thread is not None and self._thread.is_alive()
                and not self._killed.is_set())

    def kill(self) -> None:
        self._killed.set()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def _send(self, msg: tuple) -> None:
        if self._killed.is_set():
            raise OSError(f"replica {self.replica_id} is dead")
        self._inbox.put(msg)

    def _recv_nowait(self) -> Optional[tuple]:
        try:
            return self._outbox.get_nowait()
        except queue.Empty:
            return None


def _process_worker(conn, replica_id: str, cfg_kwargs: dict,
                    env: Optional[dict], device: str) -> None:
    """Child main for ProcessReplica.  Top-level (spawn target must be
    picklable by reference) and takes only plain kwargs: unpickling a
    ServeConfig here would import the engine — and therefore torch —
    before the env overrides land."""
    if env:
        os.environ.update(env)

    def recv(timeout: float) -> Optional[tuple]:
        try:
            if conn.poll(timeout):
                return conn.recv()
        except (EOFError, OSError):
            raise SystemExit(0) from None  # parent went away
        return None

    def send(msg: tuple) -> None:
        conn.send(msg)

    _serve_loop(replica_id, cfg_kwargs, recv, send, lambda: False, device)


class ProcessReplica(EngineReplica):
    """Subprocess replica over a duplex Pipe, spawn context (a forked child
    cannot use CUDA).  `env` entries land in the child's os.environ BEFORE
    anything imports torch.  On the card each child opens its own CUDA
    context (a torch import and a context: seconds, paid at start)."""

    def __init__(self, replica_id: str, cfg, env: Optional[dict] = None,
                 device: Optional[str] = None):
        super().__init__(replica_id, cfg, device)
        self.env = dict(env) if env else None
        self._proc = None
        self._conn = None

    def start(self) -> None:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe(duplex=True)
        self._proc = ctx.Process(
            target=_process_worker,
            args=(child, self.replica_id, dataclasses.asdict(self.cfg),
                  self.env, self.device),
            name=f"replica-{self.replica_id}",
            daemon=True,
        )
        self._proc.start()
        child.close()  # parent keeps only its end

    def alive(self) -> bool:
        return self._proc is not None and self._proc.is_alive()

    def kill(self) -> None:
        if self._proc is not None:
            self._proc.kill()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._proc is not None:
            self._proc.join(timeout)

    def _send(self, msg: tuple) -> None:
        if self._conn is None:
            raise OSError(f"replica {self.replica_id} not started")
        self._conn.send(msg)

    def _recv_nowait(self) -> Optional[tuple]:
        try:
            if self._conn is not None and self._conn.poll(0):
                return self._conn.recv()
        except (EOFError, OSError):
            return None
        return None


def make_replica(mode: str, replica_id: str, cfg,
                 env: Optional[dict] = None,
                 device: Optional[str] = None) -> EngineReplica:
    """'thread' or 'process' -> a replica handle (not yet start()ed — the
    router starts what it registers) whose engine runs on `device` (None:
    the CUDA card)."""
    if mode == "thread":
        return ThreadReplica(replica_id, cfg, device=device)
    if mode == "process":
        return ProcessReplica(replica_id, cfg, env=env, device=device)
    raise ValueError(f"unknown replica mode {mode!r}: expected 'thread' "
                     "or 'process'")
