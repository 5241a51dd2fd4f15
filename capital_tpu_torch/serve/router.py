"""Router: the client-facing front end over N EngineReplicas sharing one
persistent warm-up manifest (counterpart of capital_tpu/serve/router.py,
the whole module; the reference's docs/SERVING.md "Multi-replica
serving").

The router owns submit/result tickets and three policies the single-engine
facade never needed:

* **dispatch** — `least_loaded` (fewest outstanding requests wins: best
  latency under a mixed load) or `bucket_affinity` (rendezvous-hash the
  (op, bucket) signature over the healthy replicas, so each replica's
  executable cache serves a stable bucket subset and stays hot; highest-
  random-weight hashing means a replica's death remaps ONLY its buckets,
  and with a shared ``persist_dir`` the remapped bucket was built at its
  new owner's warm-up from the manifest, not on the request path);
* **health** — liveness (`alive()`), a heartbeat (async pings with a pong
  deadline), and a consecutive-failure circuit; a replica that trips ANY
  of them is failed: its outbox is swept one final time (results that
  raced the crash still count, first-wins), and every ticket still
  unanswered is RE-DISPATCHED to a healthy replica — or parked until one
  registers — never dropped;
* **drain lifecycle** — `drain_replica()` stops admission to one replica
  and lands its whole window (the rolling-restart barrier); `resume`/
  `stop_replica`/`add_replica` complete the restart story.

HOST-ONLY MODULE: the router never touches a device — it moves numpy
arrays between client and replica transports, and importing it loads no
torch; the bucket signature is therefore a pure-python re-derivation of
the ladder lookup in serve/batching.bucket_for (same smallest-rung-that-
fits rule), read from the replicas' own ServeConfig so the two can't
disagree.

Threading: every public method is safe under the internal lock.  `pump()`
makes progress (poll outboxes, land results, run health checks, flush the
parked queue); call it from your dispatch loop, or `start()` a background
pump thread (the loadgen client modes do).
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Optional

import numpy as np

from capital_tpu_torch.obs import spans
from capital_tpu_torch.serve.replica import EngineReplica, Result

POLICIES = ("least_loaded", "bucket_affinity")


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Router policy knobs.

    policy: dispatch policy (POLICIES above).
    max_consecutive_failures: heartbeat misses that trip the circuit.
    ping_interval_s: heartbeat cadence (0 disables the heartbeat; liveness
        via alive() still runs every pump).
    ping_timeout_s: pong deadline before a miss is counted.  Generous by
        default — a replica mid-build answers late, not never, and the
        circuit exists for dead workers, not busy ones.
    """

    policy: str = "least_loaded"
    max_consecutive_failures: int = 3
    ping_interval_s: float = 0.25
    ping_timeout_s: float = 5.0


class RouterTicket:
    """Client handle for one routed request.  Keeps the host-side operands
    so a replica death can re-dispatch the request — the router's no-drop
    contract is exactly this copy."""

    __slots__ = ("request_id", "op", "A", "B", "tier", "deadline_ms",
                 "affinity", "t_enq", "replica_id", "attempts", "response",
                 "_event")

    def __init__(self, request_id: int, op: str, A, B,
                 tier: str = "balanced",
                 deadline_ms: Optional[float] = None,
                 affinity: Optional[str] = None):
        self.request_id = request_id       # guarded-by: <frozen>
        self.op = op                       # guarded-by: <frozen>
        self.A = A                         # guarded-by: <frozen>
        self.B = B                         # guarded-by: <frozen>
        self.tier = tier                   # guarded-by: <frozen>
        self.deadline_ms = deadline_ms     # guarded-by: <frozen>
        self.affinity = affinity           # guarded-by: <frozen>
        self.t_enq = time.monotonic()      # guarded-by: <frozen>
        # current owner; mutated only by the Router under ITS lock
        self.replica_id: Optional[str] = None  # guarded-by: <router-lock>
        self.attempts = 0                  # guarded-by: <router-lock>
        # written once (under the router lock) BEFORE _event.set(); the
        # client's read in result() is ordered by the event wait
        self.response: Optional[Result] = None  # guarded-by: <published-by: self._event>
        self._event = threading.Event()    # guarded-by: <self-sync>

    @property
    def done(self) -> bool:
        return self.response is not None

    def result(self, timeout: Optional[float] = None) -> Result:
        """Block until the result lands (someone must be pumping — the
        router's pump thread, or the caller between checks)."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} ({self.op}) not landed within "
                f"{timeout}s (is anything pumping the router?)"
            )
        return self.response


class _ReplicaState:
    """Router-side bookkeeping for one replica."""

    __slots__ = ("replica", "outstanding", "draining", "dead", "dispatched",
                 "completed", "consecutive_failures", "ping_pending",
                 "ping_sent_at", "last_pong")

    def __init__(self, replica: EngineReplica):
        self.replica = replica                   # guarded-by: <frozen>
        self.outstanding: dict[int, RouterTicket] = {}  # guarded-by: <router-lock>
        self.draining = False                    # guarded-by: <router-lock>
        self.dead = False                        # guarded-by: <router-lock>
        self.dispatched = 0                      # guarded-by: <router-lock>
        self.completed = 0                       # guarded-by: <router-lock>
        self.consecutive_failures = 0            # guarded-by: <router-lock>
        self.ping_pending: Optional[int] = None  # guarded-by: <router-lock>
        self.ping_sent_at = 0.0                  # guarded-by: <router-lock>
        self.last_pong = time.monotonic()        # guarded-by: <router-lock>


def _rung(ladder, v: int) -> Optional[int]:
    """Smallest ladder rung >= v (batching._pick's rule, re-derived pure)."""
    best = None
    for r in ladder:
        if r >= v and (best is None or r < best):
            best = r
    return best


def bucket_signature(op: str, a_shape, b_shape, dtype: str,
                     ladders: dict, tier: str = "balanced",
                     affinity: Optional[str] = None) -> tuple:
    """The affinity key: the (op, padded-shape) class this request batches
    into, derived from the same ladders the engine buckets with.  Oversize
    requests key on their exact shape — each oversize shape is its own
    executable anyway, so exact-shape affinity is the cache-friendly
    answer there too.  The accuracy tier joins the key because tiered
    requests build (and batch in) their own bucket programs — affinity
    must steer a guaranteed request to the replica whose cache holds the
    guaranteed executable, not merely the same-shape balanced one.

    An explicit `affinity` token DOMINATES the signature: every request
    carrying the same token keys identically, regardless of op, shape,
    dtype or tier.  This is the session-sticky contract (docs/SERVING.md
    'Streaming sessions'): a session's resident factor lives in exactly
    one replica's FactorCache, so ALL of its traffic — open, append,
    solve at any tier, contract, close, with their different operand
    shapes — must single-home to that replica.  Rendezvous hashing keeps
    the stickiness membership-stable: a replica death remaps only the
    sessions it owned (those re-seed loudly via SessionEvicted); every
    other session stays put."""
    if affinity is not None:
        return ("affinity", str(affinity))
    n_r = _rung(ladders["buckets"],
                a_shape[1] if op == "lstsq" else a_shape[0])
    k_r = (_rung(ladders["nrhs_buckets"], b_shape[1])
           if b_shape is not None else None)
    m_r = _rung(ladders["rows_buckets"], a_shape[0]) if op == "lstsq" else 0
    if n_r is None or m_r is None or (b_shape is not None and k_r is None):
        return ("oversize", op, str(dtype), tuple(a_shape),
                tuple(b_shape) if b_shape is not None else None)
    return (op, str(dtype), n_r, k_r, m_r, str(tier))


def _rendezvous(sig: tuple, replica_ids) -> str:
    """Highest-random-weight choice: every (sig, replica) pair hashes to a
    weight, the max wins.  Stable under membership change — removing one
    replica remaps only the signatures it owned."""
    best_id, best_w = None, b""
    for rid in replica_ids:
        w = hashlib.sha1(f"{rid}|{sig!r}".encode()).digest()
        if best_id is None or w > best_w:
            best_id, best_w = rid, w
    return best_id


class Router:
    """See module docstring.  Replicas register via add_replica (started if
    they aren't yet); ladders for the affinity signature come from the
    first replica's config and every later one must agree."""

    def __init__(self, cfg: RouterConfig = RouterConfig()):
        if cfg.policy not in POLICIES:
            raise ValueError(
                f"unknown dispatch policy {cfg.policy!r}: expected one of "
                f"{POLICIES}"
            )
        self.cfg = cfg                           # guarded-by: <frozen>
        self._lock = threading.RLock()           # guarded-by: <lock>
        self._states: dict[str, _ReplicaState] = {}  # guarded-by: self._lock
        self._tickets: dict[int, RouterTicket] = {}  # guarded-by: self._lock
        self._parked: list[RouterTicket] = []    # guarded-by: self._lock
        self._next_id = 0                        # guarded-by: self._lock
        self._ladders: Optional[dict] = None     # guarded-by: self._lock
        self._pump_thread: Optional[threading.Thread] = None  # guarded-by: self._lock
        self._pump_stop = threading.Event()      # guarded-by: <self-sync>
        # counters (docs/SERVING.md): completed counts first results only —
        # completed + len(parked) + sum(outstanding) always equals
        # dispatched-distinct, which is the no-drop invariant the tests pin
        self.dispatched = 0    # guarded-by: self._lock (distinct requests)
        self.completed = 0     # guarded-by: self._lock
        self.redispatched = 0  # guarded-by: self._lock (post-failure re-sends)
        self.duplicates = 0    # guarded-by: self._lock (crash-race seconds)
        self.failed_replicas = 0  # guarded-by: self._lock
        # exported span chains from every landed Result (spans.py is pure
        # Python — no torch enters this host-only module); emit_stats adds a
        # serve:trace record when any rode back.  The pump thread add()s
        # under the lock, so emit_trace must take it too.
        self.trace_log = spans.TraceLog()        # guarded-by: self._lock

    # ---- membership --------------------------------------------------------

    def add_replica(self, replica: EngineReplica, *, start: bool = True):
        with self._lock:
            rid = replica.replica_id
            if rid in self._states and not self._states[rid].dead:
                raise ValueError(f"replica id {rid!r} already registered")
            if start and not replica.alive():
                replica.start()
            lad = replica.ladders()
            if self._ladders is None:
                self._ladders = lad
            elif lad != self._ladders:
                raise ValueError(
                    f"replica {rid!r} ladders {lad} disagree with the "
                    f"router's {self._ladders} — affinity and bucketing "
                    "would diverge"
                )
            self._states[rid] = _ReplicaState(replica)
            self._flush_parked()
            return replica

    def replica_ids(self, *, healthy_only: bool = False) -> list[str]:
        with self._lock:
            return [rid for rid, st in self._states.items()
                    if not st.dead and (not healthy_only or not st.draining)]

    # ---- client surface ----------------------------------------------------

    def submit(self, op: str, A, B=None, *,
               accuracy_tier: str = "balanced",
               deadline_ms: Optional[float] = None,
               affinity: Optional[str] = None) -> RouterTicket:
        """Dispatch one request to a healthy replica; raises RuntimeError
        when none admits (every replica dead or draining) — admission
        control, not silent queueing.  Work already admitted is never
        subject to this: a failure re-dispatch parks instead.

        `accuracy_tier` rides the ticket (and the re-dispatch copy) to the
        replica's engine.submit — tier validation is the engine's job, so
        an invalid tier lands as a failed Result, not a router raise.

        `affinity` is the session-sticky token (typically the session id):
        under bucket_affinity it dominates the rendezvous signature so
        every request carrying it — regardless of op/shape/tier — routes
        to the one replica holding that session's resident factor (see
        bucket_signature)."""
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            t = RouterTicket(rid, op, np.asarray(A),
                             np.asarray(B) if B is not None else None,
                             tier=accuracy_tier, deadline_ms=deadline_ms,
                             affinity=affinity)
            st = self._pick(t)
            if st is None:
                raise RuntimeError(
                    "no healthy replica admits requests (all dead or "
                    "draining)"
                )
            self._tickets[rid] = t
            self.dispatched += 1
            self._dispatch(st, t)
            return t

    def pump(self, now: Optional[float] = None) -> int:
        """One progress round: poll every replica, land results, run the
        health checks, re-dispatch off dead replicas, flush the parked
        queue.  Returns results landed this round."""
        now = time.monotonic() if now is None else now
        with self._lock:
            landed = 0
            for st in list(self._states.values()):
                if st.dead:
                    continue
                for msg in st.replica.poll():
                    landed += self._on_message(st, msg, now)
                if st.replica.fatal is not None or not st.replica.alive():
                    self._fail_replica(st)
                    continue
                self._heartbeat(st, now)
            self._flush_parked()
            return landed

    def drain(self, timeout: float = 120.0) -> None:
        """Land everything everywhere: flush parked work, drain every live
        replica, collect the results (shutdown / test barrier)."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                self._flush_parked()
                live = [st for st in self._states.values() if not st.dead]
                for st in live:
                    # deliberate roundtrip under the lock: a concurrent
                    # pump() polling the same outbox would steal the ack
                    st.replica.drain(  # lint: allow-blocking-under-lock
                        timeout=max(0.1, deadline - time.monotonic()))
                self.pump()
                if not self._parked and not any(
                    st.outstanding for st in self._states.values()
                    if not st.dead
                ):
                    return
                # snapshot under the lock: the timeout report below runs
                # outside it, and unlocked len() reads would race the pump
                parked = len(self._parked)
                outstanding = sum(len(st.outstanding)
                                  for st in self._states.values())
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"router drain incomplete after {timeout}s: "
                    f"{parked} parked, {outstanding} outstanding"
                )
            time.sleep(1e-3)

    # ---- replica lifecycle (rolling restarts) ------------------------------

    def drain_replica(self, replica_id: str, timeout: float = 60.0) -> bool:
        """Stop admission to one replica and land its whole window.  The
        replica stays registered and alive (resume_replica re-admits) —
        this is the barrier a rolling restart runs behind."""
        with self._lock:
            st = self._states[replica_id]
            st.draining = True
            # hold the lock across the sync roundtrip: a concurrent pump()
            # polling the same outbox would steal the "drained" ack
            ok = st.replica.drain(timeout)  # lint: allow-blocking-under-lock
            self.pump()
            return ok

    def resume_replica(self, replica_id: str) -> None:
        with self._lock:
            self._states[replica_id].draining = False
            self._flush_parked()

    def stop_replica(self, replica_id: str, timeout: float = 60.0) -> None:
        """Graceful removal: drain, stop, sweep the outbox, deregister.
        Anything still unanswered (it shouldn't be, after a clean drain)
        re-dispatches rather than drops."""
        self.drain_replica(replica_id, timeout)
        with self._lock:
            st = self._states[replica_id]
            # sync stop ack under the lock, same reason as drain_replica
            st.replica.stop(timeout)  # lint: allow-blocking-under-lock
            self._sweep_and_redispatch(st)
            st.dead = True

    def kill_replica(self, replica_id: str) -> None:
        """Abrupt kill (tests / fault injection): the next pump() observes
        the death and re-dispatches the replica's in-flight requests."""
        with self._lock:
            self._states[replica_id].replica.kill()

    def start(self, interval_s: float = 0.002) -> None:
        """Run pump() on a background thread — the mode concurrent clients
        (loadgen) use: submit from any thread, block on ticket.result()."""
        with self._lock:
            if self._pump_thread is not None:
                return
            self._pump_stop.clear()

            def loop():
                while not self._pump_stop.is_set():
                    self.pump()
                    time.sleep(interval_s)

            self._pump_thread = threading.Thread(
                target=loop, name="router-pump", daemon=True)
            self._pump_thread.start()

    def stop(self, timeout: float = 60.0) -> None:
        """Stop pumping and gracefully stop every live replica."""
        with self._lock:
            t, self._pump_thread = self._pump_thread, None
        if t is not None:
            self._pump_stop.set()
            t.join(timeout)  # outside the lock: the pump loop takes it
        with self._lock:
            for rid in self.replica_ids():
                self.stop_replica(rid, timeout)

    # ---- warmup / stats ----------------------------------------------------

    def warmup(self, specs, timeout: float = 300.0) -> dict:
        """Warm every live replica over `specs`; {replica_id: unforeseen-build
        count (None = no ack)}.  With a shared persist_dir only the first
        cold replica should report fresh > 0."""
        out = {}
        with self._lock:  # keep pump() off the outboxes mid-roundtrip
            for rid in self.replica_ids():
                info = self._states[rid].replica.warmup(
                    specs, timeout)
                out[rid] = info["fresh"] if info else None
        return out

    def replica_stats(self, timeout: float = 30.0) -> dict:
        """{replica_id: request_stats snapshot (with raw sample
        populations)} for every live replica."""
        out = {}
        with self._lock:  # keep pump() off the outboxes mid-roundtrip
            for rid in self.replica_ids():
                snap = self._states[rid].replica.request_stats(
                    timeout)
                if snap is not None:
                    out[rid] = snap
        return out

    def counters(self) -> dict:
        with self._lock:
            return {
                "policy": self.cfg.policy,
                "replicas": len(self.replica_ids()),
                "dispatched": self.dispatched,
                "completed": self.completed,
                "redispatched": self.redispatched,
                "duplicates": self.duplicates,
                "failed_replicas": self.failed_replicas,
                "parked": len(self._parked),
                "per_replica": {
                    rid: {"dispatched": st.dispatched,
                          "completed": st.completed,
                          "outstanding": len(st.outstanding),
                          "draining": st.draining}
                    for rid, st in self._states.items() if not st.dead
                },
            }

    def emit_stats(self, path: Optional[str] = None, **extra) -> list[dict]:
        """One replica-tagged serve:request_stats record per live replica
        plus ONE aggregate record (stats.merge_snapshots) carrying the
        router block (the reference's `obs serve-report --aggregate` reads
        them as they are).
        Returns the records; appends them to `path` when given."""
        from capital_tpu_torch.obs import ledger
        from capital_tpu_torch.serve import stats as stats_mod

        per = self.replica_stats()
        recs = []
        for rid, snap in per.items():
            clean = {k: v for k, v in snap.items() if k != "samples"}
            recs.append(ledger.record(
                "serve:request_stats",
                ledger.manifest(config=self.cfg),
                request_stats=clean,
            ))
        if per:
            merged = stats_mod.merge_snapshots(list(per.values()))
            recs.append(ledger.record(
                "serve:request_stats",
                ledger.manifest(config=self.cfg),
                request_stats=merged,
                router={**self.counters(), **extra.pop("router", {})},
                **extra,
            ))
        if path:
            for rec in recs:
                ledger.append(path, rec)
        return recs

    def emit_trace(self, path: Optional[str] = None, **extra) -> dict:
        """One serve:trace record covering every trace the replicas
        marshalled back (replica-tagged span chains) — the multi-replica
        counterpart of SolveEngine.emit_trace.  Kept separate from
        emit_stats so consumers iterating its request_stats records never
        meet a foreign record kind."""
        with self._lock:  # the pump thread add()s traces under the lock
            return self.trace_log.emit(path, config=self.cfg, **extra)

    # ---- internals ---------------------------------------------------------

    def _healthy(self) -> list[_ReplicaState]:  # lock-held: self._lock
        return [st for st in self._states.values()
                if not st.dead and not st.draining
                and st.replica.fatal is None]

    def _pick(self, t: RouterTicket) -> Optional[_ReplicaState]:  # lock-held: self._lock
        healthy = self._healthy()
        if not healthy:
            return None
        if self.cfg.policy == "bucket_affinity" and self._ladders:
            sig = bucket_signature(
                t.op, t.A.shape, t.B.shape if t.B is not None else None,
                t.A.dtype, self._ladders, tier=t.tier, affinity=t.affinity,
            )
            rid = _rendezvous(sig, sorted(st.replica.replica_id
                                          for st in healthy))
            return self._states[rid]
        return min(healthy, key=lambda st: (len(st.outstanding),
                                            st.replica.replica_id))

    def _dispatch(self, st: _ReplicaState, t: RouterTicket) -> None:  # lock-held: self._lock
        """Hand one ticket to one replica; a transport failure fails the
        replica and re-routes (bounded by membership — each attempt
        removes the failed replica from the healthy set)."""
        while True:
            try:
                st.replica.submit(t.request_id, t.op, t.A, t.B,
                                  tier=t.tier, deadline_ms=t.deadline_ms)
            except OSError:
                self._fail_replica(st)
                nxt = self._pick(t)
                if nxt is None:
                    self._parked.append(t)
                    return
                st = nxt
                continue
            st.outstanding[t.request_id] = t
            st.dispatched += 1
            t.replica_id = st.replica.replica_id
            t.attempts += 1
            return

    def _on_message(self, st: _ReplicaState, msg: tuple, now: float) -> int:  # lock-held: self._lock
        kind = msg[0]
        if kind == "result":
            return self._land(st, msg[1], msg[2])
        if kind == "pong":
            st.last_pong = now
            st.consecutive_failures = 0
            if st.ping_pending == msg[1]:
                st.ping_pending = None
        # "fatal" is recorded on replica.fatal by poll(); stray sync acks
        # ("warmed"/"stats"/"drained") mean a sync caller timed out — inert
        return 0

    def _land(self, st: _ReplicaState, rid: int, payload: dict) -> int:  # lock-held: self._lock
        st.outstanding.pop(rid, None)
        t = self._tickets.get(rid)
        if t is None or t.response is not None:
            # crash race: the old owner answered after a re-dispatch (or
            # after the client already got the re-dispatched result).
            # First result wins; this one is dropped, visibly.
            self.duplicates += 1
            return 0
        t.response = Result(**payload, replica_id=st.replica.replica_id)
        trace = payload.get("trace")
        if trace is not None:
            # the replica's engine tagged its own replica_id; keep it
            # authoritative but fill it in when absent (older payloads)
            if not trace.get("replica_id"):
                trace = dict(trace, replica_id=st.replica.replica_id)
            self.trace_log.add(trace)
        t._event.set()
        st.completed += 1
        self.completed += 1
        return 1

    def _heartbeat(self, st: _ReplicaState, now: float) -> None:  # lock-held: self._lock
        if self.cfg.ping_interval_s <= 0:
            return
        if st.ping_pending is not None:
            if now - st.ping_sent_at > self.cfg.ping_timeout_s:
                st.consecutive_failures += 1
                st.ping_pending = None
                if (st.consecutive_failures
                        >= self.cfg.max_consecutive_failures):
                    self._fail_replica(st)
            return
        if now - st.ping_sent_at >= self.cfg.ping_interval_s:
            try:
                st.ping_pending = st.replica.ping_async()
            except OSError:
                self._fail_replica(st)
                return
            st.ping_sent_at = now

    def _fail_replica(self, st: _ReplicaState) -> None:  # lock-held: self._lock
        """Circuit open: final outbox sweep (crash-raced results still
        land), then re-dispatch everything unanswered; never drop."""
        if st.dead:
            return
        st.dead = True
        self.failed_replicas += 1
        self._sweep_and_redispatch(st)
        try:
            st.replica.kill()
        except OSError:
            pass

    def _sweep_and_redispatch(self, st: _ReplicaState) -> None:  # lock-held: self._lock
        for msg in st.replica.poll():
            self._on_message(st, msg, time.monotonic())
        pending = [t for t in st.outstanding.values() if t.response is None]
        st.outstanding.clear()
        for t in pending:
            self.redispatched += 1
            nxt = self._pick(t)
            if nxt is None:
                self._parked.append(t)
            else:
                self._dispatch(nxt, t)

    def _flush_parked(self) -> None:  # lock-held: self._lock
        if not self._parked or not self._healthy():
            return
        parked, self._parked = self._parked, []
        for t in parked:
            if t.response is not None:
                continue
            st = self._pick(t)
            if st is None:
                self._parked.append(t)
            else:
                self._dispatch(st, t)
