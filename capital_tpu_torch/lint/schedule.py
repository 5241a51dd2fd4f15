"""The concurrency sanitizer, dynamic layer: a deterministic
interleaving explorer for the serve host plane (counterpart of
capital_tpu/lint/schedule.py: the same scheduler and scenarios, run on the
port's Router, FactorCache and fault fixture).

The static layer (lint/concurrency.py) proves the LEXICAL discipline —
guarded attributes touched under their lock, no lock-order cycles — but
a lexically clean plane can still break its ledger identities under an
unlucky interleaving (a result landing between a kill and its sweep, an
eviction between a peek and a put).  This module makes those
interleavings a *search space* instead of a roll of the dice:

* a **cooperative scheduler** runs each scripted scenario's threads one
  at a time, choosing who proceeds at every yield point from a seeded
  RNG — so a schedule is a replayable list of thread names, not an OS
  accident;
* ``patched()`` swaps ``threading.Lock/RLock/Event`` for cooperative
  twins while a scenario is built and run, so the REAL production
  classes (the port's Router and friends) hit yield points at exactly their real
  synchronization points — no test doubles of the code under test;
* after every step, when no cooperative lock is held, the scenario's
  probe exports the same stats blocks production emits and the formal
  registry (lint/invariants.py) checks every identity — an invariant
  that only holds at quiescence but breaks mid-schedule is precisely
  the bug class this layer exists to catch;
* a violation aborts the run and greedily **shrinks** the recorded
  schedule (fewer context switches, same violation) into the minimal
  failing trace the report prints — the repro a human can read.

Determinism contract: same scenario + same seed -> same choices -> same
trace (tests pin this).  Scenario code must therefore avoid control flow
on wall-clock time; the four shipped scenarios disable the router
heartbeat (``ping_interval_s=0``) for exactly this reason.

Semantics notes (documented, deliberate):

* an **unregistered** thread (the scheduler itself, running a probe)
  takes free cooperative locks silently and never yields — probes run
  only at lock-quiescent points, so the lock is always free;
* a timed ``Event.wait`` fires its timeout only under *starvation* (no
  other thread runnable) — a sound under-approximation that keeps
  schedules productive instead of spuriously timing out;
* all live threads blocked with no timed waiter = **deadlock**, reported
  as a violation with the trace that got there.

Host-only module: pure stdlib (the scripted replica moves no device
data); imports serve/ lazily inside the scenario builders so the static
pass can lint this file like any other.  The FactorCache scenario imports
torch there too: the cache holds CPU tensors, whose eviction logic does
not depend on the device.
"""

from __future__ import annotations

import _thread
import contextlib
import dataclasses
import random
import threading
from typing import Callable, Optional

from capital_tpu_torch.lint import invariants, rules

INTERLEAVING = "interleaving-violation"

#: Captured at import: the real classes, immune to patched().
_REAL_THREAD = threading.Thread
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_EVENT = threading.Event

_MAX_STEPS = 5000


class _Abort(BaseException):
    """Raised inside scenario threads to unwind them at teardown; a
    BaseException so scenario code's ``except Exception`` can't eat it."""


@dataclasses.dataclass
class Violation:
    kind: str          # invariant | deadlock | scenario-check |
    #                    thread-exception | overrun
    messages: list
    step: int


@dataclasses.dataclass
class ScheduleResult:
    """One run: the schedule taken and what it found."""

    scenario: str
    seed: int
    choices: list      # thread name chosen at each step
    trace: list        # (step, thread, reason)
    violation: Optional[Violation]

    def render_trace(self) -> str:
        lines = [f"  step {s:3d}: {t:<12s} {r}" for s, t, r in self.trace]
        return "\n".join(lines)


class CoopThread:
    """One scripted thread under the scheduler: a real OS thread that
    only ever runs between a gate release and its next yield."""

    def __init__(self, sched: "CoopScheduler", name: str, fn: Callable):
        self.sched = sched
        self.name = name
        self.fn = fn
        self.gate = _thread.allocate_lock()
        self.gate.acquire()
        self.state = "ready"            # ready | blocked | finished
        self.blocked_on = None          # ("lock", lock) | ("event", ev, timeout)
        self.timed_out = False          # scheduler fired a starvation timeout
        self.error: Optional[BaseException] = None
        self.thread = _REAL_THREAD(target=self._main, daemon=True,
                                   name=f"coop-{name}")

    def _main(self):
        self.sched._by_ident[threading.get_ident()] = self
        self.gate.acquire()             # wait to be scheduled the first time
        try:
            if self.sched._aborting:
                raise _Abort()
            self.fn()
        except _Abort:
            pass
        except BaseException as e:      # lint: allow-broad-except — reported as a violation
            self.error = e
        finally:
            self.state = "finished"
            self.sched._gate.release()  # hand control back for good


class CoopScheduler:
    """The one-runnable-thread-at-a-time scheduler.  Every context
    switch is a (step, thread, reason) trace entry; the chosen thread
    names are the schedule, replayable via ``forced``."""

    def __init__(self, seed: int = 0, forced: Optional[list] = None):
        self.rng = random.Random(seed)
        self.forced = list(forced) if forced else []
        self.threads: list[CoopThread] = []
        self._by_ident: dict[int, CoopThread] = {}
        self._gate = _thread.allocate_lock()
        self._gate.acquire()
        self._aborting = False
        self._lock_seq = 0
        self.locks: list = []           # every coop lock built under patched()
        self.trace: list = []
        self.choices: list = []
        self.step = 0

    # ---- thread-side API ---------------------------------------------------

    def current(self) -> Optional[CoopThread]:
        return self._by_ident.get(threading.get_ident())

    def yield_point(self, reason: str = "yield") -> None:
        """Hand control to the scheduler; returns when re-scheduled.
        No-op from unregistered threads (probes never yield)."""
        t = self.current()
        if t is None:
            return
        t.blocked_on = ("yield", reason)
        self._switch(t)

    def _switch(self, t: CoopThread) -> None:
        self._gate.release()
        t.gate.acquire()
        if self._aborting:
            raise _Abort()

    def block_on_lock(self, t: CoopThread, lock) -> None:
        t.state = "blocked"
        t.blocked_on = ("lock", lock)
        self._switch(t)

    def wait_event(self, ev: "CoopEvent", timeout: Optional[float]) -> bool:
        t = self.current()
        if t is None:                   # unregistered: real (raw-lock) wait
            return ev._raw_wait(timeout)
        while not ev._flag:
            t.state = "blocked"
            t.blocked_on = ("event", ev, timeout)
            self._switch(t)
            if t.timed_out:
                t.timed_out = False
                return False
        return True

    # ---- scheduler loop ----------------------------------------------------

    def _runnable(self, t: CoopThread) -> bool:
        if t.state == "finished":
            return False
        if t.state == "ready":
            return True
        kind = t.blocked_on[0]
        if kind == "lock":
            return t.blocked_on[1]._free_for(t)
        if kind == "event":
            return t.blocked_on[1]._flag
        return True

    def _reason(self, t: CoopThread) -> str:
        if t.blocked_on is None:
            return "start"
        kind = t.blocked_on[0]
        if kind == "yield":
            return t.blocked_on[1]
        if kind == "lock":
            return f"acquire {t.blocked_on[1].name}"
        if kind == "event":
            return f"event-wait {'set' if t.blocked_on[1]._flag else 'wake'}"
        return kind

    def run(self, ctx: "ScenarioCtx", max_steps: int = _MAX_STEPS
            ) -> Optional[Violation]:
        for name, fn in ctx.threads:
            self.threads.append(CoopThread(self, name, fn))
        for t in self.threads:
            t.thread.start()
        violation: Optional[Violation] = None
        try:
            while True:
                live = [t for t in self.threads if t.state != "finished"]
                if not live:
                    break
                runnable = [t for t in live if self._runnable(t)]
                if not runnable:
                    timed = sorted(
                        (t for t in live if t.blocked_on
                         and t.blocked_on[0] == "event"
                         and t.blocked_on[2] is not None),
                        key=lambda t: t.name)
                    if timed:           # starvation: fire one timeout
                        timed[0].timed_out = True
                        runnable = [timed[0]]
                    else:
                        violation = Violation("deadlock", [
                            "all live threads blocked: " + ", ".join(
                                f"{t.name} on {self._reason(t)}"
                                for t in sorted(live, key=lambda x: x.name))
                        ], self.step)
                        break
                if self.step < len(self.forced):
                    chosen = next(
                        (t for t in runnable
                         if t.name == self.forced[self.step]), None)
                    if chosen is None:
                        chosen = sorted(runnable, key=lambda t: t.name)[0]
                else:
                    chosen = self.rng.choice(
                        sorted(runnable, key=lambda t: t.name))
                self.choices.append(chosen.name)
                self.trace.append(
                    (self.step, chosen.name, self._reason(chosen)))
                self.step += 1
                chosen.state = "ready"
                chosen.gate.release()
                self._gate.acquire()    # thread yielded, blocked or finished
                violation = self._check(ctx)
                if violation is not None:
                    break
                if self.step >= max_steps:
                    violation = Violation("overrun", [
                        f"schedule exceeded {max_steps} steps — a scenario "
                        "thread is not making progress"], self.step)
                    break
        finally:
            self._teardown()
        if violation is None:
            violation = self._thread_errors()
            if violation is None and ctx.finish is not None:
                msgs = ctx.finish()
                if msgs:
                    violation = Violation("scenario-check", list(msgs),
                                          self.step)
        return violation

    def _check(self, ctx: "ScenarioCtx") -> Optional[Violation]:
        v = self._thread_errors()
        if v is not None:
            return v
        quiescent = all(lk._owner is None for lk in self.locks)
        if quiescent and ctx.probe is not None:
            msgs = invariants.check(ctx.probe())
            if msgs:
                return Violation("invariant", msgs, self.step)
        if quiescent and ctx.check is not None:
            msgs = ctx.check()
            if msgs:
                return Violation("scenario-check", list(msgs), self.step)
        return None

    def _thread_errors(self) -> Optional[Violation]:
        errs = [t for t in self.threads if t.error is not None]
        if errs:
            return Violation("thread-exception", [
                f"{t.name}: {t.error!r}" for t in errs], self.step)
        return None

    def _teardown(self) -> None:
        """Unwind every live thread: each raises _Abort at its next wake
        and finishes (finally blocks still run — lock release is lenient
        during abort)."""
        self._aborting = True
        for _ in range(len(self.threads) * 4):
            live = [t for t in self.threads if t.state != "finished"]
            if not live:
                break
            t = live[0]
            t.gate.release()
            self._gate.acquire()
        for t in self.threads:
            t.thread.join(timeout=5.0)

    # ---- patched primitives ------------------------------------------------

    def _new_lock(self, reentrant: bool) -> "CoopLock":
        self._lock_seq += 1
        lk = CoopLock(self, f"{'rlock' if reentrant else 'lock'}"
                      f"#{self._lock_seq}", reentrant)
        self.locks.append(lk)
        return lk

    @contextlib.contextmanager
    def patched(self):
        """Swap threading.Lock/RLock/Event for cooperative twins bound
        to this scheduler, for the duration of one scenario build+run.
        Process-global by nature — run one scenario at a time."""
        saved = (threading.Lock, threading.RLock, threading.Event)
        threading.Lock = lambda: self._new_lock(False)
        threading.RLock = lambda: self._new_lock(True)
        threading.Event = lambda: CoopEvent(self)
        try:
            yield self
        finally:
            threading.Lock, threading.RLock, threading.Event = saved


class CoopLock:
    """Cooperative Lock/RLock.  Acquisition yields once (the exploration
    point) and then blocks cooperatively until free; release never
    yields, so finally-block unwinding can't deadlock the scheduler."""

    def __init__(self, sched: CoopScheduler, name: str, reentrant: bool):
        self.sched = sched
        self.name = name
        self.reentrant = reentrant
        self._owner = None              # CoopThread | "external"
        self._count = 0

    def _free_for(self, t) -> bool:
        return self._owner is None or (self.reentrant and self._owner is t)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        t = self.sched.current()
        if t is None:
            # unregistered thread (probe): locks are free at quiescence,
            # and probes may re-enter (counters() -> replica_ids())
            if self._owner == "external" and self.reentrant:
                self._count += 1
                return True
            if self._owner is not None:
                raise RuntimeError(
                    f"unregistered thread acquiring held coop lock "
                    f"{self.name} (probe outside quiescence?)")
            self._owner, self._count = "external", 1
            return True
        if self.reentrant and self._owner is t:
            self._count += 1
            return True
        self.sched.yield_point(f"acquire {self.name}")
        while not self._free_for(t):
            if not blocking:
                return False
            self.sched.block_on_lock(t, self)
        self._owner, self._count = t, 1
        return True

    def release(self) -> None:
        t = self.sched.current()
        if self._owner is None:
            if self.sched._aborting:
                return
            raise RuntimeError(f"release of unheld coop lock {self.name}")
        if t is not None and self._owner is not t \
                and self._owner != "external" and not self.sched._aborting:
            raise RuntimeError(
                f"{t.name} releasing coop lock {self.name} owned by "
                f"{getattr(self._owner, 'name', self._owner)}")
        self._count -= 1
        if self._count <= 0:
            self._owner, self._count = None, 0

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    def locked(self) -> bool:
        return self._owner is not None


class CoopEvent:
    """Cooperative Event.  set()/is_set() never yield; wait() from a
    scripted thread blocks cooperatively (timeouts fire only under
    starvation — see module docstring); wait() from an unregistered
    thread falls back to a raw-lock wait so threading.Thread's own
    _started handshake keeps working under patched()."""

    def __init__(self, sched: CoopScheduler):
        self.sched = sched
        self._flag = False
        self._raw = _thread.allocate_lock()
        self._raw.acquire()

    def is_set(self) -> bool:
        return self._flag

    def set(self) -> None:
        self._flag = True
        if self._raw.locked():
            self._raw.release()

    def clear(self) -> None:
        self._flag = False
        self._raw.acquire(False)

    def _raw_wait(self, timeout: Optional[float]) -> bool:
        if self._flag:
            return True
        got = self._raw.acquire(True, -1 if timeout is None else timeout)
        if got:
            self._raw.release()
        return self._flag

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.sched.wait_event(self, timeout)


# ---- scenarios -------------------------------------------------------------


class ScenarioCtx:
    """What a builder hands the scheduler: the scripted threads, the
    per-step invariant probe (subject -> exported stats block), an
    optional per-step custom check, and an optional end-of-run check."""

    def __init__(self, threads, probe=None, check=None, finish=None):
        self.threads = list(threads)    # [(name, fn)]
        self.probe = probe              # () -> {subject: block}
        self.check = check              # () -> [violation str]
        self.finish = finish            # () -> [violation str]


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    build: Callable[[CoopScheduler], ScenarioCtx]
    #: imports the builder needs, run before patched(): a module that
    #: builds locks at import (torch does) must not get cooperative ones
    prepare: Optional[Callable[[], None]] = None


class ScriptedReplica:
    """A host-only replica fake speaking the EngineReplica transport
    protocol the Router drives (submit/poll/drain/ladders/kill/...).
    Requests sit in an inbox until ``service()`` moves them to the
    outbox as ok results — the in-flight window every router race needs.
    Used only by the explorer scenarios; production code never sees it."""

    def __init__(self, replica_id: str, auto: bool = False):
        self.replica_id = replica_id
        self.fatal = None
        self.auto = auto                # answer at submit time
        self._killed = False
        self._inbox: list = []
        self._outbox: list = []
        self._pings = 0

    def alive(self) -> bool:
        return not self._killed

    def start(self):
        return self

    def ladders(self) -> dict:
        return {"buckets": [4, 8], "nrhs_buckets": [1, 4],
                "rows_buckets": [4, 8]}

    def submit(self, request_id: int, op: str, A, B=None, *,
               tier: str = "balanced", deadline_ms=None) -> None:
        if self._killed:
            raise OSError(f"replica {self.replica_id} is dead")
        self._inbox.append((request_id, op))
        if self.auto:
            self.service()

    def service(self, n: Optional[int] = None) -> int:
        """Move up to `n` pending requests (all, by default) to the
        outbox as ok results."""
        if self._killed:
            return 0
        moved = 0
        while self._inbox and (n is None or moved < n):
            rid, op = self._inbox.pop(0)
            self._outbox.append(("result", rid, {
                "request_id": rid, "op": op, "ok": True, "x": 0.0,
                "info": 0, "error": None, "bucket": None, "batched": False,
                "latency_s": 0.0,
            }))
            moved += 1
        return moved

    def poll(self) -> list:
        out, self._outbox = self._outbox, []
        return out

    def drain(self, timeout=None) -> bool:
        if self._killed:
            return False
        self.service()
        return True

    def warmup(self, specs, timeout=None) -> dict:
        return {"fresh": 0}

    def request_stats(self, timeout=None):
        return None

    def stop(self, timeout=None) -> bool:
        self._killed = True
        return True

    def kill(self) -> None:
        # in-flight inbox work is lost (never answered); the outbox —
        # results that raced the crash — survives for the final sweep
        self._killed = True

    def ping_async(self) -> int:
        if self._killed:
            raise OSError(f"replica {self.replica_id} is dead")
        self._pings += 1
        return self._pings


def _router(policy: str = "least_loaded"):
    from capital_tpu_torch.serve.router import Router, RouterConfig

    # heartbeat off: its branches key on wall-clock time, which would
    # break the same-seed-same-trace determinism contract
    return Router(RouterConfig(policy=policy, ping_interval_s=0.0))


def _build_submit_vs_pump(sched: CoopScheduler) -> ScenarioCtx:
    """Clients submitting while the pump reaps: the no-drop identity
    must hold at every step, not just after the dust settles."""
    router = _router()
    reps = [ScriptedReplica("r0"), ScriptedReplica("r1")]
    for r in reps:
        router.add_replica(r)
    done = {"flag": False}
    tickets: list = []

    def client():
        for i in range(3):
            tickets.append(router.submit("posv", [[float(i + 2)]], [[1.0]]))
            sched.yield_point(f"submitted #{i}")
        for t in tickets:
            if not t.result(timeout=5.0).ok:
                raise AssertionError("scripted replica answered not-ok")
        done["flag"] = True

    def server():
        for _ in range(60):
            if done["flag"]:
                return
            for r in reps:
                r.service(n=1)
            sched.yield_point("serviced")

    def pump():
        for _ in range(60):
            if done["flag"]:
                return
            router.pump()
            sched.yield_point("pumped")

    def finish():
        missing = [t.request_id for t in tickets if t.response is None]
        return ([f"tickets never landed: {missing}"] if missing else [])

    return ScenarioCtx(
        threads=[("client", client), ("server", server), ("pump", pump)],
        probe=lambda: {invariants.ROUTER: router.counters()},
        finish=finish)


def _build_kill_vs_landing(sched: CoopScheduler) -> ScenarioCtx:
    """A replica kill racing its own landing result: whichever side wins
    each schedule, the ticket must land exactly once (first-result-wins;
    re-dispatch covers the loss) and no-drop must hold throughout."""
    router = _router()
    r0, r1 = ScriptedReplica("r0"), ScriptedReplica("r1")
    router.add_replica(r0)
    router.add_replica(r1)
    done = {"flag": False}
    tickets: list = []

    def client():
        # least_loaded ties break on replica id, so this lands on r0
        tickets.append(router.submit("posv", [[4.0]], [[1.0]]))
        sched.yield_point("submitted")
        if not tickets[0].result(timeout=5.0).ok:
            raise AssertionError("scripted replica answered not-ok")
        done["flag"] = True

    def server():
        for _ in range(60):
            if done["flag"]:
                return
            r0.service()
            r1.service()
            sched.yield_point("serviced")

    def killer():
        sched.yield_point("about to kill r0")
        router.kill_replica("r0")

    def pump():
        for _ in range(60):
            if done["flag"]:
                return
            router.pump()
            sched.yield_point("pumped")

    def finish():
        out = []
        if not tickets or tickets[0].response is None:
            out.append("the killed request never landed (dropped)")
        c = router.counters()
        if c["completed"] != 1:
            out.append(f"completed={c['completed']} != 1 "
                       "(first-result-wins broken)")
        return out

    return ScenarioCtx(
        threads=[("client", client), ("killer", killer),
                 ("server", server), ("pump", pump)],
        probe=lambda: {invariants.ROUTER: router.counters()},
        finish=finish)


def _import_factorcache() -> None:
    import torch  # noqa: F401

    from capital_tpu_torch.serve import factorcache  # noqa: F401


def _build_evict_vs_append(sched: CoopScheduler) -> ScenarioCtx:
    """A session append landing while the FactorCache evicts under byte
    pressure — the window a session append's landing spans (peek, then
    concatenate, then put).  The scripted landing follows
    the engine's fixed contract: a mid-flight eviction must surface as a
    LOUD SessionEvicted, never a silently truncated re-install."""
    import torch

    from capital_tpu_torch.serve.factorcache import FactorCache

    blk = torch.zeros((1, 8, 8), dtype=torch.float32)   # 256 B per block
    cache = FactorCache(budget_bytes=3 * blk.numel() * blk.element_size(), device="cpu")
    cache.put("sess", "session", (blk, blk), {"nblocks": 1})
    outcome: dict = {}

    def landing():
        ent = cache.peek("sess")
        sched.yield_point("peeked resident chain")
        if ent is None:
            if cache.evicted("sess"):
                outcome["result"] = "SessionEvicted: chain evicted mid-flight"
            else:
                outcome["result"] = "BUG: no entry and no tombstone"
            return
        L = torch.cat([ent.arrays[0], blk], dim=0)
        sched.yield_point("concatenated suffix")
        cache.put("sess", "session", (L, L), {"nblocks": int(L.shape[0])})
        outcome["result"] = "installed"
        outcome["nblocks"] = int(L.shape[0])

    def evictor():
        big = torch.zeros((2, 8, 8), dtype=torch.float32)
        cache.put("other-a", "dense", (big,), {})
        sched.yield_point("installed other-a")
        cache.put("other-b", "dense", (big,), {})

    def finish():
        res = outcome.get("result")
        if res is None:
            return ["landing thread recorded no outcome"]
        if res.startswith("BUG"):
            return [res]
        if res == "installed" and outcome.get("nblocks") != 2:
            return [f"installed a truncated chain: nblocks="
                    f"{outcome.get('nblocks')} != 2"]
        return []

    return ScenarioCtx(
        threads=[("landing", landing), ("evictor", evictor)],
        probe=lambda: {invariants.FACTOR_CACHE: cache.stats()},
        finish=finish)


def _build_drain_vs_submit(sched: CoopScheduler) -> ScenarioCtx:
    """drain_replica racing submit on a single-replica router: every
    submit either admits (and must land) or is refused loudly by
    admission control — never queued into a draining replica silently."""
    router = _router()
    r0 = ScriptedReplica("r0", auto=True)
    router.add_replica(r0)
    done = {"flag": False}
    accepted: list = []
    rejected = {"n": 0}

    def ops():
        router.drain_replica("r0", timeout=5.0)
        sched.yield_point("drained r0")
        router.resume_replica("r0")

    def client():
        for i in range(2):
            try:
                accepted.append(
                    router.submit("posv", [[float(i + 2)]], [[1.0]]))
            except RuntimeError:
                rejected["n"] += 1      # admission control said no — fine
            sched.yield_point(f"attempt #{i}")
        for t in accepted:
            t.result(timeout=5.0)
        done["flag"] = True

    def pump():
        for _ in range(60):
            if done["flag"]:
                return
            router.pump()
            sched.yield_point("pumped")

    def finish():
        out = []
        if len(accepted) + rejected["n"] != 2:
            out.append(f"attempts split {len(accepted)} accepted + "
                       f"{rejected['n']} rejected != 2")
        missing = [t.request_id for t in accepted if t.response is None]
        if missing:
            out.append(f"admitted tickets never landed: {missing}")
        return out

    return ScenarioCtx(
        threads=[("ops", ops), ("client", client), ("pump", pump)],
        probe=lambda: {invariants.ROUTER: router.counters()},
        finish=finish)


#: The shipped sweep: one scenario per race class the serve plane runs.
SCENARIOS: tuple[Scenario, ...] = (
    Scenario("submit-vs-pump",
             "clients submitting while the pump thread reaps results",
             _build_submit_vs_pump),
    Scenario("kill-vs-landing",
             "replica kill racing its own landing result",
             _build_kill_vs_landing),
    Scenario("evict-vs-append",
             "session append landing while the FactorCache evicts",
             _build_evict_vs_append, prepare=_import_factorcache),
    Scenario("drain-vs-submit",
             "drain_replica racing submit admission",
             _build_drain_vs_submit),
)


# ---- running, shrinking, reporting -----------------------------------------


def run_schedule(scenario: Scenario, seed: int,
                 forced: Optional[list] = None,
                 max_steps: int = _MAX_STEPS) -> ScheduleResult:
    """One deterministic run of `scenario` under `seed` (or a forced
    choice list — unrunnable forced choices fall back to the first
    runnable thread, so shrunk schedules always replay)."""
    if scenario.prepare is not None:
        scenario.prepare()
    sched = CoopScheduler(seed=seed, forced=forced)
    with sched.patched():
        ctx = scenario.build(sched)
        violation = sched.run(ctx, max_steps=max_steps)
    return ScheduleResult(scenario=scenario.name, seed=seed,
                          choices=list(sched.choices),
                          trace=list(sched.trace), violation=violation)


def shrink(scenario: Scenario, result: ScheduleResult) -> ScheduleResult:
    """Greedy trace minimization: repeatedly try to extend the previous
    thread's run across a context switch; keep any rewrite that still
    reproduces the same violation kind.  The violation already ends the
    run, so the tail is minimal by construction."""
    if result.violation is None:
        return result
    kind = result.violation.kind
    best = result
    improved = True
    rounds = 0
    while improved and rounds < 20:
        improved = False
        rounds += 1
        for i in range(1, len(best.choices)):
            if best.choices[i] == best.choices[i - 1]:
                continue
            cand = (best.choices[:i] + [best.choices[i - 1]]
                    + best.choices[i + 1:])
            res = run_schedule(scenario, seed=result.seed, forced=cand)
            if res.violation is not None and res.violation.kind == kind \
                    and len(res.choices) <= len(best.choices):
                best = res
                improved = True
                break
    return best


def explore(scenario: Scenario, schedules: int, seed: int = 0
            ) -> tuple[Optional[ScheduleResult], int]:
    """Sweep `schedules` seeded runs; on the first violation, shrink it
    and return (minimal failing result, runs taken).  (None, schedules)
    when every schedule holds every invariant."""
    for i in range(schedules):
        res = run_schedule(scenario, seed=seed + i)
        if res.violation is not None:
            return shrink(scenario, res), i + 1
    return None, schedules


def violation_finding(scenario: Scenario, res: ScheduleResult
                      ) -> rules.Finding:
    v = res.violation
    return rules.make(
        INTERLEAVING, rules.ERROR, f"schedule:{scenario.name}",
        f"[{v.kind}] " + "; ".join(v.messages)
        + f" (seed={res.seed}, step={v.step}; minimal schedule:\n"
        + res.render_trace() + ")",
    )


def lint_schedules(schedules: int = 200, seed: int = 0,
                   scenarios: Optional[tuple] = None) -> list[rules.Finding]:
    """The dynamic layer: sweep every scenario; error findings carry the
    minimal failing trace, info findings record the clean sweep size (so
    the ledger block proves how hard the explorer actually looked)."""
    findings: list[rules.Finding] = []
    for sc in (scenarios if scenarios is not None else SCENARIOS):
        failing, runs = explore(sc, schedules, seed=seed)
        if failing is not None:
            findings.append(violation_finding(sc, failing))
        else:
            findings.append(rules.make(
                INTERLEAVING, rules.INFO, f"schedule:{sc.name}",
                f"{runs} seeded schedules swept, every invariant held",
            ))
    return rules.sort_findings(findings)


def fault_scenario(mod) -> Scenario:
    """The self-check scenario over the committed broken fixture
    (tests/fixtures/concurrency_fault.py): two threads hammer the
    deliberately unguarded RacyCounter; the lost update MUST surface as
    a scenario-check violation or the explorer is dead."""

    def build(sched: CoopScheduler) -> ScenarioCtx:
        c = mod.RacyCounter(yield_point=sched.yield_point)

        def worker():
            for _ in range(2):
                c.increment()

        def check():
            if c.count != c.increments:
                return [f"racy-counter lost update: count={c.count} != "
                        f"increments={c.increments}"]
            return []

        return ScenarioCtx(
            threads=[("w1", worker), ("w2", worker)],
            check=check, finish=check)

    return Scenario("self-check-racy-counter",
                    "the committed broken fixture must fail", build)
