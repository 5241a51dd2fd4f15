"""The serve-plane invariant registry: the formal ledger identities
(counterpart of capital_tpu/lint/invariants.py, the same identities).

Every stats block the serve tier exports carries internal identities the
tests have so far asserted only at the END of whichever interleavings
pytest happened to produce — the router's no-drop identity, the
FactorCache byte ledger, the window coherence sum, the session manager's
miss/eviction pairing.  This module states each identity ONCE, as a
checkable function over the exported block, so three consumers share one
definition:

* the deterministic interleaving explorer (`lint/schedule.py`) checks
  every registered invariant after every scheduling step of every
  scripted scenario — an invariant that only holds at quiescence but
  breaks mid-schedule is exactly the bug class the explorer exists for;
* `tests/test_torch_lint.py` holds each identity on the port's real
  objects under every explored schedule;
* humans read the registry as the serve tier's concurrency contract
  (the reference's docs/SERVING.md "The locking model").

Each check takes the SAME dict the production code already exports
(`Router.counters()`, `FactorCache.stats()`, a closed `serve:window`
block, `SessionManager.stats()`) — no shadow state, so the invariant can
never drift from what the ledger records actually claim.  A check
returns None when the identity holds and a human-readable violation
string when it does not (the obs.ledger validator convention).

Host-only module: pure stdlib, imports nothing from serve/ — the
explorer hands it exported dicts, never live objects.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

#: Subject keys: the explorer probes map subject -> exported block.
ROUTER = "router"
FACTOR_CACHE = "factor_cache"
SERVE_WINDOW = "serve_window"
SESSIONS = "sessions"

SUBJECTS = (ROUTER, FACTOR_CACHE, SERVE_WINDOW, SESSIONS)


@dataclasses.dataclass(frozen=True)
class Invariant:
    """One formal identity over one exported stats block."""

    name: str
    subject: str
    description: str
    check: Callable[[dict], Optional[str]]

    def __post_init__(self):
        if self.subject not in SUBJECTS:
            raise ValueError(
                f"unknown invariant subject {self.subject!r}; "
                f"use one of {SUBJECTS}")


def _router_no_drop(c: dict) -> Optional[str]:
    """completed + parked + outstanding == dispatched (distinct requests).

    The router's whole fault story is this identity: a result lands
    (completed), waits for a healthy replica (parked), or is in flight on
    one (outstanding) — never silently gone.  `dispatched` counts
    DISTINCT requests; re-sends ride `redispatched` and crash-race second
    answers ride `duplicates`, so neither perturbs the sum."""
    outstanding = sum(per["outstanding"]
                      for per in c.get("per_replica", {}).values())
    lhs = c["completed"] + c["parked"] + outstanding
    if lhs != c["dispatched"]:
        return (f"no-drop identity broken: completed={c['completed']} + "
                f"parked={c['parked']} + outstanding={outstanding} = {lhs} "
                f"!= dispatched={c['dispatched']}")
    return None


def _router_counter_sanity(c: dict) -> Optional[str]:
    """All router counters are non-negative and per-replica completions
    never exceed per-replica dispatches (first-result-wins accounting)."""
    for k in ("dispatched", "completed", "redispatched", "duplicates",
              "failed_replicas", "parked"):
        if c[k] < 0:
            return f"router counter {k}={c[k]} went negative"
    for rid, per in c.get("per_replica", {}).items():
        if per["completed"] > per["dispatched"]:
            return (f"replica {rid!r} completed {per['completed']} > "
                    f"dispatched {per['dispatched']}")
    return None


def _cache_byte_ledger(s: dict) -> Optional[str]:
    """The per-entry byte ledger sums to the pool total, and the pool
    respects the budget except for the single-oversized-entry carve-out
    (put() keeps the newest entry even when it alone exceeds the
    budget)."""
    entry_sum = sum(s["entry_bytes"].values())
    if entry_sum != s["bytes"]:
        return (f"entry_bytes ledger sums to {entry_sum} but the pool "
                f"reports bytes={s['bytes']}")
    if len(s["entry_bytes"]) != s["entries"]:
        return (f"entry_bytes lists {len(s['entry_bytes'])} tokens but "
                f"entries={s['entries']}")
    if s["bytes"] > s["budget_bytes"] and s["entries"] > 1:
        return (f"pool holds {s['bytes']} bytes > budget "
                f"{s['budget_bytes']} with {s['entries']} entries — "
                "eviction must run until one entry remains")
    return None


def _cache_counter_conservation(s: dict) -> Optional[str]:
    """Counter conservation: every resident entry was installed and not
    yet evicted or released (overwrites re-install without adding an
    entry, hence the inequality), and the eviction-age histogram counts
    exactly the evictions."""
    for k in ("hits", "misses", "evictions", "installs", "released",
              "entries"):
        if s[k] < 0:
            return f"cache counter {k}={s[k]} went negative"
    if s["entries"] > s["installs"] - s["evictions"] - s["released"]:
        return (f"entries={s['entries']} exceeds installs="
                f"{s['installs']} - evictions={s['evictions']} - "
                f"released={s['released']} — an entry appeared without "
                "an install, or an eviction went uncounted")
    hist_total = sum(s["eviction_age_hist"].values())
    if hist_total != s["evictions"]:
        return (f"eviction_age_hist counts {hist_total} evictions but "
                f"the counter says {s['evictions']}")
    return None


def _window_coherence(w: dict) -> Optional[str]:
    """ok + failed + shed == requests, and the latency histogram covers
    exactly the requests that ran (shed requests never ran, so they
    carry no latency sample)."""
    total = w["ok"] + w["failed"] + w["shed"]
    if total != w["requests"]:
        return (f"window outcome split ok={w['ok']} + failed={w['failed']} "
                f"+ shed={w['shed']} = {total} != requests={w['requests']}")
    ran = w["ok"] + w["failed"]
    hist_total = sum(w["hist_ms"]["counts"])
    if hist_total != ran:
        return (f"latency histogram counts {hist_total} samples but "
                f"ok+failed={ran} requests ran")
    if w["sampled"] > ran:
        return (f"reservoir reports {w['sampled']} samples > {ran} "
                "requests that ran")
    return None


def _session_ledger(s: dict) -> Optional[str]:
    """misses == evicted_failures (the only miss is an evicted factor),
    reseeds <= opens (every reseed IS an open), hits == appends + solves
    + contracts (each resident-op success counts exactly one hit), and
    the window can't drop more blocks than were ever appended."""
    if s["misses"] != s["evicted_failures"]:
        return (f"misses={s['misses']} != evicted_failures="
                f"{s['evicted_failures']} — a miss that wasn't an "
                "eviction (or an uncounted eviction)")
    if s["reseeds"] > s["opens"]:
        return f"reseeds={s['reseeds']} > opens={s['opens']}"
    resident_ok = s["appends"] + s["solves"] + s["contracts"]
    if s["hits"] != resident_ok:
        return (f"hits={s['hits']} != appends={s['appends']} + solves="
                f"{s['solves']} + contracts={s['contracts']} = "
                f"{resident_ok}")
    if s["blocks_dropped"] > s["blocks_appended"]:
        return (f"blocks_dropped={s['blocks_dropped']} > blocks_appended="
                f"{s['blocks_appended']}")
    return None


#: The registry.  Order is stable (reports render in this order); names
#: are the rule-message vocabulary the explorer and the docs share.
REGISTRY: tuple[Invariant, ...] = (
    Invariant("router-no-drop", ROUTER,
              "completed + parked + outstanding == dispatched",
              _router_no_drop),
    Invariant("router-counter-sanity", ROUTER,
              "router counters non-negative; per-replica completed <= "
              "dispatched", _router_counter_sanity),
    Invariant("cache-byte-ledger", FACTOR_CACHE,
              "sum(entry_bytes) == bytes; bytes <= budget unless a single "
              "oversized entry", _cache_byte_ledger),
    Invariant("cache-counter-conservation", FACTOR_CACHE,
              "entries <= installs - evictions - released; eviction-age "
              "histogram counts == evictions", _cache_counter_conservation),
    Invariant("window-coherence", SERVE_WINDOW,
              "ok + failed + shed == requests; histogram covers exactly "
              "the ran population", _window_coherence),
    Invariant("session-ledger", SESSIONS,
              "misses == evicted_failures; reseeds <= opens; hits == "
              "appends + solves + contracts", _session_ledger),
)


def by_subject(subject: str) -> tuple[Invariant, ...]:
    return tuple(inv for inv in REGISTRY if inv.subject == subject)


def check(states: dict[str, dict]) -> list[str]:
    """Run every registered invariant whose subject appears in `states`
    (subject key -> exported block).  Returns violation strings prefixed
    with the invariant name, [] when everything holds.  A check that
    cannot even read its block (missing key) is itself a violation —
    a malformed block must never read as a passing one."""
    violations: list[str] = []
    for inv in REGISTRY:
        block = states.get(inv.subject)
        if block is None:
            continue
        try:
            msg = inv.check(block)
        except (KeyError, TypeError) as e:
            msg = f"block malformed for this invariant ({e!r})"
        if msg is not None:
            violations.append(f"{inv.name}: {msg}")
    return violations
