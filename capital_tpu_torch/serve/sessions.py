"""Streaming state-space sessions: the client half of the session protocol
(counterpart of capital_tpu/serve/sessions.py).

A session is a long-lived solve context whose block-tridiagonal chain
factor stays resident in the engine's FactorCache (token = session id)
while the client streams blocks through a sliding window:

* ``open``     — seed the resident chain from the initial window blocks
  (engine op ``session_open``; one O(nblocks·b³) factorization).
* ``append``   — extend the resident factor by the new blocks only
  (``session_append``, models/blocktri.extend from the stored carry).
* ``solve``    — both block sweeps against the resident factor
  (``session_solve``), at the request's ``accuracy_tier``
  ('guaranteed' refines against the session's own resident factor).
* ``contract`` (alias ``downdate``) — drop the k oldest blocks
  (``session_contract``, models/blocktri.contract: a pure slice of the
  resident factor).  ``append`` + ``contract`` slide the window at
  O(new blocks).
* ``close``    — release the resident factor.

The manager mirrors the resident chain with the window's (D, C) blocks, as
tensors on the engine's device, so every ``solve`` ships the current window
the guaranteed tier computes residuals against without a host round trip.
After ``contract`` the contracted factor is the marginal precision of the
surviving window, so the manager rebuilds its window head from the new head
factor block the engine returns: ``D[0] ← L_k·L_kᵀ``, ``C[0] ← 0``.

When the resident factor was evicted under cache pressure, the engine fails
the request with a ``SessionEvicted:`` error; the manager raises the typed
:class:`SessionEvicted` (dropping its mirror) so the client re-seeds through
:meth:`open`, which clears the tombstone and counts as a reseed.

The counters surface through :meth:`SessionManager.emit_session_stats` as
one ``serve:session_stats`` ledger record (the reference's schema; its
``obs.ledger.validate_session_stats`` reads it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from capital_tpu_torch.serve.executor import Response

#: schema tag of the session_stats block (the reference's value).
SESSION_STATS_SCHEMA = 1


class SessionEvicted(RuntimeError):
    """The session's resident factor was evicted under cache pressure.

    Raised by SessionManager methods when the engine answers with a
    ``SessionEvicted:`` failure; the local window mirror is dropped first,
    and :meth:`SessionManager.open` with a fresh window is the way back."""

    def __init__(self, sid: str, error: str):
        super().__init__(error)
        self.sid = sid


@dataclasses.dataclass
class _SessionState:
    """Mirror of one resident session chain."""

    b: int
    dtype: torch.dtype
    D: torch.Tensor      # (nblocks, b, b) current window diagonal blocks
    C: torch.Tensor      # (nblocks, b, b) current window couplings; C[0] == 0
    dropped: int = 0     # blocks contracted away since open
    appends: int = 0
    solves: int = 0
    contracts: int = 0

    @property
    def nblocks(self) -> int:
        return int(self.D.shape[0])


def _check_blocks(name: str, D, C, device, b: Optional[int] = None, dtype=None):
    D = torch.as_tensor(D, device=device)
    C = torch.as_tensor(C, device=device)
    if dtype is not None:
        D, C = D.to(dtype), C.to(dtype)
    if D.ndim != 3 or D.shape[1] != D.shape[2]:
        raise ValueError(f"{name}: D must be (nblocks, b, b), got {tuple(D.shape)}")
    if C.shape != D.shape:
        raise ValueError(f"{name}: C must ride D {tuple(D.shape)}, got {tuple(C.shape)}")
    if b is not None and D.shape[1] != b:
        raise ValueError(
            f"{name}: block size {D.shape[1]} does not match the session's b={b}")
    return D, C


class SessionManager:
    """open / append / solve / contract / close over a SolveEngine.

    Synchronous: each method submits one engine request and drains it
    (engine.solve), so the window mirror and the resident factor move in
    lockstep.  Methods return the engine's :class:`Response` (callers check
    ``ok``), except when the resident factor was evicted, which raises
    :class:`SessionEvicted`."""

    def __init__(self, engine):
        self.engine = engine  # guarded-by: <frozen>
        self._sessions: dict[str, _SessionState] = {}  # guarded-by: <owner-thread>
        self._known: set[str] = set()  # guarded-by: <owner-thread>  (ever-opened ids: reseed detection)
        self.opens = 0  # guarded-by: <owner-thread>
        self.reseeds = 0  # guarded-by: <owner-thread>
        self.appends = 0  # guarded-by: <owner-thread>
        self.solves = 0  # guarded-by: <owner-thread>
        self.contracts = 0  # guarded-by: <owner-thread>
        self.closes = 0  # guarded-by: <owner-thread>
        self.failures = 0  # guarded-by: <owner-thread>  (non-eviction failed responses)
        self.evicted_failures = 0  # guarded-by: <owner-thread>  (SessionEvicted raises)
        self.hits = 0  # guarded-by: <owner-thread>  (resident requests that found state)
        self.misses = 0  # guarded-by: <owner-thread>  (== evicted_failures)
        self.blocks_appended = 0  # guarded-by: <owner-thread>  (open + append blocks)
        self.blocks_dropped = 0  # guarded-by: <owner-thread>  (contracted blocks)

    @property
    def device(self) -> torch.device:
        return self.engine.grid.device

    # ---- protocol ----------------------------------------------------------

    def open(self, sid: str, D, C, *, deadline_ms: Optional[float] = None) -> Response:
        """Seed (or re-seed) session `sid` from the initial window blocks
        D, C = (nblocks, b, b).  C[0] is ignored (zeroed: the chain head
        has no predecessor).  Re-opening a known id is the recovery from
        :class:`SessionEvicted` and counts as a reseed."""
        sid = str(sid)
        D, C = _check_blocks("session open", D, C, self.device)
        b = int(D.shape[1])
        resp = self.engine.solve("session_open", torch.stack([D, C.to(D.dtype)]), factor_token=sid,
                                 deadline_ms=deadline_ms)
        self.opens += 1
        if sid in self._known:
            self.reseeds += 1
        self._known.add(sid)
        if not resp.ok:
            self.failures += 1
            self._sessions.pop(sid, None)
            return resp
        C = C.to(D.dtype).clone()
        C[0] = 0
        self._sessions[sid] = _SessionState(b=b, dtype=D.dtype, D=D.clone(), C=C)
        self.blocks_appended += int(D.shape[0])
        return resp

    def append(self, sid: str, D, C, *, deadline_ms: Optional[float] = None) -> Response:
        """Extend session `sid` by the new blocks D, C = (k, b, b) — C[0]
        is live (it couples the first new block to the window tail).  The
        mirror grows only when the engine confirms the factor did."""
        sid = str(sid)
        s = self._state(sid)
        D, C = _check_blocks("session append", D, C, self.device, s.b, s.dtype)
        resp = self.engine.solve("session_append", torch.stack([D, C]), factor_token=sid,
                                 deadline_ms=deadline_ms)
        if not resp.ok:
            return self._lose(sid, resp)
        self.hits += 1
        self.appends += 1
        s.appends += 1
        s.D = torch.cat([s.D, D])
        s.C = torch.cat([s.C, C])
        self.blocks_appended += int(D.shape[0])
        return resp

    def solve(self, sid: str, B, *, accuracy_tier: str = "balanced",
              deadline_ms: Optional[float] = None) -> Response:
        """Solve A_window · X = B against the resident factor; B = (nblocks,
        b, nrhs) rides the current window.  The engine composes [D; C; L;
        Wt] from the resident chain, so the wire carries one RHS and the
        window, never the factor."""
        sid = str(sid)
        s = self._state(sid)
        B = torch.as_tensor(B, device=self.device).to(s.dtype)
        if B.ndim != 3 or B.shape[0] != s.nblocks or B.shape[1] != s.b:
            raise ValueError(
                f"session solve: B must be (nblocks={s.nblocks}, b={s.b}, nrhs), got {tuple(B.shape)}")
        resp = self.engine.solve("session_solve", torch.stack([s.D, s.C]), B, factor_token=sid,
                                 accuracy_tier=accuracy_tier, deadline_ms=deadline_ms)
        if not resp.ok:
            return self._lose(sid, resp)
        self.hits += 1
        self.solves += 1
        s.solves += 1
        return resp

    def contract(self, sid: str, k: int) -> Response:
        """Drop the k oldest blocks (the sliding-window downdate).  The
        resident factor contracts by a slice; the mirror slides and
        rebuilds its head from the returned head factor block:
        D[0] ← L_k·L_kᵀ, C[0] ← 0 (models/blocktri.contract)."""
        sid = str(sid)
        s = self._state(sid)
        k = int(k)
        if not 0 < k < s.nblocks:
            raise ValueError(
                f"session contract: k={k} must satisfy 0 < k < "
                f"nblocks={s.nblocks} (dropping everything is close())")
        resp = self.engine.solve("session_contract", k, factor_token=sid)
        if not resp.ok:
            return self._lose(sid, resp)
        Lk = resp.x
        self.hits += 1
        self.contracts += 1
        s.contracts += 1
        s.D = s.D[k:].clone()
        s.C = s.C[k:].clone()
        s.D[0] = Lk @ Lk.mT
        s.C[0] = 0
        s.dropped += k
        self.blocks_dropped += k
        return resp

    #: protocol alias: `downdate` is the sliding-window contract
    downdate = contract

    def close(self, sid: str) -> Response:
        """Release the resident factor and the mirror.  Closing a session
        already gone succeeds (``response.x`` says whether a factor was
        resident)."""
        sid = str(sid)
        resp = self.engine.solve("session_close", None, factor_token=sid)
        self._sessions.pop(sid, None)
        self.closes += 1
        return resp

    # ---- window / pivot bookkeeping ---------------------------------------

    def window(self, sid: str):
        """Copies of the session's current (D, C) window blocks."""
        s = self._state(sid)
        return s.D.clone(), s.C.clone()

    def is_open(self, sid: str) -> bool:
        return str(sid) in self._sessions

    def pivot_offset(self, sid: str) -> int:
        """Rows preceding the current window head in whole-chain
        coordinates (every block ever streamed, contracted ones too)."""
        s = self._state(sid)
        return s.dropped * s.b

    def segment_offset(self, sid: str) -> int:
        """Whole-chain row offset of the next appended segment (equal to
        the failed segment's after a failed append: the window did not
        grow)."""
        s = self._state(sid)
        return (s.dropped + s.nblocks) * s.b

    def absolute_pivot(self, sid: str, info) -> int:
        """Map a segment-relative breakdown pivot (1-based ``info`` of a
        failed open / append) to the whole chain."""
        return self.segment_offset(sid) + int(info)

    # ---- internals ---------------------------------------------------------

    def _state(self, sid: str) -> _SessionState:
        s = self._sessions.get(str(sid))
        if s is None:
            raise KeyError(
                f"session {sid!r} is not open here — open() it first "
                "(after SessionEvicted, re-open with a fresh window)")
        return s

    def _lose(self, sid: str, resp: Response) -> Response:
        """Failed-response triage: eviction raises the typed exception
        (dropping the mirror); anything else returns the failed Response."""
        if resp.error and resp.error.startswith("SessionEvicted:"):
            self.misses += 1
            self.evicted_failures += 1
            self._sessions.pop(str(sid), None)
            raise SessionEvicted(sid, resp.error)
        self.failures += 1
        return resp

    # ---- stats -------------------------------------------------------------

    def stats(self) -> dict:
        """The session_stats counter block (the reference's keys)."""
        resolved = self.hits + self.misses
        return {
            "schema_version": SESSION_STATS_SCHEMA,
            "opens": self.opens,
            "reseeds": self.reseeds,
            "appends": self.appends,
            "solves": self.solves,
            "contracts": self.contracts,
            "closes": self.closes,
            "failures": self.failures,
            "evicted_failures": self.evicted_failures,
            "hits": self.hits,
            "misses": self.misses,
            # hit-rate over resident requests (append / solve / contract):
            # a miss is an evicted factor, priced as a full re-seed
            "hit_rate": (self.hits / resolved) if resolved else 1.0,
            "sessions_open": len(self._sessions),
            "sessions_known": len(self._known),
            "blocks_appended": self.blocks_appended,
            "blocks_dropped": self.blocks_dropped,
        }

    def emit_session_stats(self, path: Optional[str] = None, *, grid=None, config=None,
                           **extra) -> dict:
        """Assemble (and append, when `path` is given) one
        ``serve:session_stats`` ledger record carrying the counters; the
        manifest is the engine's grid and config unless given."""
        from capital_tpu_torch.obs import ledger

        rec = ledger.record(
            "serve:session_stats",
            ledger.manifest(grid=grid if grid is not None else self.engine.grid,
                            config=config or self.engine.cfg),
            session_stats=self.stats(),
            **extra,
        )
        if path:
            ledger.append(path, rec)
        return rec
