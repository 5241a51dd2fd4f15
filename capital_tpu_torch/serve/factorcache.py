"""FactorCache: a bounded, byte-budgeted pool of resident factors
(counterpart of capital_tpu/serve/factorcache.py).

The serve-side half of online factor maintenance: clients name a factor
with a token of their choosing, seed it once (`posv_cached` on a miss
refactors and installs; `blocktri_extend` on a fresh token seeds an
identity-carry chain; `session_open` seeds a session chain), then mutate it
in O(kn²) (`chol_update` / `chol_downdate`) or O(nblocks·b³)
(`blocktri_extend`, `session_append`) and solve against it (`posv_cached`,
`session_solve`) without re-shipping the matrix.

Policy, the reference's:

* **LRU over a byte budget** — `put` evicts least-recently-used entries
  until the pool fits `budget_bytes`; the newest entry is kept even when
  it alone exceeds the budget.  `lookup` refreshes recency.
* **Tombstones** — an evicted token is remembered, so the engine fails
  evicted-token traffic loudly while letting never-seen `blocktri_extend`
  tokens seed fresh chains.  `release` (the client's explicit drop)
  clears the tombstone too.
* **Counters** — hits / misses / evictions / installs / released /
  downdate_degrades, the resident bytes, the per-entry byte sizes and the
  eviction-age histogram on a deterministic operation clock; `stats()` is
  the `factor_cache` block of the `serve:request_stats` record.

Torch tensors share storage where JAX arrays are values, so `put` stores a
contiguous copy of every array on the pool's device: the engine hands it
views (the crop of a landed batch, `models/blocktri.contract`'s slices) and
client tensors (`install_factor`), and neither a later write to those nor
a view's hidden storage may change what is resident or what `nbytes`
counts.  `append_blocks` continues a resident chain with the same rule and
one copy: the prefix and the new blocks are written into one fresh buffer.  The cache is host-side bookkeeping keyed by client tokens: no
bucket program sees a token, so residency changes never rebuild a program,
and the engine's config hash leaves `ServeConfig.factor_cache_bytes` out.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

import torch


def _nbytes(arrays) -> int:
    return int(sum(a.numel() * a.element_size() for a in arrays))


@dataclasses.dataclass
class FactorEntry:
    """One resident factor.  `kind` is 'dense' (arrays = (R,), upper
    A = RᵀR), 'blocktri' (arrays = (L, Wt, carry): the chain factor in the
    models/blocktri representation plus the (b, b) diagonal carry the next
    extend continues from) or 'session' (the same arrays, owned by the
    streaming-session protocol, serve/sessions.py).  `meta` is engine
    bookkeeping (shapes / dtype for request validation).  `born` is the
    install position on the cache's operation clock, from which eviction
    ages are measured."""

    kind: str
    arrays: tuple
    nbytes: int
    meta: dict
    born: int = 0


class FactorCache:
    """See module docstring.  `device` is where the resident copies live
    (the engine's grid device).  Not thread-safe, like the engine that
    owns one."""

    def __init__(self, budget_bytes: int = 256 << 20, *, device):
        if budget_bytes <= 0:
            raise ValueError(
                f"factor cache budget must be positive, got {budget_bytes}")
        self.budget_bytes = int(budget_bytes)  # guarded-by: <frozen>
        self.device = torch.device(device)  # guarded-by: <frozen>
        self._entries: "OrderedDict[str, FactorEntry]" = OrderedDict()  # guarded-by: <owner-thread>
        self._tombstones: set[str] = set()  # guarded-by: <owner-thread>
        self.hits = 0  # guarded-by: <owner-thread>
        self.misses = 0  # guarded-by: <owner-thread>
        self.evictions = 0  # guarded-by: <owner-thread>
        self.installs = 0  # guarded-by: <owner-thread>
        self.released = 0  # guarded-by: <owner-thread>
        self.downdate_degrades = 0  # guarded-by: <owner-thread>
        # operation clock (ticks on lookup / put): eviction ages are
        # counted in cache operations, so the histogram replays exactly
        self._op_clock = 0  # guarded-by: <owner-thread>
        # eviction-age histogram: key = smallest power-of-two upper bound
        # on the evicted entry's age in operations (a string, for JSON)
        self._evict_age_hist: dict[str, int] = {}  # guarded-by: <owner-thread>

    # ---- residency ---------------------------------------------------------

    def lookup(self, token: str) -> Optional[FactorEntry]:
        """Resident entry for `token` (refreshes LRU recency) or None.
        Counts a hit or a miss — call once per request."""
        self._op_clock += 1
        e = self._entries.get(token)
        if e is None:
            self.misses += 1
            return None
        self.hits += 1
        self._entries.move_to_end(token)
        return e

    def peek(self, token: str) -> Optional[FactorEntry]:
        """lookup without counters or recency."""
        return self._entries.get(token)

    def evicted(self, token: str) -> bool:
        """Whether `token` was resident and got evicted (tombstoned)."""
        return token in self._tombstones

    def _resident_copy(self, a) -> torch.Tensor:
        return torch.as_tensor(a).detach().to(
            device=self.device, memory_format=torch.contiguous_format, copy=True)

    def put(self, token: str, kind: str, arrays, meta: dict) -> list[str]:
        """Install (or overwrite) a resident factor as contiguous copies;
        evicts LRU entries until the pool fits the byte budget (never the
        entry just installed).  Returns the evicted tokens."""
        return self._install(token, kind, tuple(self._resident_copy(a) for a in arrays), meta)

    def append_blocks(self, token: str, kind: str, L, Wt, meta: dict) -> list[str]:
        """Install the chain (L, Wt) of `kind` for `token`, continuing the
        resident chain of that kind when there is one: its blocks, then
        these.  Each array is written once, into a fresh contiguous buffer
        on the pool's device; the carry is a copy of the last diagonal
        block.  Evicts as `put` does and returns the evicted tokens."""
        prior = self._entries.get(token)
        if prior is not None and prior.kind == kind:
            L = torch.cat([prior.arrays[0], L.detach().to(self.device)], dim=0)
            Wt = torch.cat([prior.arrays[1], Wt.detach().to(self.device)], dim=0)
        else:
            L, Wt = self._resident_copy(L), self._resident_copy(Wt)
        return self._install(token, kind, (L, Wt, L[-1].clone()), meta)

    def _install(self, token: str, kind: str, arrays: tuple, meta: dict) -> list[str]:
        self._op_clock += 1
        prior = self._entries.get(token)
        e = FactorEntry(kind=kind, arrays=arrays, nbytes=_nbytes(arrays),
                        meta=dict(meta),
                        born=(prior.born if prior is not None
                              else self._op_clock))
        self._entries[token] = e
        self._entries.move_to_end(token)
        self._tombstones.discard(token)
        self.installs += 1
        evicted = []
        while (self.resident_bytes() > self.budget_bytes
               and len(self._entries) > 1):
            victim, v = self._entries.popitem(last=False)
            self._tombstones.add(victim)
            self.evictions += 1
            age = max(0, self._op_clock - v.born)
            key = str(1 << age.bit_length())
            self._evict_age_hist[key] = self._evict_age_hist.get(key, 0) + 1
            evicted.append(victim)
        return evicted

    def release(self, token: str) -> bool:
        """Explicit client drop; clears any tombstone.  Returns whether an
        entry was resident."""
        self._tombstones.discard(token)
        if token in self._entries:
            del self._entries[token]
            self.released += 1
            return True
        return False

    # ---- accounting --------------------------------------------------------

    def note_downdate_degrade(self) -> None:
        """A flagged downdate was degraded to a fresh refactor at landing."""
        self.downdate_degrades += 1

    def resident_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, token: str) -> bool:
        return token in self._entries

    def stats(self) -> dict:
        """The factor_cache counter block of `serve:request_stats` (the
        reference's keys; its `validate_request_stats` reads it)."""
        lookups = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "installs": self.installs,
            "released": self.released,
            "downdate_degrades": self.downdate_degrades,
            "entries": len(self._entries),
            "bytes": self.resident_bytes(),
            "budget_bytes": self.budget_bytes,
            "hit_rate": (self.hits / lookups) if lookups else 1.0,
            # per-entry byte sizes (token -> bytes) and the eviction-age
            # histogram (power-of-two operation-age bucket -> count)
            "entry_bytes": {t: e.nbytes for t, e in self._entries.items()},
            "eviction_age_hist": dict(self._evict_age_hist),
        }
