"""The engine's program cache (counterpart of capital_tpu/serve/cache.py,
the memory tier).

One built program per key — a bucket program (serve/program.Program: its
CUDA graph captured once on the card, its closure on the CPU) or an
oversize single's callable — with the reference's counters, so "steady
traffic builds nothing" stays assertable.  A "compile" is one build:
a capture on the card, a closure on the CPU.

The reference's persistent disk tier (`persist_dir`: serialized
executables shared across processes) has no counterpart: a captured CUDA
graph holds device pointers of the process that captured it.  A
`ServeConfig` with `persist_dir` set makes `SolveEngine` raise
NotImplementedError naming ROADMAP Queue A item 8 (persistent tier).
"""

from __future__ import annotations

from typing import Callable


class ExecutableCache:
    """`get(key, build)` resolves memory -> ``build()``, maintaining the
    counters `SolveEngine.cache_stats()` reports:

    * ``hits`` / ``misses`` — request-driven lookups (the steady-state
      zero-recompile gate reads these);
    * ``warmup_compiles`` — builds during warmup lookups (kept out of
      hit_rate);
    * ``compiles`` — every build, warmup or not.
    """

    def __init__(self):
        self._mem: dict[tuple, object] = {}
        self.hits = 0
        self.misses = 0
        self.warmup_compiles = 0
        self.compiles = 0

    def __len__(self) -> int:
        return len(self._mem)

    def __contains__(self, key: tuple) -> bool:
        return key in self._mem

    def get(self, key: tuple, build: Callable[[], object], *, warmup: bool = False):
        """Resolve `key` to a program; `build()` makes a fresh one (only on
        a miss).  `warmup` keeps the lookup out of the hit/miss counters."""
        exe = self._mem.get(key)
        if exe is not None:
            if not warmup:
                self.hits += 1
            return exe
        if not warmup:
            self.misses += 1
        self.compiles += 1
        if warmup:
            self.warmup_compiles += 1
        exe = build()
        self._mem[key] = exe
        return exe

    def stats(self) -> dict:
        """The cache block of `SolveEngine.cache_stats()` /
        serve:request_stats, the reference's keys.  hit_rate covers
        request-driven lookups only (warmup excluded)."""
        lookups = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "warmup_compiles": self.warmup_compiles,
            "compiles": self.compiles,
            "entries": len(self._mem),
            "hit_rate": (self.hits / lookups) if lookups else 1.0,
        }

    def programs(self) -> dict[tuple, object]:
        """Every cached bucket program (serve/program.Program), by key."""
        return {k: v for k, v in self._mem.items() if hasattr(v, "replays")}

    def replays(self) -> dict[tuple, int]:
        """Calls of each cached bucket program (graph replays on the card,
        closure calls on the CPU), by key."""
        return {k: p.replays for k, p in self.programs().items()}
