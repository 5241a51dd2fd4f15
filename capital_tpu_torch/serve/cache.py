"""The engine's program cache (counterpart of capital_tpu/serve/cache.py):
in-memory built programs, backed by an optional persistent warm-up
manifest.

The memory tier holds one built program per key — a bucket program
(serve/program.Program: its CUDA graph captured once on the card, its
closure on the CPU) or an oversize single's callable — with the
reference's counters, so "steady traffic builds nothing" stays
assertable.

The persistent tier (``ServeConfig.persist_dir``) cannot be the
reference's serialized executables: a captured CUDA graph holds device
pointers of the process that captured it, so nothing device-resident is
written to disk.  What carries across processes is the knowledge of WHICH
programs a deployment needs.  Every build under `persist_dir` appends one
JSON line to ``warmup_manifest.jsonl`` there: the program's key, the
recipe to rebuild it (`spec`), the engine scope (config hash and grid)
and a fingerprint — torch version, CUDA version, platform, device name
and `ops._build.sources_hash()` of the kernel sources.  An engine's
`warmup()` on a warm directory builds, besides its own specs, every
manifest key of its scope whose fingerprint matches, so a replica that
starts on a warm directory serves every bucket its peers built with no
build after warm-up — including buckets a router's affinity rebalance
hands it that its own warm-up specs never listed.  The kernels' own
on-disk tier is the nvcc build in ``build/capital_tpu_torch/``
(`ops/_build.py`: one library per source, named by its hash, renamed into
place atomically), which every process on the card loads.

Counters (the reference's names):

* ``hits`` / ``misses`` — request-driven memory lookups (a build on a
  foreseen key still counts a memory miss: the request paid a capture);
* ``compiles`` — builds the persistent tier did not foresee: every build
  without `persist_dir`, and with it every build of a key no manifest
  line of this scope and fingerprint held.  `--max-compiles` gates this;
* ``warmup_compiles`` — those of them made by warm-up lookups;
* ``disk`` (with `persist_dir`): ``hits`` builds the manifest foresaw
  (still a capture in this process), ``misses`` builds it did not,
  ``errors`` unreadable lines and failed appends, ``skips`` lines of
  another fingerprint (another torch, CUDA, card or kernel source: stale,
  skipped), ``races`` first builds whose key another engine appended
  between this one's read and its own append (the append is skipped).

Appends are one ``os.write`` of one line under ``O_APPEND``, so engines
sharing the directory never interleave a line, and the manifest is read
incrementally (each line counted once).  Nothing in this module raises to
the caller for a disk reason.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable, Optional

_log = logging.getLogger(__name__)

#: Bump when the manifest's line layout changes; part of the fingerprint,
#: so old lines read as stale, not corrupt.
ENTRY_VERSION = 1

MANIFEST = "warmup_manifest.jsonl"


def fingerprint(device) -> dict:
    """What must match for a manifest line to be rebuilt here: the
    runtime that builds the programs, the card they run on, and the
    kernel sources they launch."""
    import torch

    from capital_tpu_torch.ops import _build

    cuda = device.type == "cuda"
    return {
        "entry_version": ENTRY_VERSION,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "platform": device.type,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "kernels": _build.sources_hash(),
    }


class ExecutableCache:
    """`get(key, build, spec=...)` resolves memory -> ``build()`` and keeps
    the counters `SolveEngine.cache_stats()` reports (module docstring).
    `persist_dir` with `fingerprint` (a dict) and `scope` (a string: the
    engine's config hash and grid) turns the manifest on."""

    def __init__(self, persist_dir: Optional[str] = None, *,
                 fingerprint: Optional[dict] = None, scope: str = ""):
        self.persist_dir = persist_dir
        self._mem: dict[tuple, object] = {}
        self._fp = fingerprint
        self._scope = scope
        self.hits = 0
        self.misses = 0
        self.warmup_compiles = 0
        self.compiles = 0
        self.disk_hits = 0
        self.disk_misses = 0
        self.disk_errors = 0
        self.disk_skips = 0
        self.disk_races = 0
        # the manifest's lines of this scope and fingerprint: repr(key) ->
        # spec, read incrementally from byte offset _read_upto
        self._foreseen: dict[str, dict] = {}
        self._read_upto = 0
        self._unreadable = False

    def __len__(self) -> int:
        return len(self._mem)

    def __contains__(self, key: tuple) -> bool:
        return key in self._mem

    def get(self, key: tuple, build: Callable[[], object], *, warmup: bool = False,
            spec: Optional[dict] = None):
        """Resolve `key` to a program; `build()` makes a fresh one (only on
        a memory miss).  `warmup` keeps the lookup out of the hit/miss
        counters.  `spec` is the JSON recipe the engine rebuilds the key
        from (None: memory only, never in the manifest)."""
        exe = self._mem.get(key)
        if exe is not None:
            if not warmup:
                self.hits += 1
            return exe
        if not warmup:
            self.misses += 1
        persist = bool(self.persist_dir) and spec is not None
        if persist:
            self.refresh()
            if repr(key) in self._foreseen:
                self.disk_hits += 1
                exe = self._mem[key] = build()
                return exe
            self.disk_misses += 1
        self.compiles += 1
        if warmup:
            self.warmup_compiles += 1
        exe = self._mem[key] = build()
        if persist:
            self._store(key, spec)
        return exe

    def stats(self) -> dict:
        """The cache block of `SolveEngine.cache_stats()` /
        serve:request_stats, the reference's keys.  hit_rate covers
        request-driven lookups only (warmup excluded)."""
        lookups = self.hits + self.misses
        out = {
            "hits": self.hits,
            "misses": self.misses,
            "warmup_compiles": self.warmup_compiles,
            "compiles": self.compiles,
            "entries": len(self._mem),
            "hit_rate": (self.hits / lookups) if lookups else 1.0,
        }
        if self.persist_dir:
            out["disk"] = {
                "hits": self.disk_hits,
                "misses": self.disk_misses,
                "errors": self.disk_errors,
                "skips": self.disk_skips,
                "races": self.disk_races,
            }
        return out

    def programs(self) -> dict[tuple, object]:
        """Every cached bucket program (serve/program.Program), by key."""
        return {k: v for k, v in self._mem.items() if hasattr(v, "replays")}

    def replays(self) -> dict[tuple, int]:
        """Calls of each cached bucket program (graph replays on the card,
        closure calls on the CPU), by key."""
        return {k: p.replays for k, p in self.programs().items()}

    # ---- persistent tier ---------------------------------------------------

    def manifest_path(self) -> str:
        return os.path.join(self.persist_dir, MANIFEST)

    def foreseen_specs(self) -> list[dict]:
        """The rebuild recipes of every manifest key of this scope and
        fingerprint not yet in memory (what a warm-up adds to its own
        specs), after reading any lines appended since the last read."""
        if not self.persist_dir:
            return []
        self.refresh()
        held = {repr(k) for k in self._mem}
        return [spec for k, spec in self._foreseen.items() if k not in held]

    def refresh(self) -> None:
        """Read the manifest's complete lines past the last read.  A line
        of another scope is another engine's; one of another fingerprint
        counts in ``skips``; an unreadable one in ``errors``."""
        try:
            with open(self.manifest_path(), "rb") as f:
                f.seek(self._read_upto)
                data = f.read()
        except FileNotFoundError:
            return
        except OSError as e:
            if not self._unreadable:  # one error per cache, not one per read
                _log.warning("warm-up manifest %s unreadable (%s)", self.manifest_path(), e)
                self.disk_errors += 1
                self._unreadable = True
            return
        end = data.rfind(b"\n") + 1  # a line still being written waits
        self._read_upto += end
        for raw in data[:end].splitlines():
            if not raw.strip():
                continue
            try:
                line = json.loads(raw)
                key, spec, fp, scope = line["key"], line["spec"], line["fingerprint"], line["scope"]
                if not (isinstance(key, str) and isinstance(spec, dict)):
                    raise ValueError("key / spec of the wrong type")
            except (ValueError, KeyError, TypeError) as e:
                _log.warning("warm-up manifest line unreadable (%s); skipped", e)
                self.disk_errors += 1
                continue
            if scope != self._scope:
                continue
            if fp != self._fp:
                self.disk_skips += 1
                continue
            self._foreseen[key] = spec

    def _store(self, key: tuple, spec: dict) -> None:
        """Append one line for a first build; a line another engine
        appended meanwhile makes it a race, not a second line."""
        self.refresh()
        if repr(key) in self._foreseen:
            self.disk_races += 1
            return
        line = json.dumps({"key": repr(key), "spec": spec, "scope": self._scope,
                           "fingerprint": self._fp}) + "\n"
        try:
            os.makedirs(self.persist_dir, exist_ok=True)
            fd = os.open(self.manifest_path(), os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
            try:
                os.write(fd, line.encode())
            finally:
                os.close(fd)
        except OSError as e:
            _log.warning("warm-up manifest append for %r failed (%s); the program serves "
                         "from memory only", key, e)
            self.disk_errors += 1
