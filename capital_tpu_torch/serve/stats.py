"""Serving telemetry: latencies, queue depth, occupancy, cache hit-rate
(counterpart of capital_tpu/serve/stats.py, the whole module).

One `Collector` per SolveEngine accumulates per-request and per-batch facts
host-side (pure Python — nothing here touches a device) and snapshots them
into a `request_stats` block, the schema_version-tagged record payload the
reference's `obs.ledger.validate_request_stats` accepts as it is.

Latency percentiles are nearest-rank p50/p95/p99 (`percentiles`, a copy of
the reference's bench/harness.percentiles), so a request_stats record of
either package reads on one scale.
"""

from __future__ import annotations

import math
import random
from collections import Counter



def percentiles(samples, points: tuple[float, ...] = (50.0, 95.0, 99.0)) -> dict[str, float]:
    """Nearest-rank percentiles of raw samples: {'p50': ..., 'p95': ...,
    'p99': ...} (the reference's bench/harness.percentiles): every reported
    value is a sample that actually occurred."""
    s = sorted(samples)
    if not s:
        raise ValueError("percentiles() needs at least one sample")
    out = {}
    for p in points:
        if not 0.0 < p <= 100.0:
            raise ValueError(f"percentile point {p} outside (0, 100]")
        rank = max(1, math.ceil(p / 100.0 * len(s)))
        label = f"p{int(p)}" if float(p).is_integer() else f"p{p}"
        out[label] = s[rank - 1]
    return out

#: Default bound on each raw-sample population a Collector retains.  A
#: long-running replica records forever; without a cap its four latency
#: lists grow without limit.  High enough that every tier-1 smoke and
#: loadgen run stays exact (capped == False).
DEFAULT_SAMPLE_CAP = 8192


class Reservoir:
    """Bounded sample population: the first `cap` values verbatim, then
    uniform reservoir replacement (algorithm R) with a deterministic
    per-instance seed — two replicas under identical traffic snapshot
    identical populations.  Iterable/len-able so `percentiles(reservoir)`
    and `list(reservoir)` read like the list it replaces; `count` is the
    TRUE number of values ever recorded and `capped` says whether the
    population is a subsample (the signal merge_snapshots degrades on)."""

    __slots__ = ("cap", "count", "_items", "_rng")

    def __init__(self, cap: int = DEFAULT_SAMPLE_CAP):
        if cap < 1:
            raise ValueError(f"reservoir cap must be >= 1, got {cap}")
        self.cap = cap
        self.count = 0
        self._items: list[float] = []
        self._rng = random.Random(0x5EED)

    def append(self, v: float) -> None:
        self.count += 1
        if len(self._items) < self.cap:
            self._items.append(v)
            return
        j = self._rng.randrange(self.count)
        if j < self.cap:
            self._items[j] = v

    @property
    def capped(self) -> bool:
        return self.count > self.cap

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)


class Collector:
    """Accumulates serving telemetry; snapshot() emits the request_stats
    block documented in docs/SERVING.md."""

    def __init__(self, replica_id: str | None = None,
                 sample_cap: int = DEFAULT_SAMPLE_CAP):
        # multi-replica deployments tag each collector with its replica's
        # id so the router / `obs serve-report --aggregate` can tell the
        # per-replica records apart (docs/SERVING.md "Multi-replica
        # serving"); None (the single-engine default) keeps the snapshot
        # schema exactly what it always was.
        self.replica_id = replica_id
        self.requests = 0
        self.ok = 0
        self.flagged = 0  # robust-flagged (breakdown detected, result kept)
        self.failed = 0  # no result at all (ingest fault / rejected)
        self.ops: Counter = Counter()
        # every raw-sample population is reservoir-capped (Reservoir) so a
        # long-running replica's memory stays bounded; counts stay exact,
        # percentiles degrade to a uniform subsample past the cap and the
        # snapshot says so (samples_capped).
        self.latencies_s = Reservoir(sample_cap)
        self.queue_depth_max = 0
        self.batches = 0
        self.occupancies: list[float] = []
        # requests served by the batched-grid small-N kernels — tracked as
        # their own latency population so `obs serve-report` can gate
        # small-bucket p99 (--max-p99-ms-small) separately from the large
        # buckets, whose solve time dominates any mixed percentile.
        self.latencies_small_s = Reservoir(sample_cap)
        # the two halves of each dispatched request's latency (executor
        # timing contract): queue-wait is scheduling policy, device is
        # compute + transfer.  Separate populations (not per-request pairs)
        # because the report gates each tail independently
        # (--max-queue-wait-ms); requests that never dispatched (ingest
        # faults, rejects) contribute to neither.
        self.queue_waits_s = Reservoir(sample_cap)
        self.devices_s = Reservoir(sample_cap)
        # optional live-telemetry tap (serve/telemetry.WindowAggregator,
        # attached by SolveEngine.enable_telemetry): every record/note
        # forwards, so the rolling windows see exactly what the snapshot
        # sees.  None (the default) adds one attribute check per note.
        self.window = None
        # posv_blocktri algorithm split ('scan' vs 'partitioned' — which
        # chain driver the request's compiled program runs, resolved by
        # the engine at submit time from static geometry).  Optional
        # block, like latency_ms_small: absent until blocktri traffic
        # happens.
        self.blocktri_impls: Counter = Counter()
        # accuracy_tier='guaranteed' refinement telemetry (the engine's
        # _refine_sink feeds it per landed request).  Sweep counts are
        # data-dependent — tracing prices exactly one sweep, so the
        # MEASURED population here is the only place the true refinement
        # cost is visible.  Optional block, like latency_ms_small: absent
        # until guaranteed-tier traffic happens.
        self.refine_iters: list[int] = []
        self.refine_resids: list[float] = []
        self.refine_converged = 0
        self.refine_nonconverged = 0

    # ---- feeding -----------------------------------------------------------

    def note_blocktri_impl(self, algorithm: str) -> None:
        self.blocktri_impls[algorithm] += 1

    def note_refine(self, iters: int, converged: bool,
                    resid: float) -> None:
        self.refine_iters.append(int(iters))
        self.refine_resids.append(float(resid))
        if converged:
            self.refine_converged += 1
        else:
            self.refine_nonconverged += 1

    def note_queue_depth(self, depth: int) -> None:
        self.queue_depth_max = max(self.queue_depth_max, depth)
        if self.window is not None:
            self.window.note_queue_depth(depth)

    def note_batch(self, occupancy: float, bucket=None) -> None:
        self.batches += 1
        self.occupancies.append(occupancy)
        if self.window is not None:
            self.window.note_batch(occupancy, bucket=bucket)

    def record_request(
        self, op: str, latency_s: float, ok: bool,
        flagged: bool = False, failed: bool = False, small: bool = False,
        queue_wait_s: float | None = None, device_s: float | None = None,
        bucket=None,
    ) -> None:
        self.requests += 1
        self.ops[op] += 1
        self.latencies_s.append(latency_s)
        if small:
            self.latencies_small_s.append(latency_s)
        if queue_wait_s is not None:
            self.queue_waits_s.append(queue_wait_s)
        if device_s is not None:
            self.devices_s.append(device_s)
        if failed:
            self.failed += 1
        elif flagged:
            self.flagged += 1
        elif ok:
            self.ok += 1
        if self.window is not None:
            self.window.note_request(op, latency_s, ok=ok, failed=failed,
                                     bucket=bucket)

    # ---- reporting ---------------------------------------------------------

    def snapshot(self, cache: dict | None = None, *,
                 factor_cache: dict | None = None,
                 samples: bool = False) -> dict:
        """The request_stats block.  `cache` is the engine's cache_stats()
        (hits/misses/hit_rate/warmup_compiles); zeros when absent so the
        schema stays total.  `factor_cache` is the FactorCache counter
        block (serve/factorcache.py stats()) — attached ONLY when factor
        traffic happened (lookups or installs), the same optional-block
        discipline as latency_ms_small, so older records and engines
        that never serve factor ops keep their exact schema and `obs
        serve-report --min-residency-hit-rate` can fail loudly when the
        block is absent rather than passing on a vacuous 1.0.
        `samples=True` attaches the raw latency populations (seconds) so
        merge_snapshots can pool percentiles exactly instead of
        max-of-p99 — meant for router-internal aggregation, not for
        ledger records (strip it before append)."""
        from capital_tpu_torch.obs.ledger import SCHEMA_VERSION

        lat = (
            {k: round(v * 1e3, 4)
             for k, v in percentiles(self.latencies_s).items()}
            if self.latencies_s
            else {"p50": 0.0, "p95": 0.0, "p99": 0.0}
        )
        occ = self.occupancies
        snap = {
            "schema_version": SCHEMA_VERSION,
            "requests": self.requests,
            "ok": self.ok,
            "flagged": self.flagged,
            "failed": self.failed,
            "ops": dict(self.ops),
            "latency_ms": lat,
            "queue_depth_max": self.queue_depth_max,
            "batches": self.batches,
            "batch_occupancy_mean": (
                round(sum(occ) / len(occ), 4) if occ else 0.0
            ),
            "cache": dict(cache) if cache else {
                "hits": 0, "misses": 0, "warmup_compiles": 0,
                "hit_rate": 1.0,
            },
        }
        # small-N split: present only when small-bucket traffic happened,
        # so pre-existing records (and engines that never route pallas)
        # keep the exact schema they always had.
        if self.latencies_small_s:
            snap["requests_small"] = self.latencies_small_s.count
            snap["latency_ms_small"] = {
                k: round(v * 1e3, 4)
                for k, v in percentiles(self.latencies_small_s).items()
            }
        # queue-wait / on-device split: present only when dispatched traffic
        # happened (same optional-block discipline as latency_ms_small, so
        # records from older engines stay valid and the report's
        # --max-queue-wait-ms gate can fail loudly when the split is absent
        # rather than silently passing on zeros).
        if self.queue_waits_s:
            snap["queue_wait_ms"] = {
                k: round(v * 1e3, 4)
                for k, v in percentiles(self.queue_waits_s).items()
            }
        if self.devices_s:
            snap["device_ms"] = {
                k: round(v * 1e3, 4)
                for k, v in percentiles(self.devices_s).items()
            }
        # posv_blocktri scan/partitioned split: same optional-block
        # discipline — absent without blocktri traffic, so older records
        # keep their schema and `obs serve-report` prints it only where
        # it means something.
        if self.blocktri_impls:
            snap["blocktri_impls"] = dict(self.blocktri_impls)
        # guaranteed-tier refinement block: measured sweep counts and the
        # worst landed backward error.  Iteration percentiles are COUNTS
        # (not ms — no 1e3 scaling); resid_max is the honest aggregate of
        # a quantity whose mean is meaningless across conditioning mixes.
        if self.refine_iters:
            n_ref = len(self.refine_iters)
            snap["refine"] = {
                "requests": n_ref,
                "converged": self.refine_converged,
                "nonconverged": self.refine_nonconverged,
                "converged_frac": round(self.refine_converged / n_ref, 4),
                "iters": {
                    k: round(v, 4)
                    for k, v in percentiles(
                        [float(i) for i in self.refine_iters]).items()
                },
                "iters_max": max(self.refine_iters),
                # NaN residuals (factor breakdown under the fast dtype)
                # already count as nonconverged; keep them out of the max
                # so it stays an orderable worst case (r == r is the
                # NaN filter)
                "resid_max": max(
                    (r for r in self.refine_resids if r == r), default=0.0
                ),
            }
        if factor_cache and (factor_cache.get("hits", 0)
                             + factor_cache.get("misses", 0)
                             + factor_cache.get("installs", 0)) > 0:
            snap["factor_cache"] = dict(factor_cache)
        if self.replica_id is not None:
            snap["replica_id"] = str(self.replica_id)
        # reservoir honesty marker: set the moment ANY raw population
        # outgrew its cap.  merge_snapshots reads it to refuse pooling a
        # subsample as if it were the full population (worst-tail max is
        # the honest degraded answer); absent on uncapped runs so the
        # schema stays what it always was.
        if any(r.capped for r in (self.latencies_s, self.latencies_small_s,
                                  self.queue_waits_s, self.devices_s)):
            snap["samples_capped"] = True
        if samples:
            snap["samples"] = {
                "latency_s": list(self.latencies_s),
                "latency_small_s": list(self.latencies_small_s),
                "queue_wait_s": list(self.queue_waits_s),
                "device_s": list(self.devices_s),
            }
        return snap

    def emit(self, path: str | None, *, grid=None, config=None,
             cache: dict | None = None, factor_cache: dict | None = None,
             **extra) -> dict:
        """Assemble (and append, when `path` is given) ONE ledger record
        carrying the snapshot — kind 'serve:request_stats', same manifest
        discipline as every other ledger row."""
        from capital_tpu_torch.obs import ledger

        rec = ledger.record(
            "serve:request_stats",
            ledger.manifest(grid=grid, config=config),
            request_stats=self.snapshot(cache, factor_cache=factor_cache),
            **extra,
        )
        if path:
            ledger.append(path, rec)
        return rec


# ---- cross-replica aggregation (pure; docs/SERVING.md) --------------------

#: percentile block -> the samples-block population it pools from.
_SAMPLE_KEYS = {
    "latency_ms": "latency_s",
    "latency_ms_small": "latency_small_s",
    "queue_wait_ms": "queue_wait_s",
    "device_ms": "device_s",
}


def _merge_pcts(snaps: list[dict], name: str) -> dict | None:
    """One merged percentile block across `snaps`.  Pools the raw sample
    populations when EVERY contributing snapshot carries them IN FULL
    (exact percentiles of the union); otherwise the elementwise max — the
    honest degraded answer, because a worst-tail bound is the only
    percentile that survives aggregation without the populations.  A
    reservoir-capped contributor (`samples_capped`) degrades the merge the
    same way: its samples are a uniform subsample, and pooling a subsample
    as if it were the population would silently bias the union's tail."""
    present = [s for s in snaps if name in s]
    if name == "latency_ms":
        present = snaps  # total block: every snapshot has it
    if not present:
        return None
    skey = _SAMPLE_KEYS[name]
    if all("samples" in s and not s.get("samples_capped")
           for s in present):
        pool = [v for s in present for v in s["samples"].get(skey, ())]
        if not pool:
            return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {k: round(v * 1e3, 4) for k, v in percentiles(pool).items()}
    out = {"p50": 0.0, "p95": 0.0, "p99": 0.0}
    for s in present:
        blk = s.get(name) or {}
        for p in out:
            out[p] = max(out[p], float(blk.get(p, 0.0)))
    return out


def merge_snapshots(snaps: list[dict]) -> dict:
    """Fold N replica-tagged request_stats snapshots into ONE aggregate
    block (pure — unit-testable without a ledger or an engine):

    * counts (requests/ok/flagged/failed/batches, per-op) sum; queue depth
      takes the max (depths are per-replica queues, not one shared queue);
    * occupancy is the batch-weighted mean — N half-full replicas must not
      average into a healthy-looking number just because one was idle;
    * percentiles pool from the raw sample populations when present
      (Collector.snapshot(samples=True)), else take the worst tail
      (elementwise max) — never a mean of percentiles, which is a number
      with no definition;
    * cache counters sum (incl. the disk tier when any replica persists)
      with hit_rate recomputed from the summed lookups;
    * the result carries ``replicas`` (how many snapshots merged) and
      ``replica_ids``, drops per-replica tags/samples, and stays valid
      under obs.ledger.validate_request_stats.
    """
    if not snaps:
        raise ValueError("merge_snapshots needs at least one snapshot")
    ops: Counter = Counter()
    bt_impls: Counter = Counter()
    for s in snaps:
        ops.update(s.get("ops") or {})
        bt_impls.update(s.get("blocktri_impls") or {})
    batches = sum(int(s.get("batches", 0)) for s in snaps)
    occ_w = sum(float(s.get("batch_occupancy_mean", 0.0))
                * int(s.get("batches", 0)) for s in snaps)
    merged = {
        "schema_version": snaps[0].get("schema_version"),
        "requests": sum(int(s.get("requests", 0)) for s in snaps),
        "ok": sum(int(s.get("ok", 0)) for s in snaps),
        "flagged": sum(int(s.get("flagged", 0)) for s in snaps),
        "failed": sum(int(s.get("failed", 0)) for s in snaps),
        "ops": dict(ops),
        "latency_ms": _merge_pcts(snaps, "latency_ms"),
        "queue_depth_max": max(int(s.get("queue_depth_max", 0))
                               for s in snaps),
        "batches": batches,
        "batch_occupancy_mean": (
            round(occ_w / batches, 4) if batches else 0.0
        ),
        "replicas": len(snaps),
    }
    if bt_impls:
        merged["blocktri_impls"] = dict(bt_impls)
    ids = [s["replica_id"] for s in snaps if s.get("replica_id")]
    if ids:
        merged["replica_ids"] = sorted(ids)
    cache = {"hits": 0, "misses": 0, "warmup_compiles": 0, "compiles": 0,
             "entries": 0}
    disk: dict | None = None
    for s in snaps:
        c = s.get("cache") or {}
        for k in cache:
            cache[k] += int(c.get(k, 0))
        d = c.get("disk")
        if d:
            disk = disk or {}
            for k, v in d.items():
                disk[k] = disk.get(k, 0) + int(v)
    lookups = cache["hits"] + cache["misses"]
    cache["hit_rate"] = (cache["hits"] / lookups) if lookups else 1.0
    if disk is not None:
        cache["disk"] = disk
    merged["cache"] = cache
    # factor-residency counters sum like the cache block (hit_rate
    # recomputed from summed lookups, never averaged); present only when
    # some replica saw factor traffic — same optional-block discipline
    # the snapshot itself follows.
    fsnaps = [s["factor_cache"] for s in snaps if s.get("factor_cache")]
    if fsnaps:
        fc = {k: 0 for k in ("hits", "misses", "evictions", "installs",
                             "released", "downdate_degrades", "entries",
                             "bytes", "budget_bytes")}
        for f in fsnaps:
            for k in fc:
                fc[k] += int(f.get(k, 0))
        flook = fc["hits"] + fc["misses"]
        fc["hit_rate"] = (fc["hits"] / flook) if flook else 1.0
        merged["factor_cache"] = fc
    for name in ("latency_ms_small", "queue_wait_ms", "device_ms"):
        blk = _merge_pcts(snaps, name)
        if blk is not None:
            merged[name] = blk
    if any("requests_small" in s for s in snaps):
        merged["requests_small"] = sum(int(s.get("requests_small", 0))
                                       for s in snaps)
    # guaranteed-tier refinement: counts sum with converged_frac recomputed
    # (never averaged); iteration percentiles take the elementwise max
    # (they are counts, not samples — no population to pool) and resid_max
    # the max, both honest worst-case bounds across replicas.
    rsnaps = [s["refine"] for s in snaps if s.get("refine")]
    if rsnaps:
        n_ref = sum(int(r.get("requests", 0)) for r in rsnaps)
        conv = sum(int(r.get("converged", 0)) for r in rsnaps)
        iters = {"p50": 0.0, "p95": 0.0, "p99": 0.0}
        for r in rsnaps:
            for p in iters:
                iters[p] = max(iters[p],
                               float((r.get("iters") or {}).get(p, 0.0)))
        merged["refine"] = {
            "requests": n_ref,
            "converged": conv,
            "nonconverged": sum(int(r.get("nonconverged", 0))
                                for r in rsnaps),
            "converged_frac": round(conv / n_ref, 4) if n_ref else 1.0,
            "iters": iters,
            "iters_max": max(int(r.get("iters_max", 0)) for r in rsnaps),
            "resid_max": max(float(r.get("resid_max", 0.0))
                             for r in rsnaps),
        }
    return merged
