"""Rolling-window live telemetry for the serve tier (counterpart of
capital_tpu/serve/telemetry.py, the whole module).

`stats.Collector` is an end-of-run snapshot: one request_stats block per
run, percentiles over everything that ever happened.  A deadline-aware
scheduler and a closed-loop re-tuner both need the STREAMING view instead — what does the traffic look like
*right now* — which is what the `WindowAggregator` provides: fixed-size
time windows on the monotonic clock, each closing into an immutable dict
with

* request/ok/failed/shed counts and a per-op split;
* a fixed-bin latency histogram (`HIST_EDGES_MS` log-spaced edges; exact
  counts, bounded memory) next to nearest-rank percentiles from a
  reservoir-capped raw-sample population (`sampled`/`samples_capped`
  mark the population honestly when the cap bit);
* per-bucket occupancy/batch/shed counters and the window's max queue
  depth — the per-bucket signal a ladder re-tuner mines.

Feeding is push-based and host-side pure Python: the engine's Collector
forwards every `record_request`/`note_batch`/`note_queue_depth` to an
attached aggregator (`SolveEngine.enable_telemetry`), so the hot path
gains three method calls and no device work.  Windows roll lazily on the
note-side clock — no background thread — and `emit()` appends one
schema-tagged ``serve:window`` ledger record PER closed window (the
record count is the CLI's `loadgen --min-windows` gate's subject; the
reference's `ledger.validate_serve_window` pins each record's internal
coherence, including p50 <= p95 <= p99).

HOST-ONLY MODULE: pure Python over the Collector's notes; importing it
loads neither torch nor numpy (the window records read the ledger's
schema version, whose module imports torch only to write a manifest).
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Optional

from capital_tpu_torch.serve.stats import Reservoir, percentiles

#: Fixed log-spaced histogram bin edges (milliseconds).  Counts live in
#: len(edges) + 1 bins: (-inf, e0], (e0, e1], ..., (e_last, +inf) — fixed
#: bins so windows from different runs/replicas sum without re-binning.
HIST_EDGES_MS = (0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                 250.0, 500.0, 1000.0, 2500.0, 10000.0)

#: Default per-window reservoir cap for the raw-sample population the
#: percentiles read — windows are short, so a modest cap is exact for
#: normal traffic and degrades visibly (samples_capped) under a storm.
DEFAULT_WINDOW_SAMPLE_CAP = 512


def _hist_index(latency_ms: float) -> int:
    for i, edge in enumerate(HIST_EDGES_MS):
        if latency_ms <= edge:
            return i
    return len(HIST_EDGES_MS)


class _Window:
    """One open window's mutable accumulators."""

    __slots__ = ("t_start", "requests", "ok", "failed", "shed", "ops",
                 "hist", "samples", "queue_depth_max", "batches",
                 "occupancies", "per_bucket")

    def __init__(self, t_start: float, sample_cap: int):
        self.t_start = t_start  # guarded-by: <frozen>
        self.requests = 0  # guarded-by: <owner-thread>
        self.ok = 0  # guarded-by: <owner-thread>
        self.failed = 0  # guarded-by: <owner-thread>
        self.shed = 0  # guarded-by: <owner-thread>
        self.ops: Counter = Counter()  # guarded-by: <owner-thread>
        self.hist = [0] * (len(HIST_EDGES_MS) + 1)  # guarded-by: <owner-thread>
        self.samples = Reservoir(sample_cap)  # guarded-by: <owner-thread>
        self.queue_depth_max = 0  # guarded-by: <owner-thread>
        self.batches = 0  # guarded-by: <owner-thread>
        self.occupancies: list[float] = []  # guarded-by: <owner-thread>
        # str(bucket) -> {"requests", "shed", "batches", "occupancies"}
        self.per_bucket: dict[str, dict] = {}  # guarded-by: <owner-thread>

    @property
    def empty(self) -> bool:
        return self.requests == 0 and self.batches == 0

    def bucket_cell(self, bucket) -> dict:
        key = str(bucket)
        cell = self.per_bucket.get(key)
        if cell is None:
            cell = {"requests": 0, "shed": 0, "batches": 0,
                    "occupancies": []}
            self.per_bucket[key] = cell
        return cell


class WindowAggregator:
    """See module docstring.  One aggregator per engine; not thread-safe
    (it rides the engine's single dispatch loop, like the Collector)."""

    def __init__(self, window_s: float = 1.0, *,
                 sample_cap: int = DEFAULT_WINDOW_SAMPLE_CAP,
                 clock=time.monotonic):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if sample_cap < 1:
            raise ValueError(f"sample_cap must be >= 1, got {sample_cap}")
        self.window_s = float(window_s)  # guarded-by: <frozen>
        self.sample_cap = int(sample_cap)  # guarded-by: <frozen>
        self._clock = clock  # guarded-by: <frozen>
        self._open: Optional[_Window] = None  # guarded-by: <owner-thread>
        self._closed: list[dict] = []  # guarded-by: <owner-thread>
        self._emitted = 0  # guarded-by: <owner-thread>  (prefix of _closed already on a ledger)

    # ---- feeding -----------------------------------------------------------

    def _roll(self, now: float) -> _Window:
        """Close the open window if `now` is past its end and open the one
        containing `now`.  Empty windows are skipped, not emitted — the
        ≥3-non-empty-windows gate counts traffic, never idle wall time."""
        w = self._open
        if w is not None and now - w.t_start >= self.window_s:
            self._close(w, min(now, w.t_start + self.window_s))
            self._open = w = None
        if w is None:
            w = _Window(now, self.sample_cap)
            self._open = w
        return w

    def note_request(self, op: str, latency_s: Optional[float], *,
                     ok: bool = True, failed: bool = False,
                     shed: bool = False, bucket=None,
                     t: Optional[float] = None) -> None:
        """One finished (or shed) request.  Shed requests carry no
        latency — they never ran — and count in `shed` only."""
        now = self._clock() if t is None else t
        w = self._roll(now)
        w.requests += 1
        w.ops[str(op)] += 1
        cell = w.bucket_cell(bucket) if bucket is not None else None
        if shed:
            w.shed += 1
            if cell is not None:
                cell["shed"] += 1
            return
        if failed:
            w.failed += 1
        else:
            w.ok += 1
        lat_ms = float(latency_s) * 1e3
        w.hist[_hist_index(lat_ms)] += 1
        w.samples.append(lat_ms)
        if cell is not None:
            cell["requests"] += 1

    def note_batch(self, occupancy: float, *, bucket=None,
                   t: Optional[float] = None) -> None:
        now = self._clock() if t is None else t
        w = self._roll(now)
        w.batches += 1
        w.occupancies.append(float(occupancy))
        if bucket is not None:
            cell = w.bucket_cell(bucket)
            cell["batches"] += 1
            cell["occupancies"].append(float(occupancy))

    def note_queue_depth(self, depth: int,
                         t: Optional[float] = None) -> None:
        now = self._clock() if t is None else t
        w = self._roll(now)
        w.queue_depth_max = max(w.queue_depth_max, int(depth))

    # ---- closing / reporting ----------------------------------------------

    def _close(self, w: _Window, t_end: float) -> None:
        if w.empty:
            return
        from capital_tpu_torch.obs.ledger import SCHEMA_VERSION

        samples = list(w.samples)
        lat = (
            {k: round(v, 4) for k, v in percentiles(samples).items()}
            if samples else {"p50": 0.0, "p95": 0.0, "p99": 0.0}
        )
        occ = w.occupancies
        block = {
            "schema_version": SCHEMA_VERSION,
            "window_s": self.window_s,
            "t_start_s": round(w.t_start, 6),
            "t_end_s": round(t_end, 6),
            "requests": w.requests,
            "ok": w.ok,
            "failed": w.failed,
            "shed": w.shed,
            "ops": dict(w.ops),
            "latency_ms": lat,
            "hist_ms": {"edges": list(HIST_EDGES_MS),
                        "counts": list(w.hist)},
            "sampled": len(w.samples),
            "samples_capped": bool(w.samples.capped),
            "queue_depth_max": w.queue_depth_max,
            "batches": w.batches,
            "occupancy_mean": (round(sum(occ) / len(occ), 4)
                               if occ else 0.0),
            "per_bucket": {
                key: {
                    "requests": cell["requests"],
                    "shed": cell["shed"],
                    "batches": cell["batches"],
                    "occupancy_mean": (
                        round(sum(cell["occupancies"])
                              / len(cell["occupancies"]), 4)
                        if cell["occupancies"] else 0.0
                    ),
                }
                for key, cell in sorted(w.per_bucket.items())
            },
        }
        self._closed.append(block)

    def flush(self, t: Optional[float] = None) -> None:
        """Force-close the open window (end-of-run barrier before emit —
        a final partial window is data, not garbage)."""
        w = self._open
        if w is not None:
            self._close(w, self._clock() if t is None else t)
            self._open = None

    def windows(self) -> list[dict]:
        return list(self._closed)

    def emit(self, path: Optional[str] = None, *, grid=None, config=None,
             **extra) -> list[dict]:
        """Flush, then append one ``serve:window`` record per closed
        window not yet emitted (incremental — safe to call periodically
        from a serving loop).  Returns the records written this call."""
        from capital_tpu_torch.obs import ledger

        self.flush()
        fresh = self._closed[self._emitted:]
        self._emitted = len(self._closed)
        recs = []
        for block in fresh:
            rec = ledger.record(
                "serve:window",
                ledger.manifest(grid=grid, config=config),
                serve_window=block,
                **extra,
            )
            if path:
                ledger.append(path, rec)
            recs.append(rec)
        return recs
