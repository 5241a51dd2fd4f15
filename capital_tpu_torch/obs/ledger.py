"""The versioned JSONL run ledger (counterpart of capital_tpu/obs/ledger.py,
less `model_costs`, which waits for the port's cost-model device specs).

One record per run: a manifest (schema_version, device, platform, grid,
dtype, the config dataclass dump) plus the run's blocks — the serve tier
appends ``serve:request_stats`` (serve/stats.Collector.emit),
``serve:trace`` (obs/spans.TraceLog.emit), ``serve:window``
(serve/telemetry) and ``serve:session_stats`` records, the lint passes
``lint:report`` records.  The layout is the reference's, key for key, and
so are the validators (`validate_request_stats` ... `validate_session_stats`,
problem lists, [] = valid) and `diff`, which compares two ledgers record by
record and returns the `Regression`s, or raises `LedgerIncompatible` on a
schema or device mismatch or a malformed block.  Where the reference's
manifest records jax and its first device, the port's records torch, its
CUDA version and the card's name; `host_manifest` stands in for the host
tools, which touch no device.

torch is imported where a device manifest is written, not at module
import, so the host-only modules (telemetry windows, the router's records,
the ``obs`` and ``lint`` CLIs) use the ledger without loading it.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
from typing import Any, Optional

#: Bump on any breaking change to the record layout (the reference's value:
#: the two packages' records share one schema).
SCHEMA_VERSION = 1


class LedgerIncompatible(RuntimeError):
    """Two ledger records cannot be meaningfully compared (schema_version or
    device-kind mismatch)."""


def _jsonable(obj: Any) -> Any:
    """Best-effort JSON coercion for config dataclass dumps: enums by name,
    dtypes/callables/devices by str."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            "__class__": type(obj).__name__,
            **{f.name: _jsonable(getattr(obj, f.name)) for f in dataclasses.fields(obj)},
        }
    if isinstance(obj, enum.Enum):
        return obj.name
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return str(obj)


def _device_of(grid):
    import torch

    if grid is not None:
        return grid.device
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def manifest(grid=None, dtype=None, config=None, **extra) -> dict:
    """The run manifest: everything needed to decide whether two records
    are comparable, plus the config that produced the run.  The device is
    the grid's (the CUDA card when there is one and no grid is given)."""
    import torch

    dev = _device_of(grid)
    cuda = dev.type == "cuda"
    man = {
        "schema_version": SCHEMA_VERSION,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "platform": dev.type,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "num_devices": torch.cuda.device_count() if cuda else 1,
        "grid": repr(grid) if grid is not None else None,
        "dtype": str(dtype).replace("torch.", "") if dtype is not None else None,
        "config": _jsonable(config) if config is not None else None,
    }
    if grid is not None:
        man["grid_shape"] = [grid.dx, grid.dy, grid.c]
    man.update(_jsonable(extra))
    return man


def host_manifest(**extra) -> dict:
    """The manifest of a record that a host tool writes (the lint passes,
    ``obs robust-gate``): the same keys as `manifest`, with platform and
    device ``host``, because the tool touches no device — so it needs no
    torch."""
    man = {
        "schema_version": SCHEMA_VERSION,
        "platform": "host",
        "device": "host",
        "num_devices": 0,
        "grid": None,
        "dtype": None,
        "config": None,
    }
    man.update(_jsonable(extra))
    return man


def record(kind: str, man: dict, *, model: Optional[dict] = None, audit: Optional[dict] = None,
           drift: Optional[dict] = None, measured: Optional[dict] = None,
           residuals: Optional[dict] = None, **extra) -> dict:
    """Assemble one ledger record.  `man` comes from manifest(); the other
    blocks are the reference's (model costs, program audit, drift, the
    measured JSON line, residual gates), None where a run has none."""
    rec = {
        "record": "capital_tpu.ledger",
        "kind": kind,
        "manifest": man,
        "model": model,
        "audit": audit,
        "drift": drift,
        "measured": measured,
        "residuals": residuals,
    }
    rec.update(_jsonable(extra))
    return rec


def append(path: str, rec: dict) -> None:
    """Append one record as a JSON line (creating parent dirs)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def read(path: str) -> list[dict]:
    """Load every record of a JSONL ledger (blank lines skipped)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# --------------------------------------------------------------------------
# diff
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Regression:
    """One out-of-tolerance change between matched records."""

    key: str
    field: str
    a: float
    b: float
    note: str

    def line(self) -> str:
        return f"REGRESSION {self.key} {self.field}: {self.a} -> {self.b} ({self.note})"


def _key(rec: dict) -> str:
    """Stable identity of what a record measured: kind + problem shape +
    topology + dtype + config id.  Two runs sharing a key are comparable
    trials of the same configuration."""
    man = rec.get("manifest") or {}
    meas = rec.get("measured") or {}
    cfg = man.get("config") or {}
    parts = [
        rec.get("kind", "?"),
        meas.get("metric") or "",
        man.get("grid") or "",
        man.get("dtype") or "",
        str(cfg.get("__class__", "")),
        str(man.get("config_id", "")),
    ]
    for dim in ("n", "m", "k", "nrhs", "variant", "bc", "mode"):
        if dim in meas:
            parts.append(f"{dim}={meas[dim]}")
        elif dim in man:
            parts.append(f"{dim}={man[dim]}")
    return " ".join(p for p in parts if p)


def _check_comparable(a: dict, b: dict) -> None:
    ma, mb = a.get("manifest") or {}, b.get("manifest") or {}
    # legacy bare harness lines carry schema_version at top level
    sa = ma.get("schema_version", a.get("schema_version"))
    sb = mb.get("schema_version", b.get("schema_version"))
    if sa != sb:
        raise LedgerIncompatible(
            f"schema_version mismatch: {sa!r} vs {sb!r} — re-run the older "
            "side with the current tooling rather than comparing across "
            "schema changes"
        )
    da = ma.get("device", a.get("device"))
    db = mb.get("device", b.get("device"))
    if da != db:
        raise LedgerIncompatible(
            f"device-kind mismatch: {da!r} vs {db!r} — cross-device "
            "comparisons are not regressions; use separate ledgers"
        )


#: request_stats schema (serve/stats.Collector.snapshot): required keys and
#: the nested latency/cache shapes.  diff() VALIDATES these instead of
#: metric-comparing them — a served mix's latency profile is workload, but a
#: malformed record means the producer and the tooling have drifted apart.
_REQ_STATS_COUNTS = ("requests", "ok", "flagged", "failed",
                     "queue_depth_max", "batches")
_REQ_STATS_PCTS = ("p50", "p95", "p99")
_REQ_STATS_CACHE = ("hits", "misses", "warmup_compiles", "hit_rate")
#: per-op request counters (serve/stats.Collector.ops): every key must be a
#: serve op this tooling knows (batching.OPS, inlined so obs never imports
#: serve) — an unknown key means the producer and the tooling drifted apart.
_REQ_STATS_OPS = ("posv", "lstsq", "inv", "posv_blocktri",
                  "chol_update", "chol_downdate", "posv_cached",
                  "blocktri_extend", "posv_arrowhead",
                  "session_open", "session_append", "session_solve",
                  "session_contract", "session_close")
#: factor_cache counter block (serve/factorcache.FactorCache.stats):
#: attached to request_stats only by engines that served factor-token
#: traffic — records without it stay valid unchanged.
_REQ_STATS_FACTOR_COUNTS = ("hits", "misses", "evictions", "installs",
                            "released", "downdate_degrades", "entries",
                            "bytes", "budget_bytes")


def validate_request_stats(block) -> list[str]:
    """Schema problems of one request_stats block ([] = valid).  Checked by
    diff() on every record carrying the block and by ``obs serve-report``;
    kept as a problem list (not an exception) so the CLI can print all of
    them at once."""
    if not isinstance(block, dict):
        return [f"request_stats is {type(block).__name__}, expected object"]
    probs = []
    if block.get("schema_version") != SCHEMA_VERSION:
        probs.append(
            f"schema_version {block.get('schema_version')!r} != "
            f"{SCHEMA_VERSION}"
        )
    for key in _REQ_STATS_COUNTS:
        v = block.get(key)
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            probs.append(f"{key} must be a non-negative int, got {v!r}")
    lat = block.get("latency_ms")
    if not isinstance(lat, dict):
        probs.append(f"latency_ms must be an object, got {lat!r}")
    else:
        for p in _REQ_STATS_PCTS:
            if not isinstance(lat.get(p), (int, float)):
                probs.append(f"latency_ms.{p} missing or non-numeric")
    cache = block.get("cache")
    if not isinstance(cache, dict):
        probs.append(f"cache must be an object, got {cache!r}")
    else:
        for c in _REQ_STATS_CACHE:
            if not isinstance(cache.get(c), (int, float)):
                probs.append(f"cache.{c} missing or non-numeric")
        hr = cache.get("hit_rate")
        if isinstance(hr, (int, float)) and not 0.0 <= hr <= 1.0:
            probs.append(f"cache.hit_rate {hr!r} outside [0, 1]")
    occ = block.get("batch_occupancy_mean")
    if not isinstance(occ, (int, float)) or not 0.0 <= occ <= 1.0:
        probs.append(
            f"batch_occupancy_mean must be in [0, 1], got {occ!r}"
        )
    # optional per-op counters (Collector.ops, present since the op mix
    # grew past posv/lstsq): records that predate them stay valid unchanged
    if "ops" in block:
        ops = block["ops"]
        if not isinstance(ops, dict):
            probs.append(f"ops must be an object, got {ops!r}")
        else:
            for name, v in ops.items():
                if name not in _REQ_STATS_OPS:
                    probs.append(
                        f"ops key {name!r} is not a known serve op "
                        f"{_REQ_STATS_OPS}"
                    )
                if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                    probs.append(
                        f"ops[{name!r}] must be a non-negative int, got {v!r}"
                    )
    # optional posv_blocktri algorithm split (Collector.blocktri_impls):
    # which chain driver the programs ran, 'scan' vs 'partitioned'.  Absent without blocktri traffic; when
    # present, keys must come from that two-word vocabulary.
    if "blocktri_impls" in block:
        bti = block["blocktri_impls"]
        if not isinstance(bti, dict):
            probs.append(f"blocktri_impls must be an object, got {bti!r}")
        else:
            for name, v in bti.items():
                if name not in ("scan", "partitioned"):
                    probs.append(
                        f"blocktri_impls key {name!r} is not a chain "
                        "algorithm ('scan', 'partitioned')"
                    )
                if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                    probs.append(
                        f"blocktri_impls[{name!r}] must be a non-negative "
                        f"int, got {v!r}"
                    )
    # optional percentile blocks, validated whenever present, same posture
    # as the rest of the block:
    #   latency_ms_small — small-N split (serve small_n_impl pallas
    #     routes); absent on engines that never served a small bucket;
    #   queue_wait_ms / device_ms — the continuous scheduler's latency
    #     split (the executor's timing contract); absent on records from
    #     engines that never dispatched, and on pre-split records, which
    #     stay valid unchanged.
    for name in ("latency_ms_small", "queue_wait_ms", "device_ms"):
        if name not in block:
            continue
        lat_o = block[name]
        if not isinstance(lat_o, dict):
            probs.append(f"{name} must be an object, got {lat_o!r}")
            continue
        for p in _REQ_STATS_PCTS:
            if not isinstance(lat_o.get(p), (int, float)):
                probs.append(f"{name}.{p} missing or non-numeric")
    if "requests_small" in block:
        rs = block["requests_small"]
        if not isinstance(rs, int) or isinstance(rs, bool) or rs < 0:
            probs.append(
                f"requests_small must be a non-negative int, got {rs!r}"
            )
    # optional factor-residency counters (serve/factorcache.py):
    # present only on engines that served factor-token traffic
    # (stats.snapshot attaches the block when lookups or installs
    # happened); its gate is ``obs serve-report --min-residency-hit-rate``.
    if "factor_cache" in block:
        fc = block["factor_cache"]
        if not isinstance(fc, dict):
            probs.append(f"factor_cache must be an object, got {fc!r}")
        else:
            for key in _REQ_STATS_FACTOR_COUNTS:
                v = fc.get(key)
                if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                    probs.append(
                        f"factor_cache.{key} must be a non-negative int, "
                        f"got {v!r}"
                    )
            hr = fc.get("hit_rate")
            if not isinstance(hr, (int, float)) or not 0.0 <= hr <= 1.0:
                probs.append(
                    f"factor_cache.hit_rate must be in [0, 1], got {hr!r}"
                )
            h, m = fc.get("hits"), fc.get("misses")
            if (isinstance(h, int) and isinstance(m, int)
                    and isinstance(hr, (int, float)) and h + m > 0
                    and abs(hr - h / (h + m)) > 1e-6):
                probs.append(
                    f"factor_cache.hit_rate {hr!r} inconsistent with "
                    f"hits={h} misses={m} (expected {h / (h + m):.6f})"
                )
            # optional per-entry byte map + eviction-age histogram
            # (the session eviction-pressure view): additive keys —
            # older records (and merged snapshots, which fold only
            # the scalar counters) stay valid without them.
            if "entry_bytes" in fc:
                eb = fc["entry_bytes"]
                if not isinstance(eb, dict):
                    probs.append(
                        f"factor_cache.entry_bytes must be an object, "
                        f"got {eb!r}")
                else:
                    for t, v in eb.items():
                        if (not isinstance(v, int) or isinstance(v, bool)
                                or v < 0):
                            probs.append(
                                f"factor_cache.entry_bytes[{t!r}] must be "
                                f"a non-negative int, got {v!r}")
                    ent, by = fc.get("entries"), fc.get("bytes")
                    if isinstance(ent, int) and len(eb) != ent:
                        probs.append(
                            f"factor_cache.entry_bytes has {len(eb)} "
                            f"entries but entries={ent}")
                    if (isinstance(by, int) and eb
                            and all(isinstance(v, int) for v in eb.values())
                            and sum(eb.values()) != by):
                        probs.append(
                            f"factor_cache.entry_bytes sums to "
                            f"{sum(eb.values())} but bytes={by}")
            if "eviction_age_hist" in fc:
                eh = fc["eviction_age_hist"]
                if not isinstance(eh, dict):
                    probs.append(
                        f"factor_cache.eviction_age_hist must be an "
                        f"object, got {eh!r}")
                else:
                    for bkt, v in eh.items():
                        if not (isinstance(bkt, str) and bkt.isdigit()):
                            probs.append(
                                f"factor_cache.eviction_age_hist key "
                                f"{bkt!r} is not a stringified age bucket")
                        if (not isinstance(v, int) or isinstance(v, bool)
                                or v < 0):
                            probs.append(
                                f"factor_cache.eviction_age_hist[{bkt!r}] "
                                f"must be a non-negative int, got {v!r}")
                    ev = fc.get("evictions")
                    if (isinstance(ev, int) and eh
                            and all(isinstance(v, int) for v in eh.values())
                            and sum(eh.values()) != ev):
                        probs.append(
                            f"factor_cache.eviction_age_hist sums to "
                            f"{sum(eh.values())} but evictions={ev}")
    # optional guaranteed-tier refinement telemetry
    # (Collector.note_refine): measured sweep counts and the worst landed
    # backward error.  Absent without accuracy_tier='guaranteed' traffic;
    # its gates are ``obs serve-report --max-refine-iters`` /
    # ``--min-converged-frac``.
    if "refine" in block:
        rf = block["refine"]
        if not isinstance(rf, dict):
            probs.append(f"refine must be an object, got {rf!r}")
        else:
            for key in ("requests", "converged", "nonconverged",
                        "iters_max"):
                v = rf.get(key)
                if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                    probs.append(
                        f"refine.{key} must be a non-negative int, got {v!r}"
                    )
            cf = rf.get("converged_frac")
            if not isinstance(cf, (int, float)) or not 0.0 <= cf <= 1.0:
                probs.append(
                    f"refine.converged_frac must be in [0, 1], got {cf!r}"
                )
            it = rf.get("iters")
            if not isinstance(it, dict):
                probs.append(f"refine.iters must be an object, got {it!r}")
            else:
                for p in _REQ_STATS_PCTS:
                    if not isinstance(it.get(p), (int, float)):
                        probs.append(f"refine.iters.{p} missing or "
                                     "non-numeric")
            rm = rf.get("resid_max")
            if not isinstance(rm, (int, float)) or isinstance(rm, bool) \
                    or rm < 0:
                probs.append(
                    f"refine.resid_max must be a non-negative number, "
                    f"got {rm!r}"
                )
    # multi-replica tags (serve/router.py): a per-replica record
    # carries replica_id; the router's aggregate record carries replicas
    # (how many snapshots merged) and replica_ids.  Single-engine records
    # carry none of them and stay valid unchanged.
    if "replica_id" in block and not isinstance(block["replica_id"], str):
        probs.append(
            f"replica_id must be a string, got {block['replica_id']!r}"
        )
    if "replicas" in block:
        n = block["replicas"]
        if not isinstance(n, int) or isinstance(n, bool) or n < 1:
            probs.append(f"replicas must be a positive int, got {n!r}")
    if "replica_ids" in block:
        ids = block["replica_ids"]
        if (not isinstance(ids, list)
                or not all(isinstance(i, str) for i in ids)):
            probs.append(
                f"replica_ids must be a list of strings, got {ids!r}"
            )
    if "samples" in block:
        # raw latency populations (Collector.snapshot(samples=True)) are a
        # router-internal pooling vehicle; a ledger record carrying them
        # is a producer bug (unbounded growth), so flag rather than allow
        probs.append(
            "samples block present — raw populations are for in-memory "
            "aggregation (stats.merge_snapshots), strip before append"
        )
    return probs


#: lint_report blocks (capital_tpu_torch.lint rules.Report.block) get the same
#: treatment as request_stats: structurally validated on every diff, never
#: metric-compared — a lint outcome is a property of the *source tree*, not
#: of a kernel's speed, and its gate lives in ``obs lint-report``.
_LINT_PASSES = ("program", "source", "concurrency")
_LINT_FAIL_ON = ("warn", "error")
_LINT_COUNT_KEYS = ("error", "warn", "info")
_LINT_FINDING_KEYS = ("rule", "severity", "target", "message", "fingerprint")


def validate_lint_report(block) -> list[str]:
    """Schema problems of one lint_report block ([] = valid).  Checked by
    diff() on every record carrying the block and by ``obs lint-report``;
    a problem list (not an exception) so the CLI can print all of them."""
    if not isinstance(block, dict):
        return [f"lint_report is {type(block).__name__}, expected object"]
    probs = []
    if block.get("schema_version") != SCHEMA_VERSION:
        probs.append(
            f"schema_version {block.get('schema_version')!r} != "
            f"{SCHEMA_VERSION}"
        )
    if block.get("pass") not in _LINT_PASSES:
        probs.append(
            f"pass must be one of {_LINT_PASSES}, got {block.get('pass')!r}"
        )
    if block.get("fail_on") not in _LINT_FAIL_ON:
        probs.append(
            f"fail_on must be one of {_LINT_FAIL_ON}, "
            f"got {block.get('fail_on')!r}"
        )
    if not isinstance(block.get("ok"), bool):
        probs.append(f"ok must be a bool, got {block.get('ok')!r}")
    counts = block.get("counts")
    if not isinstance(counts, dict):
        probs.append(f"counts must be an object, got {counts!r}")
    else:
        for key in _LINT_COUNT_KEYS:
            v = counts.get(key)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                probs.append(
                    f"counts.{key} must be a non-negative int, got {v!r}"
                )
    sup = block.get("suppressed")
    if not isinstance(sup, int) or isinstance(sup, bool) or sup < 0:
        probs.append(f"suppressed must be a non-negative int, got {sup!r}")
    findings = block.get("findings")
    if not isinstance(findings, list):
        probs.append(f"findings must be a list, got {findings!r}")
    else:
        for i, f in enumerate(findings):
            if not isinstance(f, dict):
                probs.append(f"findings[{i}] is not an object")
                continue
            for key in _LINT_FINDING_KEYS:
                if not isinstance(f.get(key), str) or not f.get(key):
                    probs.append(
                        f"findings[{i}].{key} missing or not a string"
                    )
    return probs


def validate_phase_seconds(measured) -> list[str]:
    """Schema problems of a measured block carrying phase attribution
    ([] = valid) — the bench:trace producer's ``phase_seconds`` /
    ``bubble_frac`` fields (bench/trace.phase_attribution).  Same posture
    as request_stats / lint_report: structurally validated on every diff
    whenever PRESENT, never required — records that predate the fields
    stay valid unchanged.  The per-phase split itself is workload shape,
    not a metric; its drift gate is measured.value (the attributed
    fraction), which diff() compares normally."""
    if not isinstance(measured, dict):
        return [f"measured is {type(measured).__name__}, expected object"]
    probs = []
    ps = measured.get("phase_seconds")
    if ps is not None:
        if not isinstance(ps, dict):
            probs.append(f"phase_seconds must be an object, got {ps!r}")
        else:
            for tag, v in ps.items():
                if not isinstance(tag, str) or not tag:
                    probs.append(f"phase_seconds key {tag!r} not a string")
                if (
                    not isinstance(v, (int, float))
                    or isinstance(v, bool)
                    or not v >= 0.0
                    or v != v
                    or v == float("inf")
                ):
                    probs.append(
                        f"phase_seconds[{tag!r}] must be a finite "
                        f"non-negative number, got {v!r}"
                    )
    bf = measured.get("bubble_frac")
    if bf is not None:
        if (
            not isinstance(bf, (int, float))
            or isinstance(bf, bool)
            or not 0.0 <= bf <= 1.0
        ):
            probs.append(f"bubble_frac must be in [0, 1], got {bf!r}")
        if ps is None:
            probs.append(
                "bubble_frac without phase_seconds — the fraction is "
                "meaningless without the attribution that produced it"
            )
    return probs


#: blocktri chain impls the bench driver can report (models/blocktri.IMPLS).
_BLOCKTRI_IMPLS = ("auto", "pallas", "xla", "partitioned")


def validate_blocktri_measured(measured) -> list[str]:
    """Schema problems of a bench:blocktri measured block ([] = valid) —
    the chain-geometry fields the blocktri driver emits (nblocks / block /
    n consistency, the speedup column, the wall_ms split).  Same
    exemption-with-validation posture as request_stats: diff() validates
    every record carrying a blocktri metric (malformed ->
    LedgerIncompatible) while the metric itself still compares normally —
    both blocktri metrics are rate-shaped (TFLOP/s, batch/s), so a
    value drop reads as "slower" like every other bench row."""
    if not isinstance(measured, dict):
        return [f"measured is {type(measured).__name__}, expected object"]
    probs = []
    for key in ("nblocks", "block", "n", "batch", "nrhs"):
        v = measured.get(key)
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            probs.append(f"{key} must be a positive int, got {v!r}")
    nb, b, n = (measured.get(k) for k in ("nblocks", "block", "n"))
    if (isinstance(nb, int) and isinstance(b, int) and isinstance(n, int)
            and n != nb * b):
        probs.append(f"n {n} != nblocks*block {nb * b}")
    if measured.get("impl") not in _BLOCKTRI_IMPLS:
        probs.append(
            f"impl must be one of {_BLOCKTRI_IMPLS}, "
            f"got {measured.get('impl')!r}"
        )
    if "speedup" in measured:
        sp = measured["speedup"]
        if (not isinstance(sp, (int, float)) or isinstance(sp, bool)
                or not sp > 0):
            probs.append(f"speedup must be a positive number, got {sp!r}")
    wm = measured.get("wall_ms")
    if wm is not None:
        if not isinstance(wm, dict):
            probs.append(f"wall_ms must be an object, got {wm!r}")
        else:
            for p in _REQ_STATS_PCTS:
                if not isinstance(wm.get(p), (int, float)):
                    probs.append(f"wall_ms.{p} missing or non-numeric")
    # partitioned-driver fields: optional — present on rows the
    # driver ran with --impl partitioned (and on the sequential A/B
    # baseline rows, which carry `depth` only).  When present they must
    # be well-formed: partitions a positive int, the depth trio positive
    # (depth/depth_seq are jaxpr scan-trip counts, depth_reduction their
    # ratio — the ≥4x gate of `make bench-blocktri-par`).
    if "partitions" in measured:
        p = measured["partitions"]
        if not isinstance(p, int) or isinstance(p, bool) or p < 1:
            probs.append(f"partitions must be a positive int, got {p!r}")
    for key in ("depth", "depth_seq"):
        if key in measured:
            d = measured[key]
            if not isinstance(d, int) or isinstance(d, bool) or d < 1:
                probs.append(f"{key} must be a positive int, got {d!r}")
    if "depth_reduction" in measured:
        dr = measured["depth_reduction"]
        if (not isinstance(dr, (int, float)) or isinstance(dr, bool)
                or not dr > 0):
            probs.append(
                f"depth_reduction must be a positive number, got {dr!r}")
    return probs


def validate_arrowhead_measured(measured) -> list[str]:
    """Schema problems of a bench:arrowhead measured block ([] = valid) —
    the arrowhead-geometry fields the driver emits (nblocks / block /
    border / n consistency, the chain impl, the structural-speedup
    column of the ≥10x ``make bench-arrowhead`` gate).  Same
    exemption-with-validation posture as blocktri / update / refine:
    diff() validates every record whose metric starts with "arrowhead"
    (malformed -> LedgerIncompatible) while the metric itself still
    compares normally — the value is a speedup ratio over dense batched
    posv, so a drop reads as "slower" like every other bench row."""
    if not isinstance(measured, dict):
        return [f"measured is {type(measured).__name__}, expected object"]
    probs = []
    for key in ("nblocks", "block", "border", "n", "batch", "nrhs"):
        v = measured.get(key)
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            probs.append(f"{key} must be a positive int, got {v!r}")
    nb, b, s, n = (measured.get(k)
                   for k in ("nblocks", "block", "border", "n"))
    if (isinstance(nb, int) and isinstance(b, int) and isinstance(s, int)
            and isinstance(n, int) and n != nb * b + s):
        probs.append(f"n {n} != nblocks*block+border {nb * b + s}")
    if measured.get("impl") not in _BLOCKTRI_IMPLS:
        probs.append(
            f"impl must be one of {_BLOCKTRI_IMPLS}, "
            f"got {measured.get('impl')!r}"
        )
    # a speedup row (the arrowhead_tflops shape; arrowhead_latency rows
    # carry neither) must bring the whole proof bundle: both wall
    # comparands AND the f64 reference residuals it gated on (factor =
    # Schur completion vs a NumPy reference, solve = whole-matrix
    # backward error) — a speedup row that never proved its answers is
    # not a row this ledger wants
    if "speedup" in measured:
        for key in ("speedup", "arrow_ms", "dense_ms"):
            v = measured.get(key)
            if (not isinstance(v, (int, float)) or isinstance(v, bool)
                    or not v > 0):
                probs.append(f"{key} must be a positive number, got {v!r}")
        for key in ("factor_resid", "solve_resid"):
            v = measured.get(key)
            if (not isinstance(v, (int, float)) or isinstance(v, bool)
                    or v < 0):
                probs.append(
                    f"{key} must be a non-negative number, got {v!r}")
    wm = measured.get("wall_ms")
    if wm is not None:
        if not isinstance(wm, dict):
            probs.append(f"wall_ms must be an object, got {wm!r}")
        else:
            for p in _REQ_STATS_PCTS:
                if not isinstance(wm.get(p), (int, float)):
                    probs.append(f"wall_ms.{p} missing or non-numeric")
    return probs


#: update impls the bench driver can report (ops/update_small.IMPLS).
_UPDATE_IMPLS = ("auto", "pallas", "xla")


def validate_update_measured(measured) -> list[str]:
    """Schema problems of a bench:update_speedup measured block ([] =
    valid) — the online factor-maintenance fields the update driver emits
    (the n/k geometry, the update-vs-refactor speedup columns, and the
    optional serve_smoke residency block).  Same exemption-with-validation
    posture as request_stats / blocktri: diff() validates every record
    whose metric starts with "update" (malformed -> LedgerIncompatible)
    while the metric itself still compares normally — the value is
    rate-shaped (TFLOP/s over the useful 2kn² flops), so a drop reads as
    "slower" like every other bench row."""
    if not isinstance(measured, dict):
        return [f"measured is {type(measured).__name__}, expected object"]
    probs = []
    for key in ("n", "k", "batch"):
        v = measured.get(key)
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            probs.append(f"{key} must be a positive int, got {v!r}")
    if measured.get("impl") not in _UPDATE_IMPLS:
        probs.append(
            f"impl must be one of {_UPDATE_IMPLS}, "
            f"got {measured.get('impl')!r}"
        )
    for key in ("speedup", "refactor_ms", "update_ms"):
        v = measured.get(key)
        if not isinstance(v, (int, float)) or isinstance(v, bool) or not v > 0:
            probs.append(f"{key} must be a positive number, got {v!r}")
    wm = measured.get("wall_ms")
    if not isinstance(wm, dict):
        probs.append(f"wall_ms must be an object, got {wm!r}")
    else:
        for p in _REQ_STATS_PCTS:
            if not isinstance(wm.get(p), (int, float)):
                probs.append(f"wall_ms.{p} missing or non-numeric")
    # the serve residency smoke rides along only when the driver ran it
    # (--min-hit-rate); absent blocks stay valid unchanged
    if "serve_smoke" in measured:
        sm = measured["serve_smoke"]
        if not isinstance(sm, dict):
            probs.append(f"serve_smoke must be an object, got {sm!r}")
        else:
            for key in ("requests", "recompiles"):
                v = sm.get(key)
                if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                    probs.append(
                        f"serve_smoke.{key} must be a non-negative int, "
                        f"got {v!r}"
                    )
            hr = sm.get("hit_rate")
            if not isinstance(hr, (int, float)) or not 0.0 <= hr <= 1.0:
                probs.append(
                    f"serve_smoke.hit_rate must be in [0, 1], got {hr!r}"
                )
    return probs


def validate_refine_measured(measured) -> list[str]:
    """Schema problems of a bench:refine measured block ([] = valid) — the
    mixed-precision iterative-refinement fields the refine driver emits
    (the n/nrhs/batch geometry, the dtype pair, the f32-factor+IR vs
    f64-factor speedup with its matched-residual ratio, and the TSQR
    orthogonality probe).  Same exemption-with-validation posture as
    blocktri / update: diff() validates every record whose metric starts
    with "refine" (malformed -> LedgerIncompatible) while the metric
    itself still compares normally — the value is a speedup ratio, so a
    drop reads as "slower" like every other bench row."""
    if not isinstance(measured, dict):
        return [f"measured is {type(measured).__name__}, expected object"]
    probs = []
    for key in ("n", "nrhs", "batch"):
        v = measured.get(key)
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            probs.append(f"{key} must be a positive int, got {v!r}")
    for key in ("factor_dtype", "correction_dtype"):
        v = measured.get(key)
        if not isinstance(v, str) or not v:
            probs.append(f"{key} must be a non-empty string, got {v!r}")
    for key in ("speedup", "refined_ms", "baseline_ms"):
        v = measured.get(key)
        if not isinstance(v, (int, float)) or isinstance(v, bool) \
                or not v > 0:
            probs.append(f"{key} must be a positive number, got {v!r}")
    # how far the refined residual sits from the straight high-dtype
    # factor's (1.0 = identical); the bench gate bounds it above
    rr = measured.get("resid_ratio")
    if not isinstance(rr, (int, float)) or isinstance(rr, bool) or rr < 0:
        probs.append(
            f"resid_ratio must be a non-negative number, got {rr!r}"
        )
    it = measured.get("iters")
    if not isinstance(it, int) or isinstance(it, bool) or it < 0:
        probs.append(f"iters must be a non-negative int, got {it!r}")
    if "tsqr_ortho" in measured:
        v = measured["tsqr_ortho"]
        if not isinstance(v, (int, float)) or isinstance(v, bool) or v < 0:
            probs.append(
                f"tsqr_ortho must be a non-negative number, got {v!r}"
            )
    wm = measured.get("wall_ms")
    if not isinstance(wm, dict):
        probs.append(f"wall_ms must be an object, got {wm!r}")
    else:
        for p in _REQ_STATS_PCTS:
            if not isinstance(wm.get(p), (int, float)):
                probs.append(f"wall_ms.{p} missing or non-numeric")
    # the tier serve smoke rides along only when the driver ran it;
    # absent blocks stay valid unchanged
    if "serve_smoke" in measured:
        sm = measured["serve_smoke"]
        if not isinstance(sm, dict):
            probs.append(f"serve_smoke must be an object, got {sm!r}")
        else:
            for key in ("requests", "recompiles"):
                v = sm.get(key)
                if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                    probs.append(
                        f"serve_smoke.{key} must be a non-negative int, "
                        f"got {v!r}"
                    )
    return probs


def validate_serve_trace(block) -> list[str]:
    """Schema problems of one serve_trace block ([] = valid) — the
    per-request span-chain record `obs.spans.TraceLog.emit` writes.  Same
    exemption-with-validation posture as request_stats: diff() validates
    every record carrying the block (malformed -> LedgerIncompatible)
    while never metric-comparing it — a trace waterfall is a workload's
    shape; its gates are ``obs serve-report --min-trace-complete`` and the
    in-run smoke gate.  Chain validation itself delegates to
    `spans.trace_dict_problems`, the SAME code the producer's `complete`
    verdict ran, so the ledger check and the in-run gate can never
    disagree about what a complete chain is."""
    from capital_tpu_torch.obs import spans

    if not isinstance(block, dict):
        return [f"serve_trace is {type(block).__name__}, expected object"]
    probs = []
    if block.get("schema_version") != SCHEMA_VERSION:
        probs.append(
            f"schema_version {block.get('schema_version')!r} != "
            f"{SCHEMA_VERSION}"
        )
    tol = block.get("bubble_tol_ms")
    if not isinstance(tol, (int, float)) or isinstance(tol, bool) \
            or not tol >= 0:
        probs.append(
            f"bubble_tol_ms must be a non-negative number, got {tol!r}"
        )
        tol = spans.DEFAULT_BUBBLE_TOL_MS
    for key in ("requests", "complete", "dropped", "violations"):
        v = block.get(key)
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            probs.append(f"{key} must be a non-negative int, got {v!r}")
    traces = block.get("traces")
    if not isinstance(traces, list):
        probs.append(f"traces must be a list, got {traces!r}")
        return probs
    req = block.get("requests")
    if isinstance(req, int) and req != len(traces):
        probs.append(f"requests {req} != len(traces) {len(traces)}")
    n_complete = 0
    for i, t in enumerate(traces):
        t_probs = spans.trace_dict_problems(t, float(tol))
        if not t_probs:
            n_complete += 1
        else:
            # structural breakage (non-dict / non-numeric spans) is a
            # schema problem; an INCOMPLETE but well-formed chain is data
            # the completeness gate judges, not a malformed record
            for p in t_probs:
                if ("not a dict" in p or "not a string" in p
                        or "non-numeric" in p or "not an int" in p
                        or "not a list" in p):
                    probs.append(f"traces[{i}]: {p}")
    comp = block.get("complete")
    if isinstance(comp, int) and not probs and comp != n_complete:
        probs.append(
            f"complete {comp} disagrees with recount {n_complete} under "
            f"bubble_tol_ms={tol}"
        )
    viol = block.get("violations")
    n_viol = sum(1 for t in traces
                 if isinstance(t, dict) and t.get("violated"))
    if isinstance(viol, int) and viol != n_viol:
        probs.append(f"violations {viol} != recount {n_viol}")
    return probs


def validate_serve_window(block) -> list[str]:
    """Schema problems of one serve_window block ([] = valid) — a
    `serve.telemetry.WindowAggregator` closed window.  Same posture as
    serve_trace: structurally validated on every diff, never
    metric-compared (a window's latency profile is live traffic; its gate
    is ``obs serve-report --min-windows``).  Coherence checks pin the
    invariants the aggregator promises: ok + failed + shed == requests,
    histogram counts sum to the latencied population, percentiles ordered.
    A window may legitimately carry requests == 0 with batches > 0 (a
    batch dispatched in this window whose requests landed in the next),
    so counts are checked for consistency, never positivity."""
    if not isinstance(block, dict):
        return [f"serve_window is {type(block).__name__}, expected object"]
    probs = []
    if block.get("schema_version") != SCHEMA_VERSION:
        probs.append(
            f"schema_version {block.get('schema_version')!r} != "
            f"{SCHEMA_VERSION}"
        )
    ws = block.get("window_s")
    if not isinstance(ws, (int, float)) or isinstance(ws, bool) \
            or not ws > 0:
        probs.append(f"window_s must be a positive number, got {ws!r}")
    t0, t1 = block.get("t_start_s"), block.get("t_end_s")
    for key, v in (("t_start_s", t0), ("t_end_s", t1)):
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            probs.append(f"{key} must be a number, got {v!r}")
    if (isinstance(t0, (int, float)) and isinstance(t1, (int, float))
            and t1 < t0):
        probs.append(f"t_end_s {t1} < t_start_s {t0}")
    for key in ("requests", "ok", "failed", "shed", "sampled",
                "queue_depth_max", "batches"):
        v = block.get(key)
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            probs.append(f"{key} must be a non-negative int, got {v!r}")
    req, ok, failed, shed = (block.get(k)
                             for k in ("requests", "ok", "failed", "shed"))
    counted = all(isinstance(v, int) and not isinstance(v, bool)
                  for v in (req, ok, failed, shed))
    if counted and ok + failed + shed != req:
        probs.append(
            f"ok {ok} + failed {failed} + shed {shed} != requests {req}"
        )
    lat = block.get("latency_ms")
    if not isinstance(lat, dict):
        probs.append(f"latency_ms must be an object, got {lat!r}")
    else:
        for p in _REQ_STATS_PCTS:
            if not isinstance(lat.get(p), (int, float)):
                probs.append(f"latency_ms.{p} missing or non-numeric")
        pcts = [lat.get(p) for p in _REQ_STATS_PCTS]
        if (all(isinstance(v, (int, float)) for v in pcts)
                and not pcts[0] <= pcts[1] <= pcts[2]):
            probs.append(
                f"percentiles out of order: p50 {pcts[0]} <= p95 "
                f"{pcts[1]} <= p99 {pcts[2]} fails"
            )
    hist = block.get("hist_ms")
    if not isinstance(hist, dict):
        probs.append(f"hist_ms must be an object, got {hist!r}")
    else:
        edges, counts = hist.get("edges"), hist.get("counts")
        if (not isinstance(edges, list)
                or not all(isinstance(e, (int, float)) for e in edges)
                or sorted(edges) != edges):
            probs.append(f"hist_ms.edges must be ascending numbers, "
                         f"got {edges!r}")
        if (not isinstance(counts, list)
                or not all(isinstance(c, int) and not isinstance(c, bool)
                           and c >= 0 for c in counts)):
            probs.append(f"hist_ms.counts must be non-negative ints, "
                         f"got {counts!r}")
        elif isinstance(edges, list) and len(counts) != len(edges) + 1:
            probs.append(
                f"hist_ms.counts has {len(counts)} bins for "
                f"{len(edges)} edges (need len(edges) + 1)"
            )
        elif counted and sum(counts) != ok + failed:
            probs.append(
                f"hist_ms.counts sum {sum(counts)} != ok + failed "
                f"{ok + failed}"
            )
    sm = block.get("sampled")
    if (counted and isinstance(sm, int) and not isinstance(sm, bool)
            and sm > ok + failed):
        probs.append(f"sampled {sm} > ok + failed {ok + failed}")
    if not isinstance(block.get("samples_capped"), bool):
        probs.append(
            f"samples_capped must be a bool, "
            f"got {block.get('samples_capped')!r}"
        )
    occ = block.get("occupancy_mean")
    if not isinstance(occ, (int, float)) or isinstance(occ, bool) \
            or not 0.0 <= occ <= 1.0:
        probs.append(f"occupancy_mean must be in [0, 1], got {occ!r}")
    ops = block.get("ops")
    if not isinstance(ops, dict):
        probs.append(f"ops must be an object, got {ops!r}")
    else:
        for name, v in ops.items():
            if name not in _REQ_STATS_OPS:
                probs.append(
                    f"ops key {name!r} is not a known serve op "
                    f"{_REQ_STATS_OPS}"
                )
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                probs.append(
                    f"ops[{name!r}] must be a non-negative int, got {v!r}"
                )
    pb = block.get("per_bucket")
    if not isinstance(pb, dict):
        probs.append(f"per_bucket must be an object, got {pb!r}")
    else:
        for label, cell in pb.items():
            if not isinstance(cell, dict):
                probs.append(f"per_bucket[{label!r}] is not an object")
                continue
            for key in ("requests", "shed", "batches"):
                v = cell.get(key)
                if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                    probs.append(
                        f"per_bucket[{label!r}].{key} must be a "
                        f"non-negative int, got {v!r}"
                    )
            co = cell.get("occupancy_mean")
            if not isinstance(co, (int, float)) or isinstance(co, bool) \
                    or not 0.0 <= co <= 1.0:
                probs.append(
                    f"per_bucket[{label!r}].occupancy_mean must be in "
                    f"[0, 1], got {co!r}"
                )
    return probs


#: session_stats schema (serve/sessions.SessionManager.stats): required
#: counter keys of one serve:session_stats record.
_SESSION_STATS_COUNTS = ("opens", "reseeds", "appends", "solves",
                         "contracts", "closes", "failures",
                         "evicted_failures", "hits", "misses",
                         "sessions_open", "sessions_known",
                         "blocks_appended", "blocks_dropped")


def validate_session_stats(block) -> list[str]:
    """Schema problems of one session_stats block ([] = valid) — a
    `serve.sessions.SessionManager` counter snapshot (the reference's docs/
    SERVING.md 'Streaming sessions').  Same posture as request_stats:
    structurally validated on every diff, never metric-compared — a
    session workload's hit-rate is the workload's property; its gates are
    ``obs serve-report --min-session-hit-rate / --max-reseeds``.
    Coherence checks pin the manager's promises: hit_rate consistent
    with hits/misses, misses == evicted_failures (the only miss is an
    evicted factor), reseeds <= opens, sessions_open <= sessions_known,
    blocks_dropped <= blocks_appended (a chain cannot contract blocks it
    never streamed)."""
    if not isinstance(block, dict):
        return [f"session_stats is {type(block).__name__}, expected object"]
    probs = []
    if block.get("schema_version") != SCHEMA_VERSION:
        probs.append(
            f"schema_version {block.get('schema_version')!r} != "
            f"{SCHEMA_VERSION}"
        )
    for key in _SESSION_STATS_COUNTS:
        v = block.get(key)
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            probs.append(f"{key} must be a non-negative int, got {v!r}")
    hr = block.get("hit_rate")
    if not isinstance(hr, (int, float)) or isinstance(hr, bool) \
            or not 0.0 <= hr <= 1.0:
        probs.append(f"hit_rate must be in [0, 1], got {hr!r}")
    h, m = block.get("hits"), block.get("misses")
    ints = all(isinstance(v, int) and not isinstance(v, bool)
               for v in (h, m))
    if (ints and isinstance(hr, (int, float)) and h + m > 0
            and abs(hr - h / (h + m)) > 1e-6):
        probs.append(
            f"hit_rate {hr!r} inconsistent with hits={h} misses={m} "
            f"(expected {h / (h + m):.6f})"
        )
    ev = block.get("evicted_failures")
    if (isinstance(m, int) and isinstance(ev, int)
            and not isinstance(m, bool) and m != ev):
        probs.append(
            f"misses {m} != evicted_failures {ev} (the only session "
            "miss is an evicted resident factor)"
        )
    rs, op = block.get("reseeds"), block.get("opens")
    if isinstance(rs, int) and isinstance(op, int) and rs > op:
        probs.append(f"reseeds {rs} > opens {op}")
    so, sk = block.get("sessions_open"), block.get("sessions_known")
    if isinstance(so, int) and isinstance(sk, int) and so > sk:
        probs.append(f"sessions_open {so} > sessions_known {sk}")
    ba, bd = block.get("blocks_appended"), block.get("blocks_dropped")
    if isinstance(ba, int) and isinstance(bd, int) and bd > ba:
        probs.append(f"blocks_dropped {bd} > blocks_appended {ba}")
    return probs


def _event_status(rec: dict) -> Optional[str]:
    """The robustness status of a record, when it carries one.

    'failed' / 'recovered' come from an explicit event block (sweep failure
    containment, autotune/sweep.py); 'recovery' is derived from a robust
    block with nonzero breakdown/shift/escalation counters (a bench run
    that went through the shifted-CholeskyQR path).  Records with a status
    are exempt from the measured-value comparison in diff(): a run that
    paid recovery sweeps (or failed outright) is slower BY DESIGN, and
    reading that as a throughput regression would teach people to strip
    the robust path before benchmarking.  'serve' marks request_stats
    records (serve/stats.py): a served workload's latency mix is the
    workload's property, not a kernel's — its regression story is
    ``obs serve-report`` gates, not the bench metric check.  'lint' marks
    lint_report records (capital_tpu_torch.lint CLI) for the same reason — their
    gate is ``obs lint-report``."""
    if rec.get("request_stats") is not None:
        return "serve"
    if rec.get("session_stats") is not None:
        # streaming-session counter records (serve/sessions.py): gated
        # by ``obs serve-report --min-session-hit-rate / --max-reseeds``
        return "serve"
    if rec.get("serve_trace") is not None \
            or rec.get("serve_window") is not None:
        # span-chain / rolling-window telemetry records (obs/spans.py,
        # serve/telemetry.py): same story as request_stats — their gates
        # are ``obs serve-report --min-trace-complete/--min-windows``
        return "serve"
    if rec.get("lint_report") is not None:
        return "lint"
    ev = rec.get("event")
    if isinstance(ev, dict) and ev.get("status"):
        return str(ev["status"])
    rb = rec.get("robust")
    if isinstance(rb, dict) and any(
        rb.get(k) for k in ("breakdown", "shifted", "escalated")
    ):
        return "recovery"
    return None


def diff(
    a_recs: Iterable[dict],
    b_recs: Iterable[dict],
    tol_metric: float = 0.10,
    tol_hbm: float = 0.05,
    tol_collective: int = 0,
) -> list[Regression]:
    """Regressions going from ledger `a` (baseline) to ledger `b`.

    * measured value (e.g. TFLOP/s): b below a by more than tol_metric;
    * collective counts by kind: b above a by more than tol_collective;
    * peak HBM: b above a by more than tol_hbm (fractional).

    Only keys present in BOTH ledgers are compared (a missing row is a
    coverage change, not a regression); multiple records per key compare
    last-against-last (the ledger is append-ordered, so the last record is
    the freshest trial).  Records carrying a failure/recovery status
    (_event_status) skip ONLY the measured-value check — their walls
    include recovery work or are absent entirely; the structural checks
    (collectives, peak HBM) still apply.  request_stats records are exempt
    the same way, but their block must VALIDATE
    (validate_request_stats) — a malformed one raises LedgerIncompatible
    like any other apples-to-oranges input."""
    a_recs, b_recs = list(a_recs), list(b_recs)
    for r in (*a_recs, *b_recs):
        rs = r.get("request_stats")
        if rs is not None:
            probs = validate_request_stats(rs)
            if probs:
                raise LedgerIncompatible(
                    "malformed request_stats record: " + "; ".join(probs)
                )
        st = r.get("serve_trace")
        if st is not None:
            probs = validate_serve_trace(st)
            if probs:
                raise LedgerIncompatible(
                    "malformed serve_trace record: " + "; ".join(probs)
                )
        sw = r.get("serve_window")
        if sw is not None:
            probs = validate_serve_window(sw)
            if probs:
                raise LedgerIncompatible(
                    "malformed serve_window record: " + "; ".join(probs)
                )
        ss = r.get("session_stats")
        if ss is not None:
            probs = validate_session_stats(ss)
            if probs:
                raise LedgerIncompatible(
                    "malformed session_stats record: " + "; ".join(probs)
                )
        lr = r.get("lint_report")
        if lr is not None:
            probs = validate_lint_report(lr)
            if probs:
                raise LedgerIncompatible(
                    "malformed lint_report record: " + "; ".join(probs)
                )
        meas = r.get("measured")
        if isinstance(meas, dict) and (
            "phase_seconds" in meas or "bubble_frac" in meas
        ):
            probs = validate_phase_seconds(meas)
            if probs:
                raise LedgerIncompatible(
                    "malformed phase attribution record: " + "; ".join(probs)
                )
        if isinstance(meas, dict) and str(
            meas.get("metric", "")
        ).startswith("blocktri"):
            probs = validate_blocktri_measured(meas)
            if probs:
                raise LedgerIncompatible(
                    "malformed blocktri bench record: " + "; ".join(probs)
                )
        if isinstance(meas, dict) and str(
            meas.get("metric", "")
        ).startswith("arrowhead"):
            probs = validate_arrowhead_measured(meas)
            if probs:
                raise LedgerIncompatible(
                    "malformed arrowhead bench record: " + "; ".join(probs)
                )
        if isinstance(meas, dict) and str(
            meas.get("metric", "")
        ).startswith("update"):
            probs = validate_update_measured(meas)
            if probs:
                raise LedgerIncompatible(
                    "malformed update bench record: " + "; ".join(probs)
                )
        if isinstance(meas, dict) and str(
            meas.get("metric", "")
        ).startswith("refine"):
            probs = validate_refine_measured(meas)
            if probs:
                raise LedgerIncompatible(
                    "malformed refine bench record: " + "; ".join(probs)
                )
    a_by = {_key(r): r for r in a_recs}
    b_by = {_key(r): r for r in b_recs}
    out: list[Regression] = []
    for key in sorted(set(a_by) & set(b_by)):
        a, b = a_by[key], b_by[key]
        _check_comparable(a, b)
        am, bm = a.get("measured") or {}, b.get("measured") or {}
        av, bv = am.get("value"), bm.get("value")
        exempt = _event_status(a) or _event_status(b)
        if not exempt and av and bv and bv < av * (1.0 - tol_metric):
            out.append(
                Regression(
                    key, "measured.value", av, bv,
                    f"{am.get('unit', '')} dropped >{tol_metric:.0%}",
                )
            )
        aa, ba = a.get("audit") or {}, b.get("audit") or {}
        for kind, ac in (aa.get("collective_counts") or {}).items():
            bc = (ba.get("collective_counts") or {}).get(kind)
            if bc is not None and bc > ac + tol_collective:
                out.append(
                    Regression(
                        key, f"collectives.{kind}", ac, bc,
                        "compiled program gained collectives",
                    )
                )
        ah, bh = aa.get("peak_hbm_bytes"), ba.get("peak_hbm_bytes")
        if ah and bh and bh > ah * (1.0 + tol_hbm):
            out.append(
                Regression(
                    key, "peak_hbm_bytes", ah, bh,
                    f"peak memory grew >{tol_hbm:.0%}",
                )
            )
    return out
