"""CLI: ``python -m capital_tpu_torch.obs {diff, robust-gate, serve-report,
lint-report, trace-report, timeline} ...`` (counterpart of
capital_tpu/obs/__main__.py: the same commands, flags, report lines and
exit codes).

``diff`` compares two ledger JSONL files and exits 1 when a measured
metric, collective count, or peak-memory regression beyond tolerance
appears; exit 2 means the ledgers are not comparable (schema/device
mismatch, or a malformed block).

``robust-gate`` is the self-check of the robustness exemption: a
breakdown-recovery/failure record must pass diff un-flagged while the same
value drop WITHOUT the status still flags.

``serve-report`` summarizes the serve records of a ledger
(serve:request_stats, serve:trace, serve:window, serve:session_stats) and
optionally gates on them: cache hit-rate, p99 latency (all and small-N),
occupancy, queue wait, residency and session hit-rates, reseeds,
refinement sweeps, replica count, chain completeness, window count.

``lint-report`` summarizes the lint:report records of a ledger
(``python -m capital_tpu_torch.lint ... --ledger``) and gates on each
report's own pass/fail outcome.

``trace-report`` summarizes the phase-attribution records of a ledger —
the per-phase wall split plus bubble_frac — and optionally gates on
bubble_frac.

``timeline`` renders the serve:trace records of a ledger (obs/spans.py;
``serve smoke --trace`` / ``loadgen --trace`` producers): per-run chain
completeness, the per-span duration split, SLO-violation attribution, and
— with ``--chrome out.json`` — a Chrome-trace-event export for
chrome://tracing / Perfetto.  It exits 1 when the ledger carries NO
serve:trace records and 2 on a malformed one.

Exit codes throughout: 0 pass, 1 a gate failed (or a requested gate had
nothing to check), 2 a malformed or incomparable record.

The reference's ``audit`` (a driver config's compiled XLA program against
the cost model) has no counterpart: the port has no compiler IR to read.
Nor do ``--platform`` / ``--host-devices``: every command reads files and
touches no device, so the CLI loads neither torch nor jax.

Examples::

    python -m capital_tpu_torch.obs diff baseline.jsonl current.jsonl
    python -m capital_tpu_torch.obs serve-report smoke.jsonl --min-hit-rate 1.0
    python -m capital_tpu_torch.obs timeline smoke.jsonl --chrome trace.json
"""

from __future__ import annotations

import argparse
import json
import sys


def _robust_gate(args) -> int:
    """CI gate: a breakdown-recovery record must round-trip through
    ledger.diff WITHOUT being misread as a metric regression — and the
    exemption must be doing the work (the same records stripped of their
    robust/event blocks MUST flag).  Pure in-memory check, no device."""
    from capital_tpu_torch.obs import ledger

    man = ledger.host_manifest(dtype="float32", config_id="robust_gate_probe")
    base = ledger.record(
        "bench:cacqr", dict(man),
        measured={"metric": "cacqr", "value": 100.0, "unit": "TFLOP/s"},
    )
    # a recovery run: slower by far more than any tol_metric, carrying both
    # signal shapes (the sweep's event block and the bench robust block)
    recov = ledger.record(
        "bench:cacqr", dict(man),
        measured={"metric": "cacqr", "value": 40.0, "unit": "TFLOP/s"},
        robust={"breakdown": 1, "shifted": 1, "escalated": 1, "info": 0},
        event={"status": "recovered"},
    )
    regs = ledger.diff([base], [recov])
    if regs:
        print("# robust-gate: recovery record misread as regression:",
              file=sys.stderr)
        for r in regs:
            print(r.line(), file=sys.stderr)
        return 1
    stripped = dict(recov)
    stripped.pop("robust", None)
    stripped.pop("event", None)
    if not ledger.diff([base], [stripped]):
        print("# robust-gate: value check is dead — a 60% drop without a "
              "recovery status did not flag", file=sys.stderr)
        return 1
    print("# robust-gate OK: recovery events exempt from the metric check, "
          "plain drops still flag")
    return 0


def _serve_report(args) -> int:
    """Summarize the serve records of a ledger — request_stats snapshots
    plus the serve:trace / serve:window telemetry records — with optional
    gates (the second half of the reference Makefile's serve-smoke /
    serve-trace targets, and of chip_smoke.py's phase 7d).
    Exit 2 on a malformed record, 1 on a gate failure (or gates requested
    with no records to exercise them)."""
    from capital_tpu_torch.obs import ledger

    recs = ledger.read(args.ledger)
    rows = [r for r in recs if r.get("request_stats") is not None]
    trows = [r for r in recs if r.get("serve_trace") is not None]
    wrows = [r for r in recs if r.get("serve_window") is not None]
    srows = [r for r in recs if r.get("session_stats") is not None]
    bad = 0
    for i, r in enumerate(rows):
        for p in ledger.validate_request_stats(r["request_stats"]):
            print(f"malformed request_stats record #{i}: {p}",
                  file=sys.stderr)
            bad += 1
    for i, r in enumerate(trows):
        for p in ledger.validate_serve_trace(r["serve_trace"]):
            print(f"malformed serve_trace record #{i}: {p}",
                  file=sys.stderr)
            bad += 1
    for i, r in enumerate(wrows):
        for p in ledger.validate_serve_window(r["serve_window"]):
            print(f"malformed serve_window record #{i}: {p}",
                  file=sys.stderr)
            bad += 1
    for i, r in enumerate(srows):
        for p in ledger.validate_session_stats(r["session_stats"]):
            print(f"malformed session_stats record #{i}: {p}",
                  file=sys.stderr)
            bad += 1
    if bad:
        return 2
    gates_on = (args.min_hit_rate is not None
                or args.max_p99_ms is not None
                or args.max_p99_ms_small is not None
                or args.min_occupancy is not None
                or args.max_queue_wait_ms is not None
                or args.min_residency_hit_rate is not None
                or args.max_refine_iters is not None
                or args.min_converged_frac is not None
                or args.min_replicas is not None
                or args.min_trace_complete is not None
                or args.min_windows is not None
                or args.min_session_hit_rate is not None
                or args.max_reseeds is not None
                or args.aggregate)
    if not rows and not trows and not wrows and not srows:
        print(f"# no serve records in {args.ledger} "
              f"({len(recs)} records total)")
        return 1 if gates_on else 0
    failures = []
    small_seen = 0
    split_seen = 0
    factor_seen = 0
    refine_seen = 0
    for i, r in enumerate(rows):
        rs = r["request_stats"]
        man = r.get("manifest") or {}
        cache = rs["cache"]
        lat = rs["latency_ms"]
        lat_small = rs.get("latency_ms_small")
        qwait = rs.get("queue_wait_ms")
        fc = rs.get("factor_cache")
        fc_note = (
            f" factor_cache hits={fc['hits']} misses={fc['misses']} "
            f"evictions={fc['evictions']} degrades={fc['downdate_degrades']} "
            f"hit_rate={fc['hit_rate']:.3f}" if fc else ""
        )
        small_note = (
            f" small requests={rs.get('requests_small', 0)} "
            f"p99={lat_small['p99']}" if lat_small else ""
        )
        split_note = (
            f" queue_wait p99={qwait['p99']} "
            f"device p99={rs['device_ms']['p99']}"
            if qwait and rs.get("device_ms") else ""
        )
        # per-op request mix (Collector.ops) — includes posv_blocktri
        # since the chain op joined the serve surface
        ops = rs.get("ops")
        ops_note = (
            " ops " + " ".join(f"{k}={ops[k]}" for k in sorted(ops))
            if ops else ""
        )
        # posv_blocktri algorithm split (scan vs partitioned Spike driver
        # — Collector.blocktri_impls); absent without blocktri traffic
        bti = rs.get("blocktri_impls")
        bti_note = (
            " blocktri " + " ".join(f"{k}={bti[k]}" for k in sorted(bti))
            if bti else ""
        )
        # guaranteed-tier refinement telemetry (Collector.note_refine);
        # absent without accuracy_tier='guaranteed' traffic
        rf = rs.get("refine")
        rf_note = (
            f" refine requests={rf['requests']} "
            f"converged_frac={rf['converged_frac']} "
            f"iters_max={rf['iters_max']} resid_max={rf['resid_max']:.2e}"
            if rf else ""
        )
        print(
            f"# [{i}] {man.get('platform', '?')}/{man.get('device', '?')} "
            f"requests={rs['requests']} ok={rs['ok']} "
            f"flagged={rs['flagged']} failed={rs['failed']} "
            f"latency_ms p50={lat['p50']} p95={lat['p95']} p99={lat['p99']} "
            f"occupancy={rs['batch_occupancy_mean']} "
            f"queue_max={rs['queue_depth_max']} "
            f"cache hits={cache['hits']} misses={cache['misses']} "
            f"hit_rate={cache['hit_rate']:.3f}"
            + small_note + split_note + ops_note + bti_note + rf_note
            + fc_note
        )
        if (args.min_hit_rate is not None
                and cache["hit_rate"] < args.min_hit_rate):
            failures.append(
                f"record #{i}: hit_rate {cache['hit_rate']:.3f} < "
                f"{args.min_hit_rate}"
            )
        if args.max_p99_ms is not None and lat["p99"] > args.max_p99_ms:
            failures.append(
                f"record #{i}: p99 {lat['p99']}ms > {args.max_p99_ms}ms"
            )
        if (args.min_occupancy is not None
                and rs["batch_occupancy_mean"] < args.min_occupancy):
            failures.append(
                f"record #{i}: batch occupancy "
                f"{rs['batch_occupancy_mean']} < {args.min_occupancy} "
                "(batches flushing too empty — widen max_delay_s or the "
                "bucket ladders, or raise offered load)"
            )
        if lat_small is not None:
            small_seen += 1
            if (args.max_p99_ms_small is not None
                    and lat_small["p99"] > args.max_p99_ms_small):
                failures.append(
                    f"record #{i}: small-bucket p99 {lat_small['p99']}ms > "
                    f"{args.max_p99_ms_small}ms"
                )
        if fc is not None:
            factor_seen += 1
            if (args.min_residency_hit_rate is not None
                    and fc["hit_rate"] < args.min_residency_hit_rate):
                failures.append(
                    f"record #{i}: factor-residency hit_rate "
                    f"{fc['hit_rate']:.3f} < {args.min_residency_hit_rate} "
                    "(tokens evicted under the byte budget, or clients "
                    "updating factors that were never seeded — see "
                    "docs/SERVING.md 'Factor residency')"
                )
        if rf is not None:
            refine_seen += 1
            if (args.max_refine_iters is not None
                    and rf["iters_max"] > args.max_refine_iters):
                failures.append(
                    f"record #{i}: refine iters_max {rf['iters_max']} > "
                    f"{args.max_refine_iters} (guaranteed-tier requests "
                    "burning more correction sweeps than the latency "
                    "budget planned for — operands more ill-conditioned "
                    "than the tier's factor dtype expects?)"
                )
            if (args.min_converged_frac is not None
                    and rf["converged_frac"] < args.min_converged_frac):
                failures.append(
                    f"record #{i}: refine converged_frac "
                    f"{rf['converged_frac']} < {args.min_converged_frac} "
                    "(guaranteed-tier requests failing loudly instead of "
                    "converging — see docs/SERVING.md 'Accuracy tiers')"
                )
        if qwait is not None:
            split_seen += 1
            if (args.max_queue_wait_ms is not None
                    and qwait["p99"] > args.max_queue_wait_ms):
                failures.append(
                    f"record #{i}: queue-wait p99 {qwait['p99']}ms > "
                    f"{args.max_queue_wait_ms}ms (scheduling delay, not "
                    "device time — check flush policy / in-flight window)"
                )
    if args.max_p99_ms_small is not None and not small_seen:
        # same posture as gates-with-no-records: a requested gate that
        # nothing exercised is a silently-dead gate, so it fails loudly.
        failures.append(
            "--max-p99-ms-small requested but no record carries a "
            "latency_ms_small block (no small-bucket traffic served?)"
        )
    # per-request span traces (serve:trace records — obs/spans.py): the
    # --min-trace-complete gate reads each record's complete/requests
    # verdict, computed under the record's own pinned bubble tolerance.
    for i, r in enumerate(trows):
        st = r["serve_trace"]
        print(
            f"# trace[{i}] requests={st['requests']} "
            f"complete={st['complete']} dropped={st['dropped']} "
            f"violations={st['violations']} "
            f"bubble_tol_ms={st['bubble_tol_ms']}"
        )
    if args.min_trace_complete is not None:
        if not trows:
            failures.append(
                "--min-trace-complete requested but no record carries a "
                "serve_trace block (run the producer with --trace?)"
            )
        for i, r in enumerate(trows):
            st = r["serve_trace"]
            if st["requests"] == 0:
                failures.append(
                    f"trace record #{i}: zero traced requests — an empty "
                    "trace log can never satisfy --min-trace-complete"
                )
                continue
            frac = st["complete"] / st["requests"]
            if frac < args.min_trace_complete:
                from capital_tpu_torch.obs import spans

                broken = [
                    t.get("request_id")
                    for t in st["traces"]
                    if spans.trace_dict_problems(t, st["bubble_tol_ms"])
                ]
                failures.append(
                    f"trace record #{i}: {st['complete']}/{st['requests']} "
                    f"chains complete ({frac:.3f} < "
                    f"{args.min_trace_complete}); incomplete request ids: "
                    f"{broken[:8]}"
                )
    # rolling windows (serve:window records — serve/telemetry.py): the
    # --min-windows gate counts RECORDS, one per closed non-empty window,
    # so it fails loudly both when telemetry was never enabled and when
    # the run was too short to close enough windows.
    if wrows:
        wreq = sum(r["serve_window"]["requests"] for r in wrows)
        worst = max(r["serve_window"]["latency_ms"]["p99"] for r in wrows)
        shed = sum(r["serve_window"]["shed"] for r in wrows)
        print(
            f"# windows: {len(wrows)} record(s) requests={wreq} "
            f"shed={shed} worst p99={worst}ms "
            f"window_s={wrows[0]['serve_window']['window_s']}"
        )
    if args.min_windows is not None and len(wrows) < args.min_windows:
        failures.append(
            f"{len(wrows)} serve_window record(s) < --min-windows "
            f"{args.min_windows} (telemetry not enabled via --window-s, "
            "or the run closed too few non-empty windows)"
        )
    # streaming-session protocol counters (serve:session_stats records —
    # serve/sessions.py SessionManager.emit_session_stats): hit_rate is
    # the fraction of resident requests that found their chain still in
    # the FactorCache, reseeds counts re-opens of evicted sessions.  Both
    # gates fail loudly when requested with no session_stats record in
    # the ledger — a gate nothing exercised is a silently-dead gate
    # (docs/SERVING.md 'Streaming sessions').
    for i, r in enumerate(srows):
        ss = r["session_stats"]
        print(
            f"# session[{i}] opens={ss['opens']} reseeds={ss['reseeds']} "
            f"appends={ss['appends']} solves={ss['solves']} "
            f"contracts={ss['contracts']} closes={ss['closes']} "
            f"failures={ss['failures']} evicted={ss['evicted_failures']} "
            f"hit_rate={ss['hit_rate']:.3f} "
            f"blocks +{ss['blocks_appended']}/-{ss['blocks_dropped']}"
        )
        if (args.min_session_hit_rate is not None
                and ss["hit_rate"] < args.min_session_hit_rate):
            failures.append(
                f"session record #{i}: session hit_rate "
                f"{ss['hit_rate']:.3f} < {args.min_session_hit_rate} "
                "(resident chains evicted under cache pressure mid-"
                "session — raise factor_cache_bytes or contract sooner; "
                "docs/SERVING.md 'Streaming sessions')"
            )
        if (args.max_reseeds is not None
                and ss["reseeds"] > args.max_reseeds):
            failures.append(
                f"session record #{i}: {ss['reseeds']} reseed(s) > "
                f"--max-reseeds {args.max_reseeds} (clients re-opening "
                "evicted sessions — each reseed re-ships and re-factors "
                "the whole window the protocol exists to avoid)"
            )
    if (args.min_session_hit_rate is not None
            or args.max_reseeds is not None) and not srows:
        failures.append(
            "--min-session-hit-rate/--max-reseeds requested but no record "
            "carries a session_stats block (no session traffic served, or "
            "the producer never called emit_session_stats?)"
        )
    # cross-replica aggregation (docs/SERVING.md "Multi-replica serving"):
    # fold every replica-TAGGED record through stats.merge_snapshots and
    # report the fleet view — summed counts, worst tail, summed router-block
    # QPS, and a per-replica occupancy table.  --min-replicas is the
    # it-really-was-multi-replica gate: it fails loudly when the ledger
    # carries fewer distinct replica tags than claimed (or none at all).
    if args.aggregate or args.min_replicas is not None:
        from capital_tpu_torch.serve import stats as serve_stats

        tagged = [r for r in rows if r["request_stats"].get("replica_id")]
        ids = sorted({r["request_stats"]["replica_id"] for r in tagged})
        if not tagged:
            failures.append(
                "--aggregate/--min-replicas requested but no record "
                "carries a replica_id tag (single-engine ledger, or the "
                "router never emitted stats?)"
            )
        else:
            merged = serve_stats.merge_snapshots(
                [r["request_stats"] for r in tagged])
            qps = [r["router"]["qps"] for r in recs
                   if isinstance(r.get("router"), dict)
                   and isinstance(r["router"].get("qps"), (int, float))]
            qps_note = (f" qps_sum={round(sum(qps), 3)}"
                        f" (over {len(qps)} router block(s))" if qps else "")
            print(
                f"# aggregate[{len(tagged)} records, "
                f"{len(ids)} replica(s) {ids}]: "
                f"requests={merged['requests']} ok={merged['ok']} "
                f"failed={merged['failed']} "
                f"worst p99={merged['latency_ms']['p99']}ms "
                f"cache hits={merged['cache']['hits']} "
                f"misses={merged['cache']['misses']} "
                f"hit_rate={merged['cache']['hit_rate']:.3f} "
                f"compiles={merged['cache'].get('compiles', 0)}" + qps_note
            )
            for r in tagged:
                rs = r["request_stats"]
                print(
                    f"#   replica {rs['replica_id']}: "
                    f"requests={rs['requests']} batches={rs['batches']} "
                    f"occupancy={rs['batch_occupancy_mean']} "
                    f"p99={rs['latency_ms']['p99']}ms"
                )
            if (args.min_replicas is not None
                    and len(ids) < args.min_replicas):
                failures.append(
                    f"{len(ids)} distinct replica tag(s) {ids} < "
                    f"--min-replicas {args.min_replicas}"
                )
            if (args.min_hit_rate is not None
                    and merged["cache"]["hit_rate"] < args.min_hit_rate):
                # name the offenders: a fleet-level number alone sends the
                # operator hunting through every replica's log — the
                # per-replica rates say WHICH engine's cache went cold
                per = {
                    r["request_stats"]["replica_id"]:
                        r["request_stats"]["cache"]["hit_rate"]
                    for r in tagged
                }
                offenders = sorted(
                    rid for rid, hr in per.items()
                    if hr < args.min_hit_rate
                )
                per_note = " ".join(
                    f"{rid}={per[rid]:.3f}" for rid in sorted(per)
                )
                who = (str(offenders) if offenders
                       else "(none individually — the merged union "
                            "fell below the gate)")
                failures.append(
                    f"aggregate hit_rate {merged['cache']['hit_rate']:.3f} "
                    f"< {args.min_hit_rate} (per-replica: {per_note}; "
                    f"offending replica_id(s): {who})"
                )
    if args.min_residency_hit_rate is not None and not factor_seen:
        failures.append(
            "--min-residency-hit-rate requested but no record carries a "
            "factor_cache block (no factor-token traffic served?)"
        )
    if args.max_queue_wait_ms is not None and not split_seen:
        failures.append(
            "--max-queue-wait-ms requested but no record carries a "
            "queue_wait_ms block (records predate the latency split, or "
            "nothing dispatched?)"
        )
    if (args.max_refine_iters is not None
            or args.min_converged_frac is not None) and not refine_seen:
        failures.append(
            "--max-refine-iters/--min-converged-frac requested but no "
            "record carries a refine block (no accuracy_tier='guaranteed' "
            "traffic served?)"
        )
    for f in failures:
        print(f"serve-report gate FAIL: {f}", file=sys.stderr)
    if failures:
        return 1
    print(f"# serve-report OK ({len(rows)} request_stats, "
          f"{len(trows)} serve_trace, {len(wrows)} serve_window, "
          f"{len(srows)} session_stats record(s))")
    return 0


def _lint_report(args) -> int:
    """Summarize the lint:report records of a ledger (the second half of
    the reference Makefile's lint target).  Exit 2 on a malformed record,
    1 when any report's gate failed (or --require-pass names a pass with
    no record)."""
    from capital_tpu_torch.obs import ledger

    recs = ledger.read(args.ledger)
    rows = [r for r in recs if r.get("lint_report") is not None]
    bad = 0
    for i, r in enumerate(rows):
        for p in ledger.validate_lint_report(r["lint_report"]):
            print(f"malformed lint_report record #{i}: {p}", file=sys.stderr)
            bad += 1
    if bad:
        return 2
    required = set(args.require_pass or [])
    if not rows:
        print(f"# no lint_report records in {args.ledger} "
              f"({len(recs)} records total)")
        return 1 if required else 0
    failures = []
    seen = set()
    for i, r in enumerate(rows):
        lr = r["lint_report"]
        seen.add(lr["pass"])
        counts = lr["counts"]
        print(
            f"# [{i}] pass={lr['pass']} fail_on={lr['fail_on']} "
            f"ok={lr['ok']} errors={counts['error']} warns={counts['warn']} "
            f"info={counts['info']} suppressed={lr['suppressed']}"
        )
        for f in lr["findings"]:
            print(f"#     {f['severity']} {f['rule']} {f['target']}: "
                  f"{f['message']}")
        if not lr["ok"]:
            failures.append(
                f"record #{i}: {lr['pass']} pass failed its "
                f"fail_on={lr['fail_on']} gate "
                f"({counts['error']} error(s), {counts['warn']} warn(s))"
            )
    for name in sorted(required - seen):
        failures.append(f"required pass {name!r} has no lint_report record")
    for f in failures:
        print(f"lint-report gate FAIL: {f}", file=sys.stderr)
    if failures:
        return 1
    print(f"# lint-report OK ({len(rows)} lint_report record(s))")
    return 0


def _trace_report(args) -> int:
    """Summarize the phase-attribution records of a ledger (bench:trace
    producers).  Exit 2 on a malformed phase_seconds block, 1 on a gate
    failure — including a requested gate with no records to exercise it
    (same no-silently-dead-gates posture as serve-report's split gates)."""
    from capital_tpu_torch.obs import ledger

    recs = ledger.read(args.ledger)
    rows = [
        r for r in recs
        if isinstance(r.get("measured"), dict)
        and r["measured"].get("phase_seconds") is not None
    ]
    bad = 0
    for i, r in enumerate(rows):
        for p in ledger.validate_phase_seconds(r["measured"]):
            print(f"malformed phase attribution record #{i}: {p}",
                  file=sys.stderr)
            bad += 1
    if bad:
        return 2
    if not rows:
        print(f"# no phase_seconds records in {args.ledger} "
              f"({len(recs)} records total)")
        return 1 if args.max_bubble_frac is not None else 0
    failures = []
    for i, r in enumerate(rows):
        meas = r["measured"]
        man = r.get("manifest") or {}
        ps = meas["phase_seconds"]
        total = sum(ps.values())
        bf = meas.get("bubble_frac")
        print(
            f"# [{i}] {r.get('kind', '?')} {man.get('platform', '?')}/"
            f"{man.get('device', '?')} n={meas.get('n', '?')} "
            f"attributed={total * 1e3:.3f} ms/iter "
            f"bubble_frac={bf if bf is not None else '?'}"
        )
        for tag, v in sorted(ps.items(), key=lambda kv: -kv[1]):
            pct = 100 * v / total if total > 0 else 0.0
            print(f"#     {tag:16s} {v * 1e3:9.3f} ms/iter  {pct:5.1f}%")
        if args.max_bubble_frac is not None:
            if bf is None:
                failures.append(
                    f"record #{i}: carries phase_seconds but no bubble_frac"
                )
            elif bf > args.max_bubble_frac:
                failures.append(
                    f"record #{i}: bubble_frac {bf} > {args.max_bubble_frac} "
                    "(unattributed wall grew — see the phase split above)"
                )
    for f in failures:
        print(f"trace-report gate FAIL: {f}", file=sys.stderr)
    if failures:
        return 1
    print(f"# trace-report OK ({len(rows)} phase-attribution record(s))")
    return 0


def _timeline(args) -> int:
    """Render the serve:trace records of a ledger: per-run completeness,
    the per-span duration split, the slowest requests, SLO-violation
    attribution, and (with --chrome) the Chrome-trace-event export.  Exit
    2 on a malformed record; exit 1 when the ledger carries NO serve_trace
    records — a timeline with nothing to show is a producer wiring bug
    (--trace not passed), never a quiet pass."""
    from collections import Counter, defaultdict

    from capital_tpu_torch.obs import ledger, spans

    recs = ledger.read(args.ledger)
    rows = [r for r in recs if r.get("serve_trace") is not None]
    bad = 0
    for i, r in enumerate(rows):
        for p in ledger.validate_serve_trace(r["serve_trace"]):
            print(f"malformed serve_trace record #{i}: {p}",
                  file=sys.stderr)
            bad += 1
    if bad:
        return 2
    if not rows:
        print(
            f"timeline: no serve_trace records in {args.ledger} "
            f"({len(recs)} records total) — run the serve producer with "
            "--trace to emit them", file=sys.stderr,
        )
        return 1
    traces = []
    for i, r in enumerate(rows):
        st = r["serve_trace"]
        print(
            f"# [{i}] requests={st['requests']} complete={st['complete']} "
            f"dropped={st['dropped']} violations={st['violations']} "
            f"bubble_tol_ms={st['bubble_tol_ms']}"
        )
        traces.extend(st["traces"])
    # where a request's life goes, per span name across every trace
    durs = defaultdict(list)
    for t in traces:
        for sp in t.get("spans", ()):
            durs[sp["name"]].append(sp["dur_ms"])
    total = sum(sum(v) for v in durs.values())
    for name in spans.CHAIN:
        if name not in durs:
            continue
        v = durs[name]
        share = 100.0 * sum(v) / total if total else 0.0
        print(
            f"#   {name:12s} n={len(v):5d} mean={sum(v) / len(v):9.3f} ms "
            f"max={max(v):9.3f} ms  {share:5.1f}%"
        )
    for t in sorted(traces, key=lambda t: -t.get("latency_ms", 0.0)
                    )[: args.top]:
        chain = " ".join(
            f"{sp['name']}={sp['dur_ms']:.3f}" for sp in t.get("spans", ())
        )
        print(
            f"#   slow request {t.get('request_id')} "
            f"[{t.get('kind')}/{t.get('op')}"
            f"{'/' + t['replica_id'] if t.get('replica_id') else ''}] "
            f"{t.get('latency_ms')}ms: {chain}"
        )
    viol = [t for t in traces if t.get("violated")]
    if viol:
        attr = Counter(str(t.get("attribution")) for t in viol)
        print(
            f"#   SLO violations: {len(viol)}/{len(traces)} — attribution "
            + " ".join(f"{k}={n}" for k, n in attr.most_common())
        )
    if args.chrome:
        chrome = spans.to_chrome(traces)
        with open(args.chrome, "w") as f:
            json.dump(chrome, f)
        print(
            f"# chrome trace: {len(chrome['traceEvents'])} events -> "
            f"{args.chrome} (open in chrome://tracing or "
            "https://ui.perfetto.dev)"
        )
    print(f"# timeline OK ({len(rows)} serve_trace record(s), "
          f"{len(traces)} trace(s))")
    return 0


def _diff(args) -> int:
    from capital_tpu_torch.obs import ledger

    a = ledger.read(args.a)
    b = ledger.read(args.b)
    try:
        regs = ledger.diff(
            a, b, tol_metric=args.tol_metric, tol_hbm=args.tol_hbm,
            tol_collective=args.tol_collective,
        )
    except ledger.LedgerIncompatible as e:
        print(f"incomparable ledgers: {e}", file=sys.stderr)
        return 2
    for r in regs:
        print(r.line())
    if regs:
        return 1
    print(f"# no regressions ({len(a)} vs {len(b)} records)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="capital_tpu_torch.obs")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("diff", help="compare two ledger JSONL files")
    d.add_argument("a")
    d.add_argument("b")
    d.add_argument("--tol-metric", type=float, default=0.10)
    d.add_argument("--tol-hbm", type=float, default=0.05)
    d.add_argument("--tol-collective", type=int, default=0)
    d.set_defaults(fn=_diff)

    s = sub.add_parser(
        "serve-report",
        help="summarize serve request_stats records (optional gates)",
    )
    s.add_argument("ledger")
    s.add_argument("--min-hit-rate", type=float, default=None,
                   help="fail unless every record's cache hit_rate >= this")
    s.add_argument("--max-p99-ms", type=float, default=None,
                   help="fail when any record's p99 latency exceeds this")
    s.add_argument("--min-occupancy", type=float, default=None,
                   help="gate: fail when any record's batch_occupancy_mean "
                        "falls below this (batches flushing too empty)")
    s.add_argument("--max-queue-wait-ms", type=float, default=None,
                   help="gate: fail when any record's queue_wait_ms.p99 "
                        "exceeds this; fails loudly when no record carries "
                        "the queue-wait/device latency split")
    s.add_argument("--min-residency-hit-rate", type=float, default=None,
                   help="fail when any record's factor_cache.hit_rate "
                   "(serve/factorcache.py residency counters) is below "
                   "this; fails loudly when NO record carries the block")
    s.add_argument("--max-refine-iters", type=int, default=None,
                   help="gate: fail when any record's refine.iters_max "
                        "(guaranteed-tier correction sweeps, "
                        "Collector.note_refine) exceeds this; fails loudly "
                        "when NO record carries the refine block")
    s.add_argument("--min-converged-frac", type=float, default=None,
                   help="gate: fail when any record's refine.converged_frac "
                        "is below this; fails loudly when NO record "
                        "carries the refine block")
    s.add_argument("--max-p99-ms-small", type=float, default=None,
                   help="gate the small-N bucket latency split separately: "
                        "fail when any record's latency_ms_small.p99 "
                        "exceeds this, or when no record carries the split")
    s.add_argument("--aggregate", action="store_true",
                   help="fold replica-tagged records through "
                        "stats.merge_snapshots and report the fleet view "
                        "(summed counts + router-block QPS, worst tail, "
                        "per-replica occupancy); fails loudly when no "
                        "record carries a replica_id tag")
    s.add_argument("--min-replicas", type=int, default=None,
                   help="fail unless the ledger carries at least this many "
                        "distinct replica_id tags (the it-really-was-"
                        "multi-replica gate)")
    s.add_argument("--min-trace-complete", type=float, default=None,
                   metavar="FRAC",
                   help="fail unless every serve_trace record's "
                        "complete/requests fraction >= this (1.0 = every "
                        "span chain complete under the record's pinned "
                        "bubble tolerance); fails loudly when no record "
                        "carries a serve_trace block or it is empty")
    s.add_argument("--min-windows", type=int, default=None,
                   help="fail unless the ledger carries at least this many "
                        "serve_window records (one per closed non-empty "
                        "telemetry window); fails loudly when telemetry "
                        "was never enabled")
    s.add_argument("--min-session-hit-rate", type=float, default=None,
                   help="fail when any session_stats record's hit_rate "
                        "(serve/sessions.py resident-chain residency) is "
                        "below this; fails loudly when NO record carries "
                        "a session_stats block")
    s.add_argument("--max-reseeds", type=int, default=None,
                   help="fail when any session_stats record counts more "
                        "than this many reseeds (re-opens of evicted "
                        "sessions); fails loudly when NO record carries "
                        "a session_stats block")
    s.set_defaults(fn=_serve_report)

    lr = sub.add_parser(
        "lint-report",
        help="summarize lint:report records (gate on per-pass outcomes)",
    )
    lr.add_argument("ledger")
    lr.add_argument("--require-pass", action="append", default=None,
                    metavar="PASS",
                    help="fail unless a record for this pass exists "
                         "(repeatable: program, source, concurrency)")
    lr.set_defaults(fn=_lint_report)

    tr = sub.add_parser(
        "trace-report",
        help="summarize phase-attribution records (per-phase wall split "
             "+ bubble_frac, optional gate)",
    )
    tr.add_argument("ledger")
    tr.add_argument("--max-bubble-frac", type=float, default=None,
                    help="fail when any record's bubble_frac exceeds this, "
                         "or when no record carries phase_seconds at all")
    tr.set_defaults(fn=_trace_report)

    tl = sub.add_parser(
        "timeline",
        help="render serve:trace span records (per-span split, slowest "
             "requests, SLO attribution, optional Chrome-trace export)",
    )
    tl.add_argument("ledger")
    tl.add_argument("--chrome", default=None, metavar="OUT.json",
                    help="write the traces as Chrome-trace-event JSON "
                         "(chrome://tracing / Perfetto)")
    tl.add_argument("--top", type=int, default=3,
                    help="print the N slowest requests' full span chains")
    tl.set_defaults(fn=_timeline)

    g = sub.add_parser(
        "robust-gate",
        help="verify recovery/failure events round-trip through diff "
             "without reading as metric regressions",
    )
    g.set_defaults(fn=_robust_gate)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
