"""CLI: ``python -m capital_tpu_torch.serve smoke ...`` — the serving
self-check (counterpart of capital_tpu/serve/__main__.py).

Runs a small mixed-bucket workload on the card (``--device cpu``: on the
host, the plain versions), writes one serve:request_stats ledger record,
and gates on the reference's acceptance properties:

* **zero rebuilds**: after warm-up over the workload's >= 3 shape buckets,
  every request-driven program lookup must hit (cache misses == 0,
  hit_rate == 1.0);
* **numerics**: the max per-request residual stays under the pinned dtype
  gate (`_tolerance`: 5e-2 bf16, 5e-5 f32, 1e-13 f64; the lstsq
  normal-equation residual gets the reference's 10x allowance).

With ``--persist-dir`` the smoke exercises the persistent tier
(serve/cache.py: a warm-up manifest, since a captured CUDA graph cannot
leave its process), and ``--max-compiles N`` gates the builds the
manifest did not foresee: the SECOND smoke pointed at the same (now warm)
directory must report 0 — it still captures every program at warm-up,
but every one of them was foreseen (``disk.hits``).

``python -m capital_tpu_torch.serve loadgen`` is the closed-loop A/B
harness (serve/loadgen.py): the same fixed-seed workload through the sync
(stop-and-go) and continuous schedulers, one serve:request_stats record
per mode with the queue-wait/device split and the QPS comparison.

``python -m capital_tpu_torch.serve replicas`` is the multi-replica smoke
(serve/router.py): N replicas behind one Router sharing --persist-dir,
with an induced kill (in-flight re-dispatch, a replacement warmed from
the manifest) and an induced drain + resume, gated on zero dropped
requests and zero steady-state rebuilds.  The ``loadgen --replicas N``
variant is the replica-count scaling A/B.  Process replicas share the one
card, each with its own CUDA context.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

#: the residual gate by dtype (the reference's bench/drivers._tolerance)
TOLERANCE = {"bfloat16": 5e-2, "float32": 5e-5, "float64": 1e-13}


def _tolerance(dtype) -> float:
    """The dtype's residual gate (a torch, numpy or named dtype)."""
    name = str(dtype).replace("torch.", "")
    if name not in TOLERANCE:
        raise ValueError(f"no residual gate for dtype {name!r}")
    return TOLERANCE[name]


def _np64(x):
    """A tensor (any device) or array as a host float64 numpy array."""
    import numpy as np

    if hasattr(x, "detach"):
        import torch

        x = x.detach().to("cpu", dtype=torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def _workload(requests: int, seed: int):
    """Deterministic mixed workload touching >= 3 dense n-buckets, all
    five ops (dense posv/inv/lstsq + the structured posv_blocktri and
    posv_arrowhead), two nrhs buckets, two blocktri (nblocks, b) buckets,
    and two arrowhead border buckets — the mixed dense + structured
    traffic the zero-rebuild gate must cover."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ns = (12, 24, 48, 16, 30, 64)  # -> buckets 16 / 32 / 64
    ks = (1, 3)  # -> nrhs buckets 1 / 4
    bts = ((3, 6), (6, 12), (4, 24))  # -> (nblocks, b) buckets
    borders = (3, 6)  # -> arrowhead border buckets 4 / 8
    # 7-long op cycle against the 6-long n cycle (coprime) so blocks sweep
    # the bucket grid; requests arrive in blocks of 4 IDENTICAL shapes
    # (j = i // 4) so the capacity flush path sees full batches, while the
    # pump() cadence below (every 7 submissions, coprime with 4) still
    # catches partial blocks on the deadline path
    ops = ("posv", "inv", "lstsq", "posv_blocktri", "lstsq",
           "posv_arrowhead", "posv")
    out = []
    for i in range(requests):
        j = i // 4
        op = ops[j % len(ops)]
        n = ns[j % len(ns)]
        k = ks[j % len(ks)]
        if op == "lstsq":
            m = 4 * n
            A = rng.standard_normal((m, n))
            B = rng.standard_normal((m, k))
        elif op in ("posv_blocktri", "posv_arrowhead"):
            nb, bb = bts[j % len(bts)]
            G = rng.standard_normal((nb, bb, bb))
            D = G @ G.transpose(0, 2, 1) / bb + 3.0 * np.eye(bb)
            C = 0.3 / np.sqrt(bb) * rng.standard_normal((nb, bb, bb))
            C[0] = 0.0
            A = np.stack([D, C])
            B = rng.standard_normal((nb, bb, k))
            if op == "posv_arrowhead":
                # pack the border/corner/RHS tail (models/arrowhead.pack
                # layout, built host-side in numpy)
                s = borders[j % len(borders)]
                n_t = nb * bb
                F = 0.1 * rng.standard_normal((nb, s, bb))
                S0 = rng.standard_normal((s, s))
                S = S0 @ S0.T / s + 5.0 * np.eye(s)
                Bs = rng.standard_normal((s, k))
                top = np.concatenate(
                    [F.transpose(0, 2, 1).reshape(n_t, s),
                     B.reshape(n_t, k)], axis=1)
                B = np.concatenate(
                    [top, np.concatenate([S, Bs], axis=1)], axis=0)
        else:
            M = rng.standard_normal((n, n))
            A = M @ M.T / n + 3.0 * np.eye(n)
            B = rng.standard_normal((n, k)) if op == "posv" else None
        out.append((op, A, B))
    return out


def _residual(op: str, A, B, x) -> float:
    import numpy as np

    A = _np64(A)
    x = _np64(x)
    if op == "inv":
        n = A.shape[0]
        return float(np.linalg.norm(A @ x - np.eye(n)) / np.sqrt(n))
    B = _np64(B)
    if op in ("posv_blocktri", "posv_arrowhead"):
        # assemble the dense matrix the chain represents and gate the
        # flattened solve residual like dense posv
        _, nb, bb, _ = A.shape
        n = nb * bb
        Ad = np.zeros((n, n))
        for i in range(nb):
            sl = slice(i * bb, (i + 1) * bb)
            Ad[sl, sl] = A[0, i]
            if i:
                up = slice((i - 1) * bb, i * bb)
                Ad[sl, up] = A[1, i]
                Ad[up, sl] = A[1, i].T
        if op == "posv_arrowhead":
            # complete the dense arrowhead from the packed tail: its
            # first s columns are [Bᵀ; S], the rest the flat RHS
            s = B.shape[0] - n
            Af = np.block([[Ad, B[:n, :s]],
                           [B[:n, :s].T, B[n:, :s]]])
            rhs = B[:, s:]
            return float(np.linalg.norm(Af @ x - rhs) / np.linalg.norm(rhs))
        k = B.shape[-1]
        Bf, xf = B.reshape(n, k), x.reshape(n, k)
        return float(np.linalg.norm(Ad @ xf - Bf) / np.linalg.norm(Bf))
    if op == "posv":
        return float(np.linalg.norm(A @ x - B) / np.linalg.norm(B))
    r = A.T @ (A @ x - B)
    return float(np.linalg.norm(r) / np.linalg.norm(A.T @ B))


def _smoke(args) -> int:
    import torch

    from capital_tpu_torch.parallel.topology import Grid
    from capital_tpu_torch.serve.engine import ServeConfig, SolveEngine

    dtype = getattr(torch, args.dtype)
    cfg = ServeConfig(
        buckets=(16, 32, 64),
        rows_buckets=(64, 128, 256),
        nrhs_buckets=(1, 4),
        # the structured ladder: the workload's (nblocks, b) chains stay
        # tiny so the chain scan is cheap, while still touching
        # two rungs of each blocktri axis
        nblocks_buckets=(4, 8),
        block_buckets=(8, 16, 32),
        border_buckets=(4, 8),
        max_batch=4,
        max_delay_s=0.01,
        # every smoke bucket is <= batched_small.SMALL_N_MAX, so 'auto'
        # routes the posv/lstsq buckets through the batched kernels (their
        # plain versions on the CPU), and latency_ms_small lands in the
        # record.
        small_n_impl=args.small_n_impl,
        scheduler=args.scheduler,
        persist_dir=args.persist_dir,
    )
    eng = SolveEngine(Grid.square(device=args.device), cfg)
    work = _workload(args.requests, args.seed)
    compiles = eng.warmup(
        (op, A.shape, B.shape if B is not None else None, dtype)
        for op, A, B in work
    )
    print(f"# serve-smoke: warmup built {compiles} programs the manifest did not foresee "
          f"({eng.cache_stats()})")

    tickets = []
    for i, (op, A, B) in enumerate(work):
        A = torch.as_tensor(A, dtype=dtype)
        B = torch.as_tensor(B, dtype=dtype) if B is not None else None
        tickets.append(eng.submit(op, A, B))
        if i % 7 == 6:
            # let the oldest queue age past the deadline so the max-delay
            # flush path runs in the smoke, not only the capacity path
            time.sleep(cfg.max_delay_s)
            eng.pump()
    eng.drain()

    failures = []
    tol = _tolerance(dtype)
    worst: dict[str, float] = {}
    buckets_seen = set()
    for (op, A, B), t in zip(work, tickets):
        r = t.result()
        if not r.ok or r.x is None:
            failures.append(f"request {r.request_id} ({op}) failed: {r.error}")
            continue
        if r.bucket is not None:
            buckets_seen.add(r.bucket[:3])  # (op, dtype, a_shape)
        res = _residual(op, A, B, r.x)
        worst[op] = max(worst.get(op, 0.0), res)
        gate = 10 * tol if op == "lstsq" else tol
        if res >= gate:
            failures.append(
                f"request {r.request_id} ({op} {A.shape}) residual "
                f"{res:.3e} >= {gate:.0e}"
            )
    cache = eng.cache_stats()
    n_buckets = len({b[2] for b in buckets_seen})
    rec = eng.emit_stats(
        args.ledger,
        smoke={
            "max_residual": {k: round(v, 12) for k, v in worst.items()},
            "distinct_bucket_shapes": n_buckets,
            "residual_tol": tol,
        },
    )
    print(json.dumps(rec["request_stats"]))
    for op, v in sorted(worst.items()):
        print(f"# serve-smoke: max {op} residual {v:.3e}")
    if n_buckets < 3:
        failures.append(
            f"workload touched only {n_buckets} bucket shapes (< 3)"
        )
    if cache["misses"] or not cache["hits"]:
        failures.append(
            f"steady-state rebuild: cache {cache} (expected misses == 0 "
            "after warmup)"
        )
    if args.max_compiles is not None and cache["compiles"] > args.max_compiles:
        disk = cache.get("disk", {})
        failures.append(
            f"cold-start gate: {cache['compiles']} builds the manifest did not "
            f"foresee > --max-compiles {args.max_compiles} (disk tier: {disk}) — "
            "the persistent tier did not cover the workload"
        )
    if args.trace:
        # per-request span chains (obs/spans.py): ONE serve:trace record,
        # gated in-run at 100% completeness under the pinned bubble
        # tolerance — a request that dropped a stamping site, stamped out
        # of order, or opened an un-spanned gap fails the smoke here, not
        # three tools later
        from capital_tpu_torch.obs import spans

        trec = eng.emit_trace(args.ledger, bubble_tol_ms=args.bubble_tol_ms)
        st = trec["serve_trace"]
        print(
            f"# serve-smoke: traced {st['requests']} requests, "
            f"{st['complete']} complete chains "
            f"(bubble_tol_ms={st['bubble_tol_ms']}, "
            f"dropped={st['dropped']})"
        )
        if st["requests"] != len(tickets):
            failures.append(
                f"trace gate: {st['requests']} traced requests != "
                f"{len(tickets)} submitted — a request slipped through "
                "untraced"
            )
        if st["complete"] != st["requests"] or st["dropped"]:
            for t in st["traces"]:
                for pb in spans.trace_dict_problems(
                        t, st["bubble_tol_ms"]):
                    print(f"#   trace {t['request_id']}: {pb}",
                          file=sys.stderr)
            failures.append(
                f"trace gate: {st['complete']}/{st['requests']} complete "
                f"span chains (dropped={st['dropped']}) — need 100%"
            )
    for f in failures:
        print(f"# serve-smoke FAIL: {f}", file=sys.stderr)
    if failures:
        return 1
    print(
        f"# serve-smoke OK: {len(tickets)} requests, hit_rate "
        f"{cache['hit_rate']:.2f} over {cache['hits']} lookups, "
        f"{n_buckets} bucket shapes, {cache['compiles']} unforeseen builds"
    )
    return 0


def _replicas(args) -> int:
    """Multi-replica router smoke (the reference's docs/SERVING.md
    "Multi-replica serving"): N replicas behind one Router sharing --persist-dir, the
    loadgen workload submitted through the router with an optional induced
    replica KILL (re-dispatch proof) and an induced DRAIN + resume
    (rolling-restart proof) mid-stream.  Gates: every submitted request
    lands ok under the residual tolerance (zero drops), aggregate
    steady-state cache misses == 0, and with --max-compiles the summed
    unforeseen-build count across live replicas (the warm shared-dir run
    pins it at 0 — replicas and the mid-stream replacement all build from
    the manifest).  A replica that never acknowledges its warm-up (a
    process that could not reach the card: its ("fatal", ...)) fails the
    run.  ``--guaranteed-share`` sends that share of the posv requests at
    accuracy_tier='guaranteed'."""
    from capital_tpu_torch.serve import loadgen
    from capital_tpu_torch.serve.engine import ServeConfig
    from capital_tpu_torch.serve.replica import make_replica
    from capital_tpu_torch.serve.router import Router, RouterConfig

    cfg = ServeConfig(
        buckets=(16, 32, 64),
        nrhs_buckets=(1, 4),
        max_batch=4,
        max_delay_s=0.002,
        small_n_impl=args.small_n_impl,
        persist_dir=args.persist_dir,
    )
    wl = loadgen.Workload(
        requests=args.requests, concurrency=args.concurrency,
        seed=args.seed, dtype=args.dtype,
    )
    work = loadgen.build_requests(wl)
    specs = loadgen.warmup_specs(wl)
    tiers = _tiers(work, args.guaranteed_share)
    if args.guaranteed_share:
        specs += [s + ("guaranteed",) for s in specs if s[0] == "posv"]
    router = Router(RouterConfig(policy=args.policy))
    for i in range(args.replicas):
        router.add_replica(make_replica(args.replica_mode, f"r{i}", cfg,
                                        device=args.device))
    fresh = router.warmup(specs)
    print(f"# serve-replicas: warmup unforeseen builds {fresh}")
    failures = [f"replica {rid} did not warm up (fatal: "
                f"{router._states[rid].replica.fatal})"
                for rid, v in fresh.items() if v is None]
    router.start()

    tickets = []
    kill_at = len(work) // 2 if args.kill_one else None
    drain_at = (3 * len(work)) // 4 if args.drain_one else None
    drained_id = None
    t_start = time.monotonic()
    for i, (op, A, B) in enumerate(work):
        tickets.append((op, A, B, router.submit(op, A, B,
                                                accuracy_tier=tiers[i])))
        if i == kill_at:
            # abrupt death with a window full of in-flight requests: the
            # pump must observe it and re-dispatch, and the replacement
            # must warm from the SHARED manifest, never build on a request
            router.kill_replica("r0")
            rep = make_replica(args.replica_mode, f"r{args.replicas}", cfg,
                               device=args.device)
            # the replacement warms before it joins: registered cold, the
            # pump's re-dispatch of r0's window could reach it first and
            # build on the request path
            rep.start()
            info = rep.warmup(specs)
            router.add_replica(rep)
            rep_fresh = {rep.replica_id: info["fresh"] if info else None}
            print(f"# serve-replicas: killed r0, replacement "
                  f"r{args.replicas} warmup unforeseen builds {rep_fresh}")
            if info is None:
                failures.append(f"replacement {rep.replica_id} did not warm up "
                                f"(fatal: {rep.fatal})")
            elif info["fresh"]:
                failures.append(
                    f"replacement replica built {rep_fresh} programs the "
                    "manifest did not foresee — a shared persist_dir should "
                    "have covered them"
                )
        if i == drain_at:
            live = router.replica_ids(healthy_only=True)
            drained_id = live[-1]
            ok = router.drain_replica(drained_id)
            if not ok:
                failures.append(f"drain_replica({drained_id!r}) timed out")
            per = router.counters()["per_replica"][drained_id]
            if per["outstanding"]:
                failures.append(
                    f"drained replica {drained_id} still has "
                    f"{per['outstanding']} outstanding"
                )
            print(f"# serve-replicas: drained {drained_id} under load "
                  f"(outstanding now {per['outstanding']})")

    tol = _tolerance(args.dtype)
    worst: dict[str, float] = {}
    landed = 0
    for op, A, B, t in tickets:
        r = t.result(timeout=300.0)
        landed += 1
        if not r.ok or r.x is None:
            failures.append(
                f"request {r.request_id} ({op}) failed: {r.error}")
            continue
        res = _residual(op, A, B, r.x)
        worst[op] = max(worst.get(op, 0.0), res)
        gate = 10 * tol if op == "lstsq" else tol
        if res >= gate:
            failures.append(
                f"request {r.request_id} ({op} {A.shape}) residual "
                f"{res:.3e} >= {gate:.0e}"
            )
    wall = time.monotonic() - t_start
    if drained_id is not None:
        router.resume_replica(drained_id)
    counters = router.counters()
    qps = round(landed / wall, 3) if wall > 0 else 0.0
    recs = router.emit_stats(args.ledger, router={
        "qps": qps, "wall_s": round(wall, 6),
        "kill_one": bool(args.kill_one), "drain_one": bool(args.drain_one),
    })
    agg = recs[-1]["request_stats"] if recs else {}
    cache = agg.get("cache", {})
    print(json.dumps(agg))
    for op, v in sorted(worst.items()):
        print(f"# serve-replicas: max {op} residual {v:.3e}")

    if landed != len(work) or counters["completed"] != len(work):
        failures.append(
            f"dropped requests: {landed}/{len(work)} landed, counters "
            f"{counters}"
        )
    if counters["parked"]:
        failures.append(f"{counters['parked']} requests left parked")
    if args.kill_one and not counters["failed_replicas"]:
        failures.append("induced kill not observed (failed_replicas == 0)")
    if cache.get("misses"):
        failures.append(
            f"steady-state rebuild: aggregate cache {cache} (expected "
            "misses == 0 after warmup)"
        )
    if (args.max_compiles is not None
            and cache.get("compiles", 0) > args.max_compiles):
        failures.append(
            f"cold-start gate: {cache.get('compiles')} unforeseen builds "
            f"across live replicas > --max-compiles {args.max_compiles} "
            f"(disk tier: {cache.get('disk')})"
        )
    router.stop()
    for f in failures:
        print(f"# serve-replicas FAIL: {f}", file=sys.stderr)
    if failures:
        return 1
    print(
        f"# serve-replicas OK: {landed} requests over "
        f"{counters['replicas']} replicas ({args.policy}) in {wall:.3f}s = "
        f"{qps:.1f} qps; redispatched {counters['redispatched']}, "
        f"duplicates {counters['duplicates']}, hit_rate "
        f"{cache.get('hit_rate', 0):.2f}, {cache.get('compiles', 0)} "
        "unforeseen builds"
    )
    return 0


def _loadgen_replicas(args) -> int:
    """The replica-count A/B (loadgen.compare_replicas): equal per-client
    offered load against 1 and --replicas replicas sharing --persist-dir;
    the ledger's aggregate record per count carries the `router` block
    with baseline_qps and scaling_efficiency."""
    from capital_tpu_torch.serve import loadgen
    from capital_tpu_torch.serve.engine import ServeConfig

    cfg = ServeConfig(
        buckets=(16, 32, 64),
        nrhs_buckets=(1, 4),
        max_batch=4,
        max_delay_s=0.002,
        small_n_impl=args.small_n_impl,
        max_inflight=args.max_inflight,
        persist_dir=args.persist_dir,
    )
    wl = loadgen.Workload(
        requests=args.requests, concurrency=args.concurrency,
        seed=args.seed, dtype=args.dtype,
    )
    counts = (1, args.replicas) if args.replicas > 1 else (1,)
    results = loadgen.compare_replicas(
        cfg, wl, replica_counts=counts, replica_mode=args.replica_mode,
        client_mode=args.client_mode, policy=args.policy,
        ledger_path=args.ledger, device=args.device,
    )
    failures = []
    for n in counts:
        res = results[n]
        agg = res["records"][-1]["request_stats"]
        cache = agg.get("cache", {})
        print(
            f"# serve-loadgen replicas={n}: {res['requests']} requests, "
            f"{res['clients']} {res['client_mode']} clients in "
            f"{res['wall_s']:.3f}s = {res['qps']:.1f} qps (aggregate "
            f"misses {cache.get('misses')}, unforeseen builds {cache.get('compiles')})"
        )
        if res["failed"]:
            failures.append(f"replicas={n}: {res['failed']} requests failed")
        if cache.get("misses"):
            failures.append(
                f"replicas={n}: {cache['misses']} steady-state rebuilds"
            )
    eff = results.get("scaling_efficiency")
    if eff is not None:
        print(
            f"# serve-loadgen: {counts[-1]}-replica speedup "
            f"{results['speedup']:.2f}x, scaling efficiency {eff:.2f} "
            f"(1.0 = each replica pulls full single-replica weight)"
        )
        if args.min_scaling is not None and eff < args.min_scaling:
            failures.append(
                f"scaling efficiency {eff:.2f} < --min-scaling "
                f"{args.min_scaling}"
            )
    for f in failures:
        print(f"# serve-loadgen FAIL: {f}", file=sys.stderr)
    if failures:
        return 1
    print("# serve-loadgen OK")
    return 0


def _loadgen(args) -> int:
    if args.replicas:
        if (args.window_s or args.trace or args.min_windows is not None
                or args.deadline_ms is not None):
            print("loadgen: --window-s/--min-windows/--deadline-ms/--trace "
                  "are not supported with --replicas (use the single-"
                  "engine A/B, or `smoke --trace`)", file=sys.stderr)
            return 2
        return _loadgen_replicas(args)

    from capital_tpu_torch.serve import loadgen
    from capital_tpu_torch.serve.engine import ServeConfig

    cfg = ServeConfig(
        buckets=(16, 32, 64),
        rows_buckets=(64, 128, 256),
        nrhs_buckets=(1, 4),
        max_batch=4,
        max_delay_s=0.002,
        small_n_impl=args.small_n_impl,
        max_inflight=args.max_inflight,
        persist_dir=args.persist_dir,
    )
    wl = loadgen.Workload(
        requests=args.requests, concurrency=args.concurrency,
        seed=args.seed, dtype=args.dtype, deadline_ms=args.deadline_ms,
    )
    results = loadgen.compare(cfg, wl, device=args.device, ledger_path=args.ledger,
                              window_s=args.window_s, trace=args.trace)
    failures = []
    nwin = 0
    for mode in ("sync", "continuous"):
        res = results.get(mode)
        if res is None:
            continue
        cache = res["cache"]
        win_note = ""
        if args.window_s:
            nwin += res.get("window_records", 0)
            win_note = f", windows {res.get('window_records', 0)}"
        trace_note = ""
        if args.trace:
            st = res["trace_record"]["serve_trace"]
            trace_note = (f", traces {st['complete']}/{st['requests']} "
                          f"complete")
            if args.deadline_ms is not None:
                trace_note += f", SLO violations {st['violations']}"
        print(
            f"# serve-loadgen {mode}: {res['requests']} requests in "
            f"{res['wall_s']:.3f}s = {res['qps']:.1f} qps "
            f"(concurrency {wl.concurrency}, cache misses "
            f"{cache['misses']}, unforeseen builds {cache['compiles']}"
            + win_note + trace_note + ")"
        )
        if res["failed"]:
            failures.append(f"{mode}: {res['failed']} requests failed")
        if cache["misses"]:
            failures.append(
                f"{mode}: {cache['misses']} steady-state rebuilds "
                "(warmup must cover the workload grid)"
            )
    if args.min_windows is not None:
        # loud-when-dead: asking for a window floor without enabling the
        # telemetry that produces windows is a wiring bug, not a pass
        if not args.window_s:
            failures.append(
                "--min-windows requires --window-s (telemetry disabled, "
                "no windows can ever close)"
            )
        elif nwin < args.min_windows:
            failures.append(
                f"{nwin} serve:window record(s) across modes < "
                f"--min-windows {args.min_windows} (run longer, or "
                "shrink --window-s)"
            )
    if results.get("speedup") is not None:
        print(f"# serve-loadgen: continuous/sync speedup "
              f"{results['speedup']:.2f}x")
        if args.min_speedup is not None and results["speedup"] < args.min_speedup:
            failures.append(
                f"speedup {results['speedup']:.2f}x < --min-speedup "
                f"{args.min_speedup}"
            )
    for f in failures:
        print(f"# serve-loadgen FAIL: {f}", file=sys.stderr)
    if failures:
        return 1
    print("# serve-loadgen OK")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="capital_tpu_torch.serve")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("smoke", help="mixed-bucket serving self-check")
    s.add_argument("--requests", type=int, default=50)
    s.add_argument("--dtype", default="float32")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--ledger", default=None,
                   help="append the request_stats record to this JSONL file")
    s.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the engine's device (cpu: the plain versions on the host)")
    s.add_argument("--small-n-impl", default="auto",
                   choices=("auto", "vmap", "pallas", "pallas_split"),
                   help="batched implementation for the bucket programs "
                        "(ServeConfig.small_n_impl)")
    s.add_argument("--scheduler", default="continuous",
                   choices=("continuous", "sync"),
                   help="admission scheduler (ServeConfig.scheduler)")
    s.add_argument("--persist-dir", default=None,
                   help="the warm-up manifest's directory (serve/cache.py)")
    s.add_argument("--max-compiles", type=int, default=None,
                   help="fail if more than this many builds were not foreseen "
                        "by the manifest (0 on a warm --persist-dir = the "
                        "cold-start proof)")
    s.add_argument("--trace", action="store_true",
                   help="emit the per-request span-chain record "
                        "(serve:trace, obs/spans.py) and gate the run on "
                        "100%% complete monotonic chains")
    s.add_argument("--bubble-tol-ms", type=float, default=25.0,
                   help="largest un-spanned host-side gap a chain may "
                        "carry and still count complete "
                        "(spans.DEFAULT_BUBBLE_TOL_MS)")
    s.set_defaults(fn=_smoke)
    g = sub.add_parser(
        "loadgen",
        help="closed-loop sync-vs-continuous A/B harness (serve/loadgen.py)",
    )
    g.add_argument("--requests", type=int, default=200)
    g.add_argument("--concurrency", type=int, default=16)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--dtype", default="float32")
    g.add_argument("--ledger", default=None,
                   help="append one request_stats record per mode here")
    g.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    g.add_argument("--small-n-impl", default="auto",
                   choices=("auto", "vmap", "pallas", "pallas_split"))
    g.add_argument("--max-inflight", type=int, default=2,
                   help="continuous mode's unlanded-batch window")
    g.add_argument("--persist-dir", default=None,
                   help="warm-up manifest directory shared by both modes")
    g.add_argument("--min-speedup", type=float, default=None,
                   help="fail if continuous/sync QPS falls below this "
                        "(leave unset on shared CI hardware)")
    g.add_argument("--window-s", type=float, default=None,
                   help="enable rolling-window telemetry "
                        "(serve/telemetry.py) with this window length; "
                        "appends one serve:window record per closed "
                        "non-empty window")
    g.add_argument("--min-windows", type=int, default=None,
                   help="fail unless at least this many serve:window "
                        "records were emitted across both modes "
                        "(requires --window-s)")
    g.add_argument("--deadline-ms", type=float, default=None,
                   help="per-request SLO deadline: traces carry "
                        "slack-at-dispatch and violation attribution "
                        "(most useful with --trace)")
    g.add_argument("--trace", action="store_true",
                   help="emit one serve:trace span-chain record per mode "
                        "(not supported with --replicas)")
    g.add_argument("--replicas", type=int, default=0,
                   help="run the replica-count A/B instead: 1 vs N "
                        "replicas behind a router at equal per-client "
                        "offered load (loadgen.compare_replicas)")
    g.add_argument("--replica-mode", default="thread",
                   choices=("thread", "process"),
                   help="replica transport: in-process threads (CI) or "
                        "spawned engine processes")
    g.add_argument("--client-mode", default="thread",
                   choices=("thread", "process"),
                   help="closed-loop client transport for the router A/B")
    g.add_argument("--policy", default="least_loaded",
                   help="router dispatch policy (least_loaded or "
                        "bucket_affinity)")
    g.add_argument("--min-scaling", type=float, default=None,
                   help="fail if N-replica scaling efficiency falls below "
                        "this (leave unset on shared CI hardware — this "
                        "rig may have fewer cores than replicas)")
    g.set_defaults(fn=_loadgen)
    r = sub.add_parser(
        "replicas",
        help="multi-replica router smoke: shared persistent cache, "
             "induced kill + drain, zero-drop and rebuild gates",
    )
    r.add_argument("--replicas", type=int, default=2)
    r.add_argument("--requests", type=int, default=48)
    r.add_argument("--concurrency", type=int, default=8,
                   help="recorded in the workload (submission here is "
                        "paced by the router, not a client pool)")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--dtype", default="float32")
    r.add_argument("--ledger", default=None,
                   help="append per-replica + aggregate request_stats "
                        "records here")
    r.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="every replica's device (process replicas share the one card)")
    r.add_argument("--small-n-impl", default="pallas",
                   choices=("auto", "vmap", "pallas", "pallas_split"),
                   help="the bucket programs' batched implementation (pallas: "
                        "the hand-written kernels on the card)")
    r.add_argument("--replica-mode", default="thread",
                   choices=("thread", "process"))
    r.add_argument("--policy", default="bucket_affinity",
                   help="router dispatch policy; bucket_affinity is the "
                        "cache-locality default here so the kill also "
                        "proves the rebalance-is-a-disk-hit property")
    r.add_argument("--persist-dir", default=None,
                   help="shared warm-up manifest directory")
    r.add_argument("--kill-one", action="store_true",
                   help="kill replica r0 mid-stream and register a "
                        "replacement (re-dispatch + manifest-warm proof)")
    r.add_argument("--drain-one", action="store_true",
                   help="drain one replica under load, then resume it "
                        "(rolling-restart proof)")
    r.add_argument("--max-compiles", type=int, default=None,
                   help="fail if live replicas' summed unforeseen builds "
                        "exceed this (0 on a warm shared --persist-dir)")
    r.add_argument("--guaranteed-share", type=float, default=0.0,
                   help="send this share of the posv requests at "
                        "accuracy_tier='guaranteed' (evenly spaced)")
    r.set_defaults(fn=_replicas)
    return p


def _tiers(work, share: float) -> list[str]:
    """Each request's accuracy tier: `share` of the posv requests, evenly
    spaced, at 'guaranteed', the rest 'balanced'."""
    if not 0.0 <= share <= 1.0:
        raise ValueError(f"--guaranteed-share must lie in [0, 1], got {share}")
    out, j = [], 0
    for op, _, _ in work:
        tier = "balanced"
        if op == "posv":
            if int((j + 1) * share) > int(j * share):
                tier = "guaranteed"
            j += 1
        out.append(tier)
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
