"""Closed-loop load generator + SLO harness for the solve engine
(counterpart of capital_tpu/serve/loadgen.py, the whole module).

Closed-loop means each simulated client holds exactly one request in
flight: it submits, waits for the *landed* result, then submits the next.
Offered load is therefore `concurrency` outstanding requests, not a fixed
arrival rate — the honest way to measure a scheduler, because an open-loop
generator keeps offering work while the system backs up and turns a
throughput problem into an unbounded-queue artifact.

The harness drives one engine per scheduler mode over the SAME fixed-seed
workload and emits one `serve:request_stats` ledger record per mode, each
carrying a `loadgen` block (mode, concurrency, sustained QPS, wall time).
The continuous record also carries the sync baseline's QPS and the
speedup, so the A/B result reads from the ledger alone:

* **throughput** — continuous vs sync QPS at equal occupancy (same
  workload, same ladder, same capacity ⇒ same batch shapes);
* **SLO split** — queue-wait vs on-device percentiles per mode: the
  overlap win shows up as queue-wait shrinking while device stays put;
* **zero steady-state rebuilds** — each record's cache block
  (`misses == 0`, `hit_rate == 1.0` after warmup).

Multi-replica: `run_router_closed_loop` drives a serve.router
Router with M concurrent closed-loop clients — threads, or separate
client PROCESSES relaying submits over pipes (offered load that does not
share the router's GIL) — and `compare_replicas` is the replica-count A/B:
the same per-client offered load against 1 and N replicas sharing one
persist_dir, one aggregate record per count carrying a `router` block with
``baseline_qps`` and ``scaling_efficiency = (qps_N / N) / (qps_1 / 1)`` —
the honest scaling number (raw speedup flatters N replicas on any rig;
efficiency reads 1.0 only when each replica pulls its weight).

Everything here is host-side policy around the engine/router public
surfaces (submit/pump/drain) — the engine import is lazy, so a spawned
client process never imports torch at all.  `build_requests` makes the
reference's operands byte for byte (numpy, seeded); the engine moves them
to its device at submit.  Engines run on the CUDA card unless the caller
passes a `grid` or ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Workload:
    """A reproducible request mix.  Shapes are drawn per-request from the
    ladders below with numpy's seeded Generator, so two runs (or two
    scheduler modes) see byte-identical operands in identical order.
    lstsq rows are 4*n — pick `ns` so that lands on the engine's
    rows_buckets ladder or the oversize path will dominate the measure."""

    requests: int = 200
    concurrency: int = 16
    seed: int = 0
    ops: tuple[str, ...] = ("posv", "lstsq")
    ns: tuple[int, ...] = (16, 32, 64)
    nrhs: tuple[int, ...] = (1, 4)
    dtype: str = "float32"
    #: per-request latency SLO stamped onto every submit (None = no SLO):
    #: the serve:trace record then carries slack-at-dispatch and
    #: violation attribution per request
    deadline_ms: Optional[float] = None


def build_requests(wl: Workload) -> list[tuple]:
    """Materialize the workload: a list of (op, A, B) with well-conditioned
    operands (SPD via G@G.T + n*I; tall G for lstsq)."""
    rng = np.random.default_rng(wl.seed)
    dt = np.dtype(wl.dtype)
    out = []
    for _ in range(wl.requests):
        op = wl.ops[int(rng.integers(len(wl.ops)))]
        n = int(wl.ns[int(rng.integers(len(wl.ns)))])
        k = int(wl.nrhs[int(rng.integers(len(wl.nrhs)))])
        if op == "lstsq":
            A = rng.standard_normal((4 * n, n)).astype(dt)
            B = rng.standard_normal((4 * n, k)).astype(dt)
        else:
            G = rng.standard_normal((n, n)).astype(dt)
            A = (G @ G.T + n * np.eye(n, dtype=dt)).astype(dt)
            B = (rng.standard_normal((n, k)).astype(dt)
                 if op == "posv" else None)
        out.append((op, A, B))
    return out


def warmup_specs(wl: Workload) -> list[tuple]:
    """One warmup spec per (op, n, nrhs) cell the workload can draw — after
    warmup(specs) every request hits the executable cache."""
    specs = []
    for op in wl.ops:
        for n in wl.ns:
            for k in wl.nrhs:
                if op == "lstsq":
                    specs.append((op, (4 * n, n), (4 * n, k), wl.dtype))
                elif op == "posv":
                    specs.append((op, (n, n), (n, k), wl.dtype))
                else:
                    specs.append((op, (n, n), None, wl.dtype))
    return specs


def run_closed_loop(eng, requests: list[tuple], concurrency: int,
                    deadline_ms: Optional[float] = None, *,
                    tickets: Optional[list] = None) -> dict:
    """Drive one engine to completion over `requests` with at most
    `concurrency` clients outstanding.  A client's slot frees when its
    Response LANDS (not merely when its batch dispatches) — that is the
    closed loop.  `deadline_ms` stamps the per-request SLO onto every
    submit (trace attribution; scheduling is unchanged).  `tickets`, when
    given, receives every request's Ticket in workload order (the caller
    reads the responses).  Returns wall-clock QPS and completion counts."""
    todo = list(requests)
    todo.reverse()  # pop() from the tail preserves workload order
    outstanding: list = []
    completed = ok = failed = 0
    t_start = time.monotonic()
    while todo or outstanding:
        progressed = False
        while todo and len(outstanding) < concurrency:
            op, A, B = todo.pop()
            outstanding.append(eng.submit(op, A, B,
                                          deadline_ms=deadline_ms))
            if tickets is not None:
                tickets.append(outstanding[-1])
            progressed = True
        eng.pump()
        still = []
        for t in outstanding:
            if t.response is not None:
                completed += 1
                ok += 1 if t.response.ok else 0
                failed += 0 if t.response.ok else 1
                progressed = True
            else:
                still.append(t)
        outstanding = still
        if progressed:
            continue
        # nothing moved this iteration: force the oldest dispatched batch
        # to land, or (if everything is queued behind the flush deadline)
        # wait it out / drain the tail.
        dispatched = [t for t in outstanding if t.done]
        if dispatched:
            dispatched[0].result()
        elif eng.queue_depth() and todo:
            time.sleep(min(eng.cfg.max_delay_s, 1e-3))
        else:
            eng.drain()
    wall = time.monotonic() - t_start
    return {
        "requests": completed,
        "ok": ok,
        "failed": failed,
        "wall_s": round(wall, 6),
        "qps": round(completed / wall, 3) if wall > 0 else 0.0,
    }


def _mk_engine(cfg, scheduler: str, grid=None, device=None):
    """A fresh engine at `scheduler` on `grid`, else on a one-device grid
    of `device` (None: the CUDA card)."""
    from capital_tpu_torch.parallel.topology import Grid
    from capital_tpu_torch.serve.engine import SolveEngine

    if grid is None:
        grid = Grid.square(device=device)
    return SolveEngine(grid, dataclasses.replace(cfg, scheduler=scheduler))


def compare(cfg, wl: Workload = Workload(), *, grid=None, device=None,
            ledger_path: Optional[str] = None,
            modes: tuple[str, ...] = ("sync", "continuous"),
            window_s: Optional[float] = None,
            trace: bool = False,
            engines: Optional[dict] = None) -> dict:
    """The A/B harness: run the same workload through each scheduler mode
    (fresh engine each, shared ServeConfig otherwise — including
    persist_dir, which both may share safely), emit one ledger record per
    mode, and return {mode: results, 'speedup': continuous_qps/sync_qps}.

    `window_s` attaches rolling-window telemetry to each mode's engine
    and appends one serve:window record per closed window; `trace`
    appends one serve:trace record per mode carrying every request's
    span chain.  Both default off, so pre-existing ledger contents stay
    byte-compatible.  `engines`, when given, receives each mode's
    (engine, tickets) after its run (the caller reads the programs, the
    cache and the responses).

    The sync mode runs first so a cold persist_dir is warm for the
    continuous run in the same way a restart would see it; with warmup()
    covering the whole workload grid, both modes serve at misses == 0
    either way."""
    requests = build_requests(wl)
    specs = warmup_specs(wl)
    results: dict = {}
    records: dict = {}
    for mode in modes:
        eng = _mk_engine(cfg, mode, grid, device)
        if window_s:
            eng.enable_telemetry(window_s)
        eng.warmup(specs)
        tickets = [] if engines is not None else None
        results[mode] = run_closed_loop(eng, requests, wl.concurrency,
                                        deadline_ms=wl.deadline_ms,
                                        tickets=tickets)
        if engines is not None:
            engines[mode] = (eng, tickets)
        results[mode]["cache"] = eng.cache_stats()
        records[mode] = (eng, results[mode])
    speedup = None
    if "sync" in results and "continuous" in results:
        base = results["sync"]["qps"]
        speedup = (round(results["continuous"]["qps"] / base, 4)
                   if base else None)
        results["speedup"] = speedup
    for mode, (eng, res) in records.items():
        block = {
            "mode": mode,
            "concurrency": wl.concurrency,
            "seed": wl.seed,
            "qps": res["qps"],
            "wall_s": res["wall_s"],
        }
        if mode == "continuous" and speedup is not None:
            block["baseline_qps"] = results["sync"]["qps"]
            block["speedup"] = speedup
        res["record"] = eng.emit_stats(ledger_path, loadgen=block)
        if eng.telemetry is not None:
            wrecs = eng.telemetry.emit(ledger_path, grid=eng.grid,
                                       config=eng.cfg,
                                       loadgen={"mode": mode})
            res["window_records"] = len(wrecs)
        if trace:
            res["trace_record"] = eng.emit_trace(
                ledger_path, loadgen={"mode": mode})
    return results


# ---- multi-replica offered load ----------------------------------------------


def _client_requests(wl: Workload, client: int, clients: int) -> list[tuple]:
    """Client `client`'s slice of the workload: one shared fixed-seed list,
    dealt round-robin — every client sees the same op/bucket mix, and the
    union across clients is byte-identical for every (replica count,
    client mode) being compared."""
    return build_requests(wl)[client::clients]


def _client_loop(submit, requests: list[tuple]) -> dict:
    """One closed-loop client: exactly one request in flight.  `submit` is
    op, A, B -> (ok, error); counts come back to the caller."""
    ok = failed = 0
    for op, A, B in requests:
        good, _err = submit(op, A, B)
        ok += 1 if good else 0
        failed += 0 if good else 1
    return {"requests": len(requests), "ok": ok, "failed": failed}


def _client_proc_main(conn, wl: Workload, client: int, clients: int) -> None:
    """Child main for one PROCESS client (spawn target — top level, and
    this module imports no torch, so the client process stays lightweight).
    Speaks ("submit", seq, op, A, B) / receives ("result", seq, ok, error);
    strictly one in flight — the closed loop lives HERE, in the client."""
    reqs = _client_requests(wl, client, clients)
    seq = 0

    def submit(op, A, B):
        nonlocal seq
        conn.send(("submit", seq, op, A, B))
        kind, rseq, good, err = conn.recv()
        assert kind == "result" and rseq == seq, (kind, rseq, seq)
        seq += 1
        return good, err

    counts = _client_loop(submit, reqs)
    conn.send(("done", counts))
    conn.close()


def _run_thread_clients(router, wl: Workload, clients: int,
                        timeout: float) -> list[dict]:
    import threading

    out: list[Optional[dict]] = [None] * clients

    def client(ci: int) -> None:
        def submit(op, A, B):
            t = router.submit(op, A, B)
            res = t.result(timeout)
            return res.ok, res.error

        out[ci] = _client_loop(submit, _client_requests(wl, ci, clients))

    threads = [threading.Thread(target=client, args=(ci,), daemon=True)
               for ci in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        if t.is_alive():
            raise TimeoutError(f"loadgen client thread {t.name} wedged")
    return [c for c in out if c is not None]


def _run_process_clients(router, wl: Workload, clients: int,
                         timeout: float) -> list[dict]:
    """M client processes against the in-process router: each child runs
    its own closed loop over a pipe; this frontend relays submits to the
    router and landed results back.  The router's pump thread is already
    running — this loop only moves messages."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    conns, procs = [], []
    for ci in range(clients):
        parent, child = ctx.Pipe(duplex=True)
        p = ctx.Process(target=_client_proc_main,
                        args=(child, wl, ci, clients), daemon=True)
        p.start()
        child.close()
        conns.append(parent)
        procs.append(p)
    pending: dict[tuple[int, int], object] = {}
    counts: dict[int, dict] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(counts) < clients:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"process-client loadgen incomplete: {len(counts)}/"
                    f"{clients} clients done, {len(pending)} in flight"
                )
            progressed = False
            for ci, conn in enumerate(conns):
                if ci in counts:
                    continue
                while conn.poll(0):
                    try:
                        msg = conn.recv()
                    except EOFError:
                        raise RuntimeError(
                            f"loadgen client process {ci} died mid-run"
                        ) from None
                    if msg[0] == "submit":
                        _, seq, op, A, B = msg
                        pending[(ci, seq)] = router.submit(op, A, B)
                        progressed = True
                    else:  # ("done", counts) — stop polling this pipe;
                        # the child closes its end next and poll() would
                        # report the EOF as readable forever
                        counts[ci] = msg[1]
                        progressed = True
                        break
            for key, t in list(pending.items()):
                if t.done:
                    ci, seq = key
                    res = t.response
                    conns[ci].send(("result", seq, res.ok, res.error))
                    del pending[key]
                    progressed = True
            if not progressed:
                time.sleep(1e-3)
    finally:
        for p in procs:
            p.join(5.0)
            if p.is_alive():
                p.kill()
    return [counts[ci] for ci in sorted(counts)]


def run_router_closed_loop(router, wl: Workload, clients: int, *,
                           client_mode: str = "thread",
                           timeout: float = 600.0) -> dict:
    """Drive one Router to completion with `clients` closed-loop clients
    (each holds exactly one request in flight — offered load is `clients`
    outstanding).  `client_mode="process"` puts each client in its own
    spawned process (loads the router through real IPC and leaves the GIL
    to the router+replicas).  The router must have its replicas registered
    and warmed; its pump thread is started (and left running) here."""
    if client_mode not in ("thread", "process"):
        raise ValueError(f"unknown client_mode {client_mode!r}")
    router.start()
    t_start = time.monotonic()
    runner = (_run_thread_clients if client_mode == "thread"
              else _run_process_clients)
    per_client = runner(router, wl, clients, timeout)
    wall = time.monotonic() - t_start
    completed = sum(c["requests"] for c in per_client)
    return {
        "requests": completed,
        "ok": sum(c["ok"] for c in per_client),
        "failed": sum(c["failed"] for c in per_client),
        "clients": clients,
        "client_mode": client_mode,
        "wall_s": round(wall, 6),
        "qps": round(completed / wall, 3) if wall > 0 else 0.0,
    }


def compare_replicas(
    cfg, wl: Workload = Workload(), *,
    replica_counts: tuple[int, ...] = (1, 2),
    replica_mode: str = "thread",
    client_mode: str = "thread",
    policy: str = "least_loaded",
    ledger_path: Optional[str] = None,
    env: Optional[dict] = None,
    device: Optional[str] = None,
) -> dict:
    """The replica-count A/B: the same fixed-seed workload at EQUAL
    per-client offered load (clients and total requests both scale with
    the replica count, so each client's closed loop is identical across
    counts) against a fresh router per count, all counts sharing
    ``cfg.persist_dir`` — count 1 warms the disk tier, every later count
    proves the multi-writer warm path.

    Emits per-replica records plus one aggregate record per count; the
    aggregate's `router` block carries qps, and — for counts past the
    first — ``baseline_qps`` (the first count's) and
    ``scaling_efficiency = (qps_N / N) / (qps_base / base)``.  Returns
    {count: results, 'scaling_efficiency': ..., 'speedup': ...}.
    `device` is the replicas' device (None: the CUDA card)."""
    from capital_tpu_torch.serve.replica import make_replica
    from capital_tpu_torch.serve.router import Router, RouterConfig

    specs = warmup_specs(wl)
    results: dict = {}
    base_n = replica_counts[0]
    for n in replica_counts:
        wl_n = dataclasses.replace(wl, requests=wl.requests * n)
        clients = wl.concurrency * n
        router = Router(RouterConfig(policy=policy))
        for i in range(n):
            router.add_replica(make_replica(
                replica_mode, f"n{n}-r{i}", cfg, env=env, device=device))
        warm = router.warmup(specs)
        try:
            res = run_router_closed_loop(
                router, wl_n, clients, client_mode=client_mode)
            res["warmup_fresh"] = warm
            res["counters"] = router.counters()
            block = {
                "replicas": n,
                "policy": policy,
                "replica_mode": replica_mode,
                "client_mode": client_mode,
                "clients": clients,
                "seed": wl.seed,
                "qps": res["qps"],
                "wall_s": res["wall_s"],
            }
            if n != base_n and base_n in results:
                base_qps = results[base_n]["qps"]
                block["baseline_qps"] = base_qps
                block["baseline_replicas"] = base_n
                if base_qps:
                    block["speedup"] = round(res["qps"] / base_qps, 4)
                    block["scaling_efficiency"] = round(
                        (res["qps"] / n) / (base_qps / base_n), 4)
            res["router_block"] = block
            res["records"] = router.emit_stats(ledger_path, router=block)
            results[n] = res
        finally:
            router.stop()
    counts = [n for n in replica_counts if n in results]
    if len(counts) >= 2:
        last = results[counts[-1]]["router_block"]
        results["speedup"] = last.get("speedup")
        results["scaling_efficiency"] = last.get("scaling_efficiency")
    return results
