"""The port's serve engine (capital_tpu_torch/serve: SolveEngine, its
scheduler, executor, program cache and request stats) against the JAX
package's (capital_tpu/serve), on the CPU.

One seeded request stream (numpy, `STREAM`) goes through the JAX engine
once per scheduler (module-scoped fixture: its AOT compiles and the
interpret-mode Pallas kernels are the slow part) and through the port's
engine on a CPU grid under both schedulers.  The stream covers dense posv
/ lstsq / inv in f32 and f64, posv_blocktri and posv_arrowhead, the 'fast'
and 'guaranteed' tiers, an oversize request (the single route), a
`serve::ingest` fault that fails one request, a NaN pivot that flags one
request, capacity flushes inside submit and one deadline flush through
`pump(now=...)`.

Equal, per request: `ok`, `info`, `bucket`, `batched`, `error is None`;
and `cache_stats()` and the stats snapshot's counts (requests, ok,
flagged, failed, per op, batches).  Close: X within 1e-4 of max|X_ref|
for f32 and for the fast tier (which factors in f32), 1e-10 for f64.
The port's `serve:request_stats` and `serve:trace` records must pass the
reference's validators.
"""

import time
import types

import numpy as np
import pytest
import torch

from capital_tpu.bench.harness import percentiles as rpercentiles
from capital_tpu.obs import ledger as rledger
from capital_tpu.obs import spans as rspans
from capital_tpu.robust import faultinject as rfaultinject
from capital_tpu.robust.config import RobustConfig as RRobustConfig
from capital_tpu.serve import batching as rbatching
from capital_tpu.serve import engine as rengine
from capital_tpu.serve import executor as rexecutor
from capital_tpu.serve import stats as rstats
from capital_tpu_torch import Grid
from capital_tpu_torch.obs import ledger, spans
from capital_tpu_torch.robust import faultinject
from capital_tpu_torch.robust.config import RobustConfig
from capital_tpu_torch.serve import ServeConfig, SolveEngine, api, batching, program, stats
from capital_tpu_torch.serve.cache import ExecutableCache
from capital_tpu_torch.serve.executor import Executor

SCHEDULERS = ("continuous", "sync")
LADDERS = dict(buckets=(16, 32), rows_buckets=(64, 128), nrhs_buckets=(1, 4), nblocks_buckets=(4, 8),
               block_buckets=(8, 16), border_buckets=(4, 8), max_batch=4,
               # no flush by age: the stream's one deadline flush is pump(now=...)
               max_delay_s=10.0)
#: X tolerance relative to max|X_ref|
TOL = {"float32": 1e-4, "float64": 1e-10}


def _spd(rng, n):
    X = rng.standard_normal((n, n))
    return X @ X.T / n + 3.0 * np.eye(n)


def _chain(rng, nblocks, b):
    D = np.stack([_spd(rng, b) + 2.0 * np.eye(b) for _ in range(nblocks)])
    C = 0.2 * rng.standard_normal((nblocks, b, b)) / np.sqrt(b)
    C[0] = 0
    return np.stack([D, C])


def _tail(rng, nblocks, b, s, k):
    """The packed arrowhead tail (nblocks·b + s, s + k): a weak border
    beside the flat RHS, an SPD corner beside its RHS."""
    n_t = nblocks * b
    P = np.zeros((n_t + s, s + k))
    P[:n_t, :s] = 0.05 * rng.standard_normal((n_t, s)) / np.sqrt(b)
    P[n_t:, :s] = _spd(rng, s) + 4.0 * np.eye(s)
    P[:, s:] = rng.standard_normal((n_t + s, k))
    return P


def _stream():
    """[(op, A, B, tier) or 'pump'] — the seeded request stream, and the
    submit index of the ingest fault and of the NaN pivot."""
    rng = np.random.default_rng(1234)
    out = []

    def add(op, A, B=None, tier="balanced", dtype=np.float64):
        out.append((op, A.astype(dtype), None if B is None else B.astype(dtype), tier))

    f32 = np.float32
    for n, k in ((10, 2), (14, 4), (20, 1), (16, 3), (9, 1)):
        add("posv", _spd(rng, n), rng.standard_normal((n, k)), dtype=f32)
    for m, n, k in ((40, 12, 2), (50, 16, 3)):
        add("lstsq", rng.standard_normal((m, n)), rng.standard_normal((m, k)), dtype=f32)
    add("inv", _spd(rng, 12), dtype=f32)
    for n, k in ((9, 1), (13, 4), (30, 2), (12, 3), (15, 1), (11, 2)):
        add("posv", _spd(rng, n), rng.standard_normal((n, k)))
    out.append("pump")  # the deadline flush: every partial queue goes now
    add("lstsq", rng.standard_normal((50, 20)), rng.standard_normal((50, 2)))
    add("inv", _spd(rng, 15))
    add("inv", _spd(rng, 7))
    add("posv_blocktri", _chain(rng, 3, 6), rng.standard_normal((3, 6, 2)), dtype=f32)
    add("posv_blocktri", _chain(rng, 6, 12), rng.standard_normal((6, 12, 1)))
    add("posv_arrowhead", _chain(rng, 3, 6), _tail(rng, 3, 6, 3, 2), dtype=f32)
    add("posv", _spd(rng, 12), rng.standard_normal((12, 2)), tier="fast")
    add("posv", _spd(rng, 12), rng.standard_normal((12, 2)), tier="guaranteed")
    add("posv", _spd(rng, 10), rng.standard_normal((10, 3)), tier="guaranteed")
    add("posv", _spd(rng, 40), rng.standard_normal((40, 2)))  # oversize: the single route
    fault_at = sum(1 for e in out if e != "pump")
    add("posv", _spd(rng, 10), rng.standard_normal((10, 1)))  # the ingest fault fails this one
    nan_at = sum(1 for e in out if e != "pump")
    A = _spd(rng, 10)
    A[3, 3] = np.nan
    add("posv", A, rng.standard_normal((10, 2)))  # NaN pivot: flagged
    add("posv", _spd(rng, 10), rng.standard_normal((10, 2)))
    return out, fault_at, nan_at


STREAM, FAULT_AT, NAN_AT = _stream()
WARM = [("posv", (16, 16), (16, 4), "float64"), ("inv", (16, 16), None, "float64")]


def _drive(eng, fi):
    """Warm up, send STREAM with the ingest fault planted, drain; the
    responses, the plan's firing record and the engine's records."""
    eng.warmup(WARM)
    tickets = []
    with fi.active_plan(fi.Fault(tag="serve::ingest", kind="raise", index=FAULT_AT)) as plan:
        for e in STREAM:
            if e == "pump":
                eng.pump(now=time.monotonic() + 1e3)
                continue
            op, A, B, tier = e
            tickets.append(eng.submit(op, A, B, accuracy_tier=tier))
    eng.drain()
    return dict(responses=[t.result() for t in tickets], fired=list(plan.fired),
                cache=eng.cache_stats(), snap=eng.stats.snapshot(),
                stats_rec=eng.emit_stats(), trace_rec=eng.emit_trace())


@pytest.fixture(scope="module")
def runs():
    out = {}
    for sched in SCHEDULERS:
        rcfg = rengine.ServeConfig(robust=RRobustConfig(), scheduler=sched, **LADDERS)
        out["jax", sched] = _drive(rengine.SolveEngine(cfg=rcfg), rfaultinject)
        cfg = ServeConfig(robust=RobustConfig(), scheduler=sched, **LADDERS)
        out["torch", sched] = _drive(SolveEngine(Grid.square(device="cpu"), cfg), faultinject)
    return out


def _info(i):
    return None if i is None else tuple(i)


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_responses_match_reference(runs, sched):
    ref, got = runs["jax", sched], runs["torch", sched]
    assert got["fired"] == ref["fired"] == [("serve::ingest", FAULT_AT)]
    requests = [e for e in STREAM if e != "pump"]
    assert len(got["responses"]) == len(ref["responses"]) == len(requests)
    for i, ((op, A, B, tier), r, p) in enumerate(zip(requests, ref["responses"], got["responses"])):
        assert (p.op, p.ok, p.bucket, p.batched, p.error is None) == (
            r.op, r.ok, r.bucket, r.batched, r.error is None), (i, op)
        assert _info(p.info) == _info(r.info), (i, op)
        if not r.ok:
            continue
        want = np.asarray(r.x, dtype=np.float64)
        have = p.x.double().numpy()
        assert have.shape == want.shape and str(p.x.dtype).endswith(A.dtype.name), (i, op)
        tol = TOL["float32" if tier == "fast" else A.dtype.name]
        assert np.abs(have - want).max() <= tol * np.abs(want).max(), (i, op, tier)
    # the fault and the NaN pivot hit exactly their requests
    oks = [r.ok for r in got["responses"]]
    assert [i for i, ok in enumerate(oks) if not ok] == [FAULT_AT, NAN_AT]
    assert got["responses"][FAULT_AT].x is None and "injected fault" in got["responses"][FAULT_AT].error
    assert got["responses"][NAN_AT].info.breakdown == 1


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_cache_and_counts_match_reference(runs, sched):
    ref, got = runs["jax", sched], runs["torch", sched]
    assert got["cache"] == ref["cache"]
    assert got["cache"]["misses"] > 0 and got["cache"]["warmup_compiles"] == 2
    keys = ("requests", "ok", "flagged", "failed", "ops", "batches", "queue_depth_max", "blocktri_impls")
    assert {k: got["snap"].get(k) for k in keys} == {k: ref["snap"].get(k) for k in keys}
    assert got["snap"]["flagged"] == 1 and got["snap"]["failed"] == 1
    assert got["snap"]["refine"]["requests"] == ref["snap"]["refine"]["requests"] == 2
    assert got["snap"]["refine"]["converged"] == ref["snap"]["refine"]["converged"] == 2
    assert got["snap"]["batch_occupancy_mean"] == ref["snap"]["batch_occupancy_mean"]


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_records_pass_reference_validators(runs, sched):
    got = runs["torch", sched]
    assert rledger.validate_request_stats(got["stats_rec"]["request_stats"]) == []
    st = got["trace_rec"]["serve_trace"]
    assert rledger.validate_serve_trace(st) == []
    assert st["requests"] == st["complete"] == len(got["responses"])
    for t in st["traces"]:
        assert spans.trace_dict_problems(t) == rspans.trace_dict_problems(t) == []
    kinds = sorted({t["kind"] for t in st["traces"]})
    assert kinds == ["batched", "failed", "single"]
    for rec, kind in ((got["stats_rec"], "serve:request_stats"), (got["trace_rec"], "serve:trace")):
        assert rec["record"] == "capital_tpu.ledger" and rec["kind"] == kind
        assert rec["manifest"]["platform"] == "cpu" and rec["manifest"]["schema_version"] == 1


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_latency_split_is_stamped(runs, sched):
    got = runs["torch", sched]
    for r in got["responses"]:
        if r.error is not None and r.queue_wait_s is None:
            continue  # the ingest fault never dispatched
        assert r.queue_wait_s >= 0 and r.device_s >= 0
        assert r.latency_s == pytest.approx(r.queue_wait_s + r.device_s, abs=1e-6)
    snap = got["snap"]
    assert set(snap["queue_wait_ms"]) == set(snap["device_ms"]) == {"p50", "p95", "p99"}


def _engine(sched="sync", **kw):
    cfg = dict(LADDERS, robust=RobustConfig(), scheduler=sched)
    cfg.update(kw)
    return SolveEngine(Grid.square(device="cpu"), ServeConfig(**cfg))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_nan_pivot_leaves_neighbours_bit_for_bit(dtype):
    rng = np.random.default_rng(5)
    probs = [(_spd(rng, 10).astype(dtype), rng.standard_normal((10, 2)).astype(dtype)) for _ in range(4)]
    runs = []
    for poison in (False, True):
        eng = _engine()
        ts = []
        for i, (A, B) in enumerate(probs):
            if poison and i == 2:
                A = A.copy()
                A[3, 3] = np.nan
            ts.append(eng.submit("posv", A, B))
        eng.drain()
        runs.append([t.result() for t in ts])
        assert eng.stats.batches == 1
    clean, poisoned = runs
    assert [r.ok for r in poisoned] == [True, True, False, True]
    assert poisoned[2].info.info != 0 and poisoned[2].info.breakdown == 1
    for i in (0, 1, 3):
        assert torch.equal(poisoned[i].x, clean[i].x)


def test_two_inflight_batches_of_one_bucket_land_their_own():
    rng = np.random.default_rng(6)
    eng = _engine("continuous", max_batch=2, max_inflight=2)
    probs = [(_spd(rng, 12), rng.standard_normal((12, 2))) for _ in range(4)]
    ts = [eng.submit("posv", A, B) for A, B in probs]
    assert eng.scheduler.inflight_depth == 2 and all(t.done for t in ts)
    eng.drain()
    for (A, B), t in zip(probs, ts):
        np.testing.assert_allclose(t.result().x.numpy(), np.linalg.solve(A, B), rtol=0, atol=1e-10)
    ((key, prog),) = eng.cache.programs().items()
    assert eng.cache.replays() == {key: 2} and not prog.captured


def test_deadline_flush_is_deterministic():
    rng = np.random.default_rng(7)
    eng = _engine("continuous")
    t = eng.submit("posv", _spd(rng, 10), rng.standard_normal((10, 1)))
    assert eng.pump(now=time.monotonic()) == 0 and not t.done
    with pytest.raises(RuntimeError, match="not flushed yet"):
        t.result()
    assert eng.pump(now=time.monotonic() + LADDERS["max_delay_s"]) == 1 and t.done
    assert t.result().ok and eng.stats.batches == 1


def test_default_grid_is_the_card():
    if torch.cuda.is_available():
        assert SolveEngine().grid.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SolveEngine()


def _residency_scenarios(eng):
    """One short scenario per residency and session op, each on its own
    token, through `eng` (either package): the op's requests land last.
    Returns {op: [Response, ...]}."""
    rng = np.random.default_rng(11)
    A, B = _spd(rng, 10).astype(np.float32), rng.standard_normal((10, 2)).astype(np.float32)
    V = (0.05 * rng.standard_normal((10, 2))).astype(np.float32)
    win = _chain(rng, 4, 6).astype(np.float32)
    seg = _chain(rng, 2, 6).astype(np.float32)
    seg[1, 0] = 0.1 * rng.standard_normal((6, 6))
    Bw = rng.standard_normal((4, 6, 2)).astype(np.float32)
    out = {}

    def run(op, tok, *steps):
        out[op] = [eng.solve(o, X, Y, factor_token=tok) for o, X, Y in steps]

    run("chol_update", "u", ("posv_cached", A, B), ("chol_update", V, None))
    run("chol_downdate", "d", ("posv_cached", A, B), ("chol_downdate", V, None))
    run("posv_cached", "c", ("posv_cached", A, B), ("posv_cached", A, B))
    run("blocktri_extend", "x", ("blocktri_extend", win, None), ("blocktri_extend", seg, None))
    run("session_open", "so", ("session_open", win, None))
    run("session_append", "sa", ("session_open", win, None), ("session_append", seg, None))
    run("session_solve", "ss", ("session_open", win, None), ("session_solve", win, Bw))
    run("session_contract", "sc", ("session_open", win, None), ("session_contract", 1, None))
    run("session_close", "sx", ("session_open", win, None), ("session_close", None, None),
        ("session_close", None, None))
    return out


@pytest.fixture(scope="module")
def residency_runs():
    rcfg = rengine.ServeConfig(robust=RRobustConfig(), **LADDERS)
    return (_residency_scenarios(rengine.SolveEngine(cfg=rcfg)),
            _residency_scenarios(_engine("continuous")))


@pytest.mark.parametrize("op", batching.FACTOR_OPS + batching.SESSION_OPS)
def test_residency_and_session_ops_refuse(residency_runs, op):
    """Each residency and session op refuses a request without its
    factor_token (the reference's ValueError, before any trace), and with
    one it serves as the reference does: the same ok, info, bucket and
    error, X within TOL (these ops raised NotImplementedError naming ROADMAP
    Queue A item 8 until the residency slice)."""
    eng = _engine()
    reng = rengine.SolveEngine(cfg=rengine.ServeConfig(**LADDERS))
    A = None if op == "session_close" else np.eye(4)
    for e in (eng, reng):
        with pytest.raises(ValueError, match="requires factor_token="):
            e.submit(op, A, None)
    assert eng.stats.requests == 0 and len(eng.trace_log) == 0
    ref, got = residency_runs[0][op], residency_runs[1][op]
    assert len(got) == len(ref)
    for r, p in zip(ref, got):
        assert (p.op, p.ok, p.bucket, p.batched, p.error) == (r.op, r.ok, r.bucket, r.batched, r.error)
        assert _info(p.info) == _info(r.info) and p.ok
        want, have = np.asarray(r.x, dtype=np.float64), p.x.double().numpy()
        assert have.shape == want.shape
        assert np.abs(have - want).max() <= TOL["float32"] * max(np.abs(want).max(), 1.0), op


def test_engine_refusals_name_their_items():
    eng = _engine()
    with pytest.raises(NotImplementedError, match="telemetry"):
        eng.enable_telemetry()
    with pytest.raises(NotImplementedError, match="persistent tier"):
        _engine(persist_dir="/nonexistent")


@pytest.mark.parametrize("kw, msg", [(dict(oversize="panic"), "oversize policy"),
                                     (dict(scheduler="batch"), "unknown scheduler"),
                                     (dict(max_inflight=0), "max_inflight")])
def test_config_validation_matches_reference(kw, msg):
    with pytest.raises(ValueError, match=msg) as p:
        _engine(**kw)
    rcfg = rengine.ServeConfig(**dict(LADDERS, **kw))
    with pytest.raises(ValueError) as r:
        rengine.SolveEngine(cfg=rcfg)
    assert str(p.value) == str(r.value)


def _buckets():
    """One bucket of every kind the engine builds, at the parity ladders."""
    out = []
    for dt in ("float32", "float64", "bfloat16"):
        out += [batching.Bucket("posv", dt, (16, 16), (16, 4), 4),
                batching.Bucket("lstsq", dt, (64, 16), (64, 4), 4),
                batching.Bucket("inv", dt, (16, 16), None, 4),
                batching.Bucket("posv_blocktri", dt, (2, 4, 8, 8), (4, 8, 4), 4),
                batching.Bucket("posv_arrowhead", dt, (2, 4, 8, 8), (36, 8), 4),
                batching.Bucket("chol_update", dt, (16, 16), (16, 4), 4),
                batching.Bucket("posv_cached", dt, (16, 16), (16, 4), 4),
                batching.Bucket("posv_cached_miss", dt, (16, 16), (16, 4), 4),
                batching.Bucket("blocktri_extend", dt, (2, 4, 8, 8), (8, 8), 4),
                batching.Bucket("session_extend", dt, (2, 4, 8, 8), (8, 8), 4),
                batching.Bucket("session_solve", dt, (4, 4, 8, 8), (4, 8, 4), 4)]
        out += [batching.Bucket("posv", dt, (16, 16), (16, 4), 4, tier)
                for tier in ("fast", "guaranteed")]
    return out


@pytest.mark.parametrize("impl", ["auto", "pallas", "pallas_split", "vmap"])
def test_capture_rule(impl):
    """`capturable` answers from the op alone: every bucket program
    captures on the card, on the port's kernels and on the library routes
    alike (f64, 'vmap', the chain's 'xla'), under either chain algorithm
    and in every tier — the card's answer for every such combination
    (probes/serve_capture.py), the residency and session programs
    included."""
    for bt in ("auto", "scan", "partitioned"):
        cfg = ServeConfig(small_n_impl=impl, blocktri_impl=bt, **LADDERS)
        for b in _buckets():
            assert program.capturable(b, cfg), (impl, bt, b)
        big = batching.Bucket("posv_blocktri", "float32", (2, 8, 170, 170), (8, 170, 1), 4)
        # beyond the chain kernels' envelope 'auto' takes the library route
        assert program.small_route(big, cfg, interpret=False) == (impl in ("pallas", "pallas_split"))
        assert program.capturable(big, cfg)
        for op in batching.MISS_OPS + batching.SESSION_BUCKET_OPS + ("posv_cached", "blocktri_extend"):
            assert program.capturable(batching.Bucket(op, "float32", (16, 16), (16, 4), 4), cfg)
    assert set(program.CAPTURED_OPS) == set(batching.OPS + batching.MISS_OPS + batching.SESSION_BUCKET_OPS)


def test_small_route_matches_reference():
    eng = _engine()
    reng = rengine.SolveEngine(cfg=rengine.ServeConfig(**LADDERS))
    for b in _buckets():
        rb = rbatching.Bucket(*b.key)
        assert eng._small_route(b) == reng._small_route(rb), b
    for nblocks in (4, 8, 16, 64):
        for dt in ("float32", "float64"):
            assert eng._blocktri_algorithm(nblocks, dt) == reng._blocktri_algorithm(nblocks, dt)


@pytest.mark.parametrize("donate", [None, False, True])
def test_donate_argnums_matches_reference(donate):
    cfg = ServeConfig(donate=donate, **LADDERS)
    rcfg = rengine.ServeConfig(donate=donate, **LADDERS)
    ops = batching.OPS + batching.MISS_OPS + batching.SESSION_BUCKET_OPS
    for platform in ("cpu", "cuda", "tpu"):
        ours = Executor(cfg, types.SimpleNamespace(platform=platform), None)
        theirs = rexecutor.Executor(rcfg, types.SimpleNamespace(platform=platform), None)
        assert ours.donate() == theirs.donate() == (platform == "tpu" if donate is None else donate)
        for op in ops:
            for b_shape in ((16, 4), None):
                for tier in ("balanced", "fast"):
                    b = batching.Bucket(op, "float32", (16, 16), b_shape, 4, tier)
                    assert ours.donate_argnums(b) == theirs.donate_argnums(rbatching.Bucket(*b.key))


def test_donation_aliases_and_validate():
    rng = np.random.default_rng(8)
    eng = _engine(donate=True)
    eng.validate = True
    A, B = _spd(rng, 12), rng.standard_normal((12, 2))
    r = eng.solve("posv", A, B)
    np.testing.assert_allclose(r.x.numpy(), np.linalg.solve(A, B), rtol=0, atol=1e-10)
    ((_, prog),) = eng.cache.programs().items()
    assert prog.donate_argnums == (1,) and prog.check_donation() == []
    ins = prog.fill_inputs()
    assert prog(*ins)[0].data_ptr() == ins[1].data_ptr()
    # a declaration the program cannot honor (lstsq's RHS is (m, k), X is
    # (n, k)) is dropped, and the check says so
    lb = batching.Bucket("lstsq", "float64", (64, 16), (64, 4), 4)
    bad = program.Program(api.batched("lstsq"), lb, "cpu", capture=False, donate_argnums=(1,))
    assert bad.check_donation() and "fresh buffer" in bad.check_donation()[0]


def test_program_on_the_cpu_is_the_closure():
    b = batching.Bucket("posv", "float64", (16, 16), (16, 4), 4)
    with pytest.raises(ValueError, match="CUDA device"):
        program.Program(api.batched("posv"), b, "cpu", capture=True)
    prog = program.Program(api.batched("posv"), b, "cpu", capture=False)
    X, info = prog(*prog.fill_inputs())
    assert not prog.captured and prog.replays == 1 and prog.capture_counts == {}
    assert torch.equal(X, torch.zeros_like(X)) and not info.any()
    assert prog.check_donation() == [] and prog.replays == 1


def test_cache_counters():
    c = ExecutableCache()
    assert c.stats() == {"hits": 0, "misses": 0, "warmup_compiles": 0, "compiles": 0,
                         "entries": 0, "hit_rate": 1.0}
    built = []
    c.get(("a",), lambda: built.append(1) or "A", warmup=True)
    assert c.get(("a",), lambda: "X") == "A"
    c.get(("b",), lambda: built.append(1) or "B")
    assert c.stats() == {"hits": 1, "misses": 1, "warmup_compiles": 1, "compiles": 2,
                         "entries": 2, "hit_rate": 0.5}
    assert built == [1, 1] and c.programs() == {}


def test_stats_match_reference():
    ours, theirs = stats.Collector(), rstats.Collector()
    rng = np.random.default_rng(9)
    for i in range(40):
        kw = dict(ok=i % 7 != 0, flagged=i % 7 == 0, small=i % 2 == 0,
                  queue_wait_s=float(rng.random()) * 1e-3, device_s=float(rng.random()) * 1e-2)
        lat = float(rng.random()) * 1e-2 if i else 0.5
        for c in (ours, theirs):
            c.record_request(("posv", "lstsq")[i % 2], lat, **kw)
            c.note_batch(0.25 * (1 + i % 4))
            c.note_queue_depth(i % 5)
            c.note_refine(i % 3, i % 4 != 0, 1e-15 * i)
            c.note_blocktri_impl(("scan", "partitioned")[i % 2])
    cache = {"hits": 3, "misses": 1, "warmup_compiles": 2, "compiles": 3, "entries": 3, "hit_rate": 0.75}
    snap = ours.snapshot(cache, samples=True)
    assert snap == theirs.snapshot(cache, samples=True)
    assert stats.merge_snapshots([snap, snap]) == rstats.merge_snapshots([snap, snap])
    for pts in ((50.0, 95.0, 99.0), (1.0, 100.0), (12.5,)):
        s = list(rng.random(17))
        assert stats.percentiles(s, pts) == rpercentiles(s, pts)


def test_spans_match_reference():
    log, rlog = spans.TraceLog(cap=3), rspans.TraceLog(cap=3)
    for lg in (log, rlog):
        for rid in range(4):
            tr = lg.start(rid, "posv", 100.0 + rid, deadline_ms=5.0, bucket="b", tier="balanced")
            t = 100.0 + rid
            for name in ("admit", "enqueue", "cache_lookup", "batch_form", "device", "respond"):
                t += 0.002 * (rid + 1)
                tr.extend(name, t)
        lg.start(9, "inv", 200.0).extend("admit", 200.001)  # an incomplete chain
    assert log.block() == rlog.block()
    assert spans.to_chrome(log.trace_dicts()) == rspans.to_chrome(rlog.trace_dicts())
    assert log.block()["complete"] == 2 and log.dropped == 2


def test_ledger_roundtrip(tmp_path):
    cfg = ServeConfig(**LADDERS)
    man = ledger.manifest(grid=Grid.square(device="cpu"), dtype=torch.float32, config=cfg)
    assert man["platform"] == "cpu" and man["dtype"] == "float32" and man["grid_shape"] == [1, 1, 1]
    assert man["config"]["__class__"] == "ServeConfig" and man["config"]["buckets"] == [16, 32]
    rec = ledger.record("serve:request_stats", man, request_stats=stats.Collector().snapshot())
    assert rledger.validate_request_stats(rec["request_stats"]) == []
    path = str(tmp_path / "sub" / "runs.jsonl")
    ledger.append(path, rec)
    ledger.append(path, rec)
    assert ledger.read(path) == rledger.read(path) == [rec, rec]
