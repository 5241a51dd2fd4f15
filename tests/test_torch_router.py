"""The port's multi-replica front end (capital_tpu_torch/serve: replica,
router, loadgen's router half) against the JAX package's, on the CPU.

* `_rung`, `bucket_signature` and `_rendezvous` equal the reference's
  over a grid of ops, shapes, dtypes, tiers, affinity tokens, ladders and
  replica sets (sha1 rendezvous: the port picks exactly what the reference
  picks);
* the router suite of the reference's tests/test_serve_router.py on
  `ThreadReplica`s of the port's CPU engine: unknown policy, no healthy
  replica, round trip + the no-drop invariant, least-loaded spread, ladder
  disagreement, crash re-dispatch, kill-all parks then flushes, drain
  under load, drain-all refuses, first-wins duplicates, merged snapshots
  valid under the reference's `validate_request_stats`, traces riding
  back tagged;
* the persistent tier's property on the router: after a kill, the
  replacement that warms no spec of its own on the warm directory serves
  every bucket the affinity rebalance hands it with no build;
* `_marshal` (x to host numpy, info to a plain dict), a replica whose
  engine cannot be built reporting ("fatal", ...), and `compare_replicas`'
  scaling block;
* one slow-marked `ProcessReplica` pipe round trip (spawn context).
"""

import time

import numpy as np
import pytest
import torch

from capital_tpu.obs import ledger as rledger
from capital_tpu.serve import router as rrouter
from capital_tpu_torch.serve import loadgen, replica, router
from capital_tpu_torch.serve import stats as serve_stats
from capital_tpu_torch.serve.engine import ServeConfig
from capital_tpu_torch.serve.replica import ProcessReplica, ThreadReplica
from capital_tpu_torch.serve.router import Router, RouterConfig, _rendezvous, _rung, bucket_signature


def _cfg(persist_dir=None, **kw):
    """One tiny f32 bucket ladder; a tight max_delay_s keeps the worker's
    deadline flushes fast."""
    base = dict(buckets=(8,), rows_buckets=(32,), nrhs_buckets=(1,), max_batch=2,
                max_delay_s=0.005, small_n_impl="pallas",
                persist_dir=str(persist_dir) if persist_dir else None)
    return ServeConfig(**{**base, **kw})


_SPECS = [("posv", (8, 8), (8, 1), "float32")]


def _posv(rng, n=8):
    G = rng.standard_normal((n, n)).astype(np.float32)
    A = (G @ G.T + n * np.eye(n, dtype=np.float32)).astype(np.float32)
    B = rng.standard_normal((n, 1)).astype(np.float32)
    return A, B


def _router(n, persist_dir=None, policy="least_loaded", prefix="r", **kw):
    r = Router(RouterConfig(policy=policy))
    for i in range(n):
        r.add_replica(ThreadReplica(f"{prefix}{i}", _cfg(persist_dir, **kw), device="cpu"))
    return r


def _pump_until_done(r, tickets, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not all(t.done for t in tickets):
        r.pump()
        if time.monotonic() > deadline:
            raise TimeoutError(f"{sum(not t.done for t in tickets)} tickets never landed")
        time.sleep(1e-3)


def _resid(A, B, x):
    A, B, x = (np.asarray(v, dtype=np.float64) for v in (A, B, x))
    return np.linalg.norm(A @ x - B) / np.linalg.norm(B)


# ---- signatures and rendezvous: the reference's, exactly ---------------------

LADDERS = [
    {"buckets": (8, 16), "rows_buckets": (32,), "nrhs_buckets": (1, 4)},
    {"buckets": (32, 64, 128), "rows_buckets": (128, 256, 512), "nrhs_buckets": (1, 8, 64)},
    {"buckets": (16, 8), "rows_buckets": (64, 32), "nrhs_buckets": (4, 1)},
]
SHAPES = [("posv", (8, 8), (8, 1)), ("posv", (5, 5), (5, 3)), ("posv", (100, 100), (100, 9)),
          ("inv", (7, 7), None), ("inv", (200, 200), None), ("lstsq", (30, 7), (30, 3)),
          ("lstsq", (120, 30), (120, 1)), ("lstsq", (600, 16), (600, 2)), ("posv", (8, 8), (8, 65))]


@pytest.mark.parametrize("lad", range(len(LADDERS)))
@pytest.mark.parametrize("dtype", ["float32", "float64", np.dtype("float32")])
def test_bucket_signature_equals_reference(lad, dtype):
    ladders = LADDERS[lad]
    for op, a, b in SHAPES:
        for tier in ("balanced", "fast", "guaranteed"):
            for aff in (None, "s1", 17):
                got = bucket_signature(op, a, b, dtype, ladders, tier=tier, affinity=aff)
                want = rrouter.bucket_signature(op, a, b, dtype, ladders, tier=tier, affinity=aff)
                assert got == want, (op, a, b, tier, aff)


def test_rung_equals_reference():
    for ladder in ((8, 16, 32), (32, 8, 16), (8,), (4, 1)):
        for v in range(0, 40):
            assert _rung(ladder, v) == rrouter._rung(ladder, v)


@pytest.mark.parametrize("ids", [["r0", "r1"], ["a", "b", "c"], ["n2-r0", "n2-r1", "r2", "x"], ["solo"]])
def test_rendezvous_equals_reference(ids):
    lad = LADDERS[0]
    sigs = [bucket_signature(op, a, b, "float32", lad, tier=t)
            for op, a, b in SHAPES for t in ("balanced", "guaranteed")]
    sigs += [("affinity", f"sess{i}") for i in range(12)]
    for sig in sigs:
        assert _rendezvous(sig, ids) == rrouter._rendezvous(sig, ids)
        owner = _rendezvous(sig, ids)
        for gone in ids:
            if gone != owner:  # removing a non-owner never moves a signature
                assert _rendezvous(sig, [i for i in ids if i != gone]) == owner


# ---- the router suite ----------------------------------------------------------


def test_unknown_policy_rejected():
    with pytest.raises(ValueError, match="dispatch policy"):
        Router(RouterConfig(policy="round_robin"))


def test_no_healthy_replica_refuses_admission():
    with pytest.raises(RuntimeError, match="no healthy replica"):
        Router().submit("posv", np.eye(8, dtype=np.float32), np.ones((8, 1), np.float32))


def test_submit_result_roundtrip_and_invariant():
    rng = np.random.default_rng(0)
    r = _router(2)
    try:
        assert set(r.warmup(_SPECS)) == {"r0", "r1"}
        work = [_posv(rng) for _ in range(6)]
        tickets = [r.submit("posv", A, B) for A, B in work]
        _pump_until_done(r, tickets)
        for (A, B), t in zip(work, tickets):
            res = t.result(timeout=1.0)
            assert res.ok and res.replica_id in ("r0", "r1")
            assert isinstance(res.x, np.ndarray) and _resid(A, B, res.x) < 1e-4
        c = r.counters()
        assert c["completed"] == 6 and c["parked"] == 0
        assert c["duplicates"] == 0 and c["redispatched"] == 0
        out = sum(v["outstanding"] for v in c["per_replica"].values())
        assert c["completed"] + c["parked"] + out == c["dispatched"]
    finally:
        r.stop()


def test_least_loaded_spreads():
    rng = np.random.default_rng(1)
    r = _router(2)
    try:
        r.warmup(_SPECS)
        tickets = [r.submit("posv", *_posv(rng)) for _ in range(8)]
        per = r.counters()["per_replica"]
        assert per["r0"]["dispatched"] + per["r1"]["dispatched"] == 8
        assert per["r0"]["dispatched"] >= 1 and per["r1"]["dispatched"] >= 1
        _pump_until_done(r, tickets)
    finally:
        r.stop()


def test_ladder_disagreement_rejected():
    r = _router(1)
    try:
        other = ServeConfig(buckets=(16,), rows_buckets=(32,), nrhs_buckets=(1,), small_n_impl="pallas")
        with pytest.raises(ValueError, match="ladders"):
            r.add_replica(ThreadReplica("rX", other, device="cpu"))
    finally:
        r.stop()


def test_crash_redispatch_loses_nothing():
    rng = np.random.default_rng(2)
    r = _router(2)
    try:
        r.warmup(_SPECS)
        work = [_posv(rng) for _ in range(10)]
        tickets = [r.submit("posv", A, B) for A, B in work]
        r.kill_replica("r0")
        _pump_until_done(r, tickets)
        c = r.counters()
        assert c["failed_replicas"] == 1 and c["completed"] == 10 and c["parked"] == 0
        for (A, B), t in zip(work, tickets):
            assert t.response.ok and _resid(A, B, t.response.x) < 1e-4
        assert c["completed"] + c["duplicates"] >= c["redispatched"]
        assert "r0" not in c["per_replica"]
    finally:
        r.stop()


def test_kill_all_parks_then_new_replica_flushes():
    rng = np.random.default_rng(3)
    r = _router(1)
    try:
        r.warmup(_SPECS)
        tickets = [r.submit("posv", *_posv(rng)) for _ in range(3)]
        r.kill_replica("r0")
        r.pump()
        c = r.counters()
        assert c["parked"] + c["completed"] == 3
        if c["parked"]:
            with pytest.raises(RuntimeError, match="no healthy"):
                r.submit("posv", *_posv(rng))
        r.add_replica(ThreadReplica("r1", _cfg(), device="cpu"))
        r.warmup(_SPECS)
        _pump_until_done(r, tickets)
        assert r.counters()["parked"] == 0 and all(t.response.ok for t in tickets)
    finally:
        r.stop()


def test_drain_under_load_lands_everything():
    rng = np.random.default_rng(4)
    r = _router(2)
    try:
        r.warmup(_SPECS)
        first = [r.submit("posv", *_posv(rng)) for _ in range(6)]
        assert r.drain_replica("r0", timeout=60.0)
        per = r.counters()["per_replica"]["r0"]
        assert per["draining"] and per["outstanding"] == 0
        second = [r.submit("posv", *_posv(rng)) for _ in range(4)]
        assert all(t.replica_id == "r1" for t in second)
        _pump_until_done(r, first + second)
        assert all(t.response.ok for t in first + second)
        r.resume_replica("r0")
        t = r.submit("posv", *_posv(rng))
        assert t.replica_id == "r0"
        _pump_until_done(r, [t])
    finally:
        r.stop()


def test_drain_all_refuses_admission():
    r = _router(1)
    try:
        r.warmup(_SPECS)
        r.drain_replica("r0")
        with pytest.raises(RuntimeError, match="no healthy"):
            r.submit("posv", np.eye(8, dtype=np.float32), np.ones((8, 1), np.float32))
        r.resume_replica("r0")
    finally:
        r.stop()


def test_first_wins_counts_duplicate():
    r = _router(1)
    try:
        r.warmup(_SPECS)
        t = r.submit("posv", *_posv(np.random.default_rng(5)))
        _pump_until_done(r, [t])
        payload = {"request_id": t.request_id, "op": "posv", "ok": True,
                   "x": np.asarray(t.response.x), "info": None, "error": None, "bucket": None,
                   "batched": True, "latency_s": 0.0, "queue_wait_s": None, "device_s": None}
        assert r._land(r._states["r0"], t.request_id, payload) == 0
        assert r.duplicates == 1 and r.completed == 1
    finally:
        r.stop()


def test_merged_snapshots_and_traces_valid(tmp_path):
    rng = np.random.default_rng(6)
    r = _router(2)
    p = str(tmp_path / "r.jsonl")
    try:
        r.warmup(_SPECS)
        r.start()
        tickets = [r.submit("posv", *_posv(rng)) for _ in range(8)]
        assert all(t.result(timeout=60.0).ok for t in tickets)
        recs = r.emit_stats(p, router={"qps": 1.5})
        trec = r.emit_trace(p)
    finally:
        r.stop()
    assert len(recs) == 3  # two replica-tagged, one aggregate
    for rec in recs:
        assert rledger.validate_request_stats(rec["request_stats"]) == []
    agg = recs[-1]
    assert agg["request_stats"]["replicas"] == 2 and agg["request_stats"]["requests"] == 8
    assert agg["request_stats"]["replica_ids"] == ["r0", "r1"]
    assert agg["router"]["qps"] == 1.5 and agg["router"]["completed"] == 8
    st = trec["serve_trace"]
    assert st["requests"] == st["complete"] == 8 and rledger.validate_serve_trace(st) == []
    assert {t["replica_id"] for t in st["traces"]} <= {"r0", "r1"}


def test_affinity_routes_a_signature_to_one_replica():
    rng = np.random.default_rng(7)
    r = _router(3, policy="bucket_affinity", buckets=(8, 16))
    try:
        r.warmup(_SPECS + [("posv", (16, 16), (16, 1), "float32")])
        small = [r.submit("posv", *_posv(rng)) for _ in range(4)]
        big = [r.submit("posv", *_posv(rng, 13)) for _ in range(4)]
        sess = [r.submit("posv", *_posv(rng, n), affinity="sess") for n in (8, 13, 8)]
        assert len({t.replica_id for t in small}) == len({t.replica_id for t in big}) == 1
        assert len({t.replica_id for t in sess}) == 1
        _pump_until_done(r, small + big + sess)
        assert all(t.response.ok for t in small + big + sess)
    finally:
        r.stop()


def test_rebalance_after_kill_needs_no_build(tmp_path):
    """The persistent tier's property on the router: a replacement that
    starts on the warm directory and warms no spec of its own serves every
    bucket the affinity rebalance hands it, with no build after warm-up."""
    rng = np.random.default_rng(8)
    specs = _SPECS + [("posv", (16, 16), (16, 1), "float32"), ("inv", (8, 8), None, "float32")]
    r = _router(2, persist_dir=tmp_path, policy="bucket_affinity", buckets=(8, 16))
    try:
        # each replica warms one spec of its own: the manifest hands every
        # later warm-up the rest
        r._states["r0"].replica.warmup(specs[:1])
        r._states["r1"].replica.warmup(specs[1:])
        work = [("posv", *_posv(rng)), ("posv", *_posv(rng, 16)), ("inv", _posv(rng)[0], None)] * 3
        tickets = [r.submit(op, A, B) for op, A, B in work]
        _pump_until_done(r, tickets)
        victim = tickets[0].replica_id
        r.kill_replica(victim)
        r.pump()
        r.add_replica(ThreadReplica("r2", _cfg(tmp_path, buckets=(8, 16)), device="cpu"))
        fresh = r._states["r2"].replica.warmup([])
        assert fresh["fresh"] == 0 and fresh["cache"]["disk"]["hits"] == 3
        more = [r.submit(op, A, B) for op, A, B in work]
        _pump_until_done(r, more)
        assert all(t.response.ok for t in more)
        snaps = r.replica_stats()
        assert "r2" in snaps and any(t.replica_id == "r2" for t in more)
        for rid, snap in snaps.items():
            assert snap["cache"]["misses"] == 0, rid
        assert snaps["r2"]["cache"]["compiles"] == 0
    finally:
        r.stop()


def test_replica_without_its_device_is_fatal():
    rep = ThreadReplica("bad", _cfg(), device="cuda:99")  # no such card, here or on a one-card host
    r = Router()
    r.add_replica(rep)
    try:
        assert r.warmup(_SPECS) == {"bad": None}
        r.pump()
        assert rep.fatal is not None and r.counters()["failed_replicas"] == 1
        with pytest.raises(RuntimeError, match="no healthy replica"):
            r.submit("posv", *_posv(np.random.default_rng(9)))
    finally:
        r.stop()


def test_marshal_hands_back_host_values():
    from capital_tpu_torch.robust.config import RobustInfo
    from capital_tpu_torch.serve.executor import Response

    z = torch.tensor(0, dtype=torch.int32)
    info = RobustInfo(z, z, z, torch.tensor(0.0), z, torch.tensor(-1.0), 0)
    resp = Response(3, "posv", True, torch.ones(4, 2, dtype=torch.bfloat16), info, None,
                    ("posv", "bfloat16", (8, 8), (8, 1), 2, "balanced"), True, 0.01, 0.004, 0.006)
    d = replica._marshal(11, resp)
    assert d["request_id"] == 11 and d["ok"] is True and d["batched"] is True
    assert isinstance(d["x"], np.ndarray) and d["x"].dtype == np.float32 and d["x"].shape == (4, 2)
    assert d["info"] == {"info": 0, "breakdown": 0, "shifted": 0, "sigma": 0.0, "escalated": 0,
                         "ortho": -1.0, "gate": 0}
    assert d["bucket"] == ("posv", "bfloat16", (8, 8), (8, 1), 2, "balanced") and d["trace"] is None
    res = replica.Result(**d, replica_id="r0")
    assert res.queue_wait_s == 0.004 and res.device_s == 0.006


def test_make_replica_modes():
    assert isinstance(replica.make_replica("thread", "a", _cfg(), device="cpu"), ThreadReplica)
    p = replica.make_replica("process", "b", _cfg(), env={"X": "1"})
    assert isinstance(p, ProcessReplica) and p.device == "cuda" and p.env == {"X": "1"}
    with pytest.raises(ValueError, match="unknown replica mode"):
        replica.make_replica("fiber", "c", _cfg())


def test_merge_snapshots_pools_percentiles():
    snaps = []
    for i, lat in enumerate(([0.001, 0.002, 0.003], [0.1, 0.2, 0.3])):
        c = serve_stats.Collector(replica_id=f"r{i}")
        for v in lat:
            c.record_request("posv", v, ok=True, queue_wait_s=v / 2, device_s=v / 2)
        c.note_batch(0.5)
        snaps.append(c.snapshot(samples=True))
    m = serve_stats.merge_snapshots(snaps)
    pool = [0.001, 0.002, 0.003, 0.1, 0.2, 0.3]
    assert m["latency_ms"]["p50"] == round(serve_stats.percentiles(pool)["p50"] * 1e3, 4)
    assert rledger.validate_request_stats(m) == []


def test_compare_replicas_records_efficiency(tmp_path):
    p = str(tmp_path / "ab.jsonl")
    wl = loadgen.Workload(requests=6, concurrency=2, ops=("posv",), ns=(8,), nrhs=(1,))
    res = loadgen.compare_replicas(_cfg(), wl, replica_counts=(1, 2), ledger_path=p, device="cpu")
    for n in (1, 2):
        assert res[n]["failed"] == 0 and res[n]["requests"] == 6 * n
        assert res[n]["counters"]["completed"] == 6 * n
    blk = res[2]["router_block"]
    assert blk["baseline_qps"] == res[1]["qps"]
    assert blk["scaling_efficiency"] == pytest.approx((res[2]["qps"] / 2) / res[1]["qps"], rel=1e-3)
    assert res["scaling_efficiency"] == blk["scaling_efficiency"]
    recs = rledger.read(p)
    assert all(rledger.validate_request_stats(r["request_stats"]) == [] for r in recs)
    aggs = [r for r in recs if r.get("router")]
    assert len(aggs) == 2 and "scaling_efficiency" in aggs[-1]["router"]


def test_router_closed_loop_rejects_unknown_client_mode():
    with pytest.raises(ValueError, match="client_mode"):
        loadgen.run_router_closed_loop(Router(), loadgen.Workload(), 1, client_mode="fiber")


@pytest.mark.slow
def test_process_replica_pipe_roundtrip(tmp_path):
    rep = ProcessReplica("p0", _cfg(tmp_path), device="cpu")
    rep.start()
    try:
        info = rep.warmup(_SPECS, timeout=300.0)
        assert info is not None and info["fresh"] >= 1
        A, B = _posv(np.random.default_rng(10))
        rep.submit(0, "posv", A, B)
        deadline = time.monotonic() + 120.0
        result = None
        while result is None and time.monotonic() < deadline:
            for msg in rep.poll():
                if msg[0] == "result":
                    result = msg[2]
            time.sleep(0.01)
        assert result is not None and result["ok"] and _resid(A, B, result["x"]) < 1e-4
        assert rep.ping() is not None
    finally:
        rep.stop()
        assert not rep.alive()


def test_router_module_is_the_reference_surface():
    for name in ("RouterConfig", "RouterTicket", "Router", "POLICIES", "bucket_signature"):
        assert hasattr(router, name) and hasattr(rrouter, name)
    assert router.POLICIES == rrouter.POLICIES
    assert router.RouterConfig() == router.RouterConfig(**vars(rrouter.RouterConfig()))
