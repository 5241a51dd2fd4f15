"""The port's serve front end, single-engine half (capital_tpu_torch/serve:
telemetry, loadgen, the CLI, the persistent warm-up manifest) against the
JAX package's (capital_tpu/serve), on the CPU.

* `build_requests` / `warmup_specs`: byte for byte the reference's over
  several `Workload`s;
* `WindowAggregator`: the port's and the reference's, fed one event
  sequence on an injected clock, close equal window dicts, which the
  reference's `validate_serve_window` accepts; `enable_telemetry` on the
  port's engine feeds it from real traffic;
* `run_closed_loop`: one seeded workload (24 requests, n 6 and 13, all
  padded) through
  the JAX engine and the port's CPU engine under both schedulers agrees
  per request (`ok`, bucket equal; X within the drivers' f32 tolerance,
  5e-5 of max|X_ref|); `compare` writes one valid serve:request_stats
  record per mode with its loadgen block, serve:window and serve:trace
  records;
* the CLI (`python -m capital_tpu_torch.serve`): `smoke` (cold, then warm
  with ``--max-compiles 0``), `loadgen` and `replicas` exit 0 with
  ``--device cpu``;
* the persistent tier (serve/cache.py): an engine on a warm directory
  builds every program its scope's manifest holds at warm-up, serves them
  with no build after it, and counts a stale, a corrupt and a raced line
  without raising.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from capital_tpu.obs import ledger as rledger
from capital_tpu.serve import engine as rengine
from capital_tpu.serve import loadgen as rloadgen
from capital_tpu.serve import telemetry as rtelemetry
from capital_tpu_torch import Grid
from capital_tpu_torch.serve import ServeConfig, SolveEngine, loadgen, telemetry
from capital_tpu_torch.serve import __main__ as cli
from capital_tpu_torch.serve import cache as cache_mod

CPU = "cpu"
SCHEDULERS = ("continuous", "sync")
#: the closed-loop parity workload and its engines' ladders
WL = loadgen.Workload(requests=24, concurrency=4, seed=5, ops=("posv", "lstsq"), ns=(6, 13),
                      nrhs=(3,))
LADDERS = dict(buckets=(8, 16), rows_buckets=(32, 64), nrhs_buckets=(1, 4), max_batch=4,
               max_delay_s=0.002)
F32_TOL = 5e-5  # bench/drivers.py _tolerance


def _engine(**kw):
    return SolveEngine(Grid.square(device=CPU), ServeConfig(**{**LADDERS, **kw}))


# ---- loadgen: the workload -------------------------------------------------

WORKLOADS = [
    dict(),
    dict(requests=40, seed=7, ops=("posv", "inv", "lstsq"), ns=(12, 24), nrhs=(1, 3, 8)),
    dict(requests=17, seed=1, dtype="float64", ops=("inv",), ns=(5,)),
    dict(requests=9, seed=123, ops=("lstsq", "posv"), ns=(16, 32, 64, 128), nrhs=(64,)),
]


@pytest.mark.parametrize("kw", WORKLOADS, ids=range(len(WORKLOADS)))
def test_build_requests_bitwise_reference(kw):
    got = loadgen.build_requests(loadgen.Workload(**kw))
    want = rloadgen.build_requests(rloadgen.Workload(**kw))
    assert len(got) == len(want) == loadgen.Workload(**kw).requests
    for (op, A, B), (rop, rA, rB) in zip(got, want):
        assert op == rop
        assert A.dtype == rA.dtype and A.shape == rA.shape and A.tobytes() == rA.tobytes()
        assert (B is None) == (rB is None)
        if B is not None:
            assert B.dtype == rB.dtype and B.shape == rB.shape and B.tobytes() == rB.tobytes()


@pytest.mark.parametrize("kw", WORKLOADS, ids=range(len(WORKLOADS)))
def test_warmup_specs_equal_reference(kw):
    assert loadgen.warmup_specs(loadgen.Workload(**kw)) == rloadgen.warmup_specs(
        rloadgen.Workload(**kw))
    assert [f.name for f in dataclasses.fields(loadgen.Workload)] == [
        f.name for f in dataclasses.fields(rloadgen.Workload)]


# ---- telemetry --------------------------------------------------------------


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _feed(mod, window_s=1.0, sample_cap=8):
    """One event sequence (requests, failures, sheds, batches, depths over
    five windows, one of them empty) into `mod`'s aggregator."""
    clk = _Clock()
    agg = mod.WindowAggregator(window_s, sample_cap=sample_cap, clock=clk)
    rng = np.random.default_rng(11)
    for w in range(5):
        if w == 2:
            clk.t += window_s  # an idle window: skipped, never emitted
            continue
        for i in range(6 + 3 * w):
            op = ("posv", "inv", "lstsq")[i % 3]
            bucket = f"{op}/f32/b{8 << (i % 2)}"
            lat = float(rng.uniform(1e-4, 0.3))
            agg.note_request(op, lat, ok=i % 5 != 4, failed=i % 5 == 4, bucket=bucket)
            if i % 4 == 0:
                agg.note_batch(float(rng.uniform(0.1, 1.0)), bucket=bucket)
            if i % 3 == 0:
                agg.note_queue_depth(int(rng.integers(0, 9)))
            clk.t += window_s / 40
        agg.note_request("posv", None, shed=True, bucket="posv/f32/b8")
        agg.note_batch(0.5)
        clk.t += window_s
    agg.note_request("inv", 0.001, t=clk.t + 0.5)  # an explicit stamp
    clk.t += 0.75
    return agg


@pytest.mark.parametrize("sample_cap", [8, 512])
def test_windows_equal_reference(sample_cap):
    got, want = _feed(telemetry, sample_cap=sample_cap), _feed(rtelemetry, sample_cap=sample_cap)
    got.flush()
    want.flush()
    assert got.windows() == want.windows()
    assert len(got.windows()) == 5
    assert any(w["samples_capped"] for w in got.windows()) == (sample_cap == 8)
    for w in got.windows():
        assert rledger.validate_serve_window(w) == []


def test_window_emit_is_incremental_and_valid(tmp_path):
    p = str(tmp_path / "w.jsonl")
    agg = _feed(telemetry)
    first = agg.emit(p)
    assert len(first) == 5 and agg.emit(p) == []
    recs = [json.loads(line) for line in open(p)]
    assert [r["kind"] for r in recs] == ["serve:window"] * 5
    assert all(rledger.validate_serve_window(r["serve_window"]) == [] for r in recs)


def test_aggregator_rejects_bad_params():
    with pytest.raises(ValueError):
        telemetry.WindowAggregator(0.0)
    with pytest.raises(ValueError):
        telemetry.WindowAggregator(1.0, sample_cap=0)


def test_enable_telemetry_from_real_traffic(tmp_path):
    eng = _engine()
    agg = eng.enable_telemetry(window_s=60.0, sample_cap=64)
    assert eng.telemetry is agg and eng.stats.window is agg
    rng = np.random.default_rng(3)
    for _ in range(5):
        G = rng.standard_normal((8, 8))
        assert eng.solve("posv", G @ G.T + 8 * np.eye(8), rng.standard_normal((8, 1))).ok
    recs = agg.emit(str(tmp_path / "w.jsonl"))
    assert sum(r["serve_window"]["requests"] for r in recs) == 5
    assert sum(r["serve_window"]["batches"] for r in recs) >= 1
    assert all(rledger.validate_serve_window(r["serve_window"]) == [] for r in recs)
    assert all(r["serve_window"]["per_bucket"] for r in recs)


# ---- the closed loop against the JAX engine --------------------------------


@pytest.fixture(scope="module")
def closed_loops():
    reqs, specs = loadgen.build_requests(WL), loadgen.warmup_specs(WL)
    out = {}
    for sched in SCHEDULERS:
        for side, eng in (("jax", rengine.SolveEngine(cfg=rengine.ServeConfig(scheduler=sched, **LADDERS))),
                          ("torch", _engine(scheduler=sched))):
            eng.warmup(specs)
            tickets = []
            res = loadgen.run_closed_loop(eng, reqs, WL.concurrency, tickets=tickets)
            out[side, sched] = dict(res=res, responses=[t.result() for t in tickets],
                                    cache=eng.cache_stats())
    return reqs, out


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_closed_loop_matches_reference(closed_loops, sched):
    reqs, out = closed_loops
    ref, got = out["jax", sched], out["torch", sched]
    assert got["res"]["requests"] == got["res"]["ok"] == ref["res"]["ok"] == len(reqs)
    assert got["res"]["failed"] == 0 and got["res"]["qps"] > 0
    assert got["cache"]["misses"] == ref["cache"]["misses"] == 0
    assert got["cache"]["warmup_compiles"] == ref["cache"]["warmup_compiles"]
    for i, ((op, A, B), r, p) in enumerate(zip(reqs, ref["responses"], got["responses"])):
        assert (p.op, p.ok, p.bucket, p.batched) == (r.op, r.ok, r.bucket, r.batched), i
        want = np.asarray(r.x, dtype=np.float64)
        have = p.x.double().numpy()
        assert have.shape == want.shape
        assert np.abs(have - want).max() <= F32_TOL * np.abs(want).max(), (i, op)


def test_compare_records(tmp_path):
    p = str(tmp_path / "ab.jsonl")
    wl = dataclasses.replace(WL, requests=12)
    engines = {}
    res = loadgen.compare(ServeConfig(**LADDERS), wl, device=CPU, ledger_path=p, window_s=0.01,
                          trace=True, engines=engines)
    assert set(res) >= {"sync", "continuous", "speedup"}
    for mode, (eng, tickets) in engines.items():
        assert eng.cfg.scheduler == mode and len(tickets) == 12
        assert all(t.result().ok for t in tickets)
    recs = [json.loads(line) for line in open(p)]
    stats = [r for r in recs if r["kind"] == "serve:request_stats"]
    assert [r["loadgen"]["mode"] for r in stats] == ["sync", "continuous"]
    assert stats[1]["loadgen"]["baseline_qps"] == res["sync"]["qps"]
    assert stats[1]["loadgen"]["speedup"] == res["speedup"]
    for mode in SCHEDULERS:
        assert res[mode]["failed"] == 0 and res[mode]["cache"]["misses"] == 0
        assert res[mode]["window_records"] >= 1
        st = res[mode]["trace_record"]["serve_trace"]
        assert st["requests"] == st["complete"] == 12
    for r in recs:
        if r["kind"] == "serve:request_stats":
            assert rledger.validate_request_stats(r["request_stats"]) == []
        elif r["kind"] == "serve:window":
            assert rledger.validate_serve_window(r["serve_window"]) == []
        else:
            assert r["kind"] == "serve:trace"
            assert rledger.validate_serve_trace(r["serve_trace"]) == []


def test_mk_engine_takes_grid_or_device():
    cfg = ServeConfig(**LADDERS)
    assert loadgen._mk_engine(cfg, "sync", device=CPU).grid.device.type == "cpu"
    g = Grid.square(device=CPU)
    eng = loadgen._mk_engine(cfg, "continuous", grid=g)
    assert eng.grid is g and eng.cfg.scheduler == "continuous"


# ---- the CLI ------------------------------------------------------------------


def test_cli_smoke_cold_then_warm(tmp_path, capsys):
    d, led = str(tmp_path / "persist"), str(tmp_path / "l.jsonl")
    base = ["smoke", "--device", "cpu", "--trace", "--persist-dir", d, "--ledger", led,
            "--requests", "28"]
    assert cli.main(base) == 0
    assert cli.main(base + ["--max-compiles", "0"]) == 0
    out = capsys.readouterr().out
    assert out.count("# serve-smoke OK") == 2 and "0 unforeseen builds" in out
    recs = [json.loads(line) for line in open(led)]
    stats = [r["request_stats"] for r in recs if r["kind"] == "serve:request_stats"]
    assert len(stats) == 2 and all(rledger.validate_request_stats(s) == [] for s in stats)
    cold, warm = (s["cache"] for s in stats)
    assert cold["compiles"] == cold["disk"]["misses"] > 0 and cold["disk"]["hits"] == 0
    assert warm["compiles"] == 0 and warm["disk"]["hits"] == cold["compiles"]
    assert warm["misses"] == 0 and warm["disk"]["errors"] == warm["disk"]["skips"] == 0


def test_cli_smoke_warm_gate_fails_on_a_cold_dir(tmp_path, capsys):
    argv = ["smoke", "--device", "cpu", "--requests", "8", "--persist-dir", str(tmp_path),
            "--max-compiles", "0"]
    assert cli.main(argv) == 1
    assert "cold-start gate" in capsys.readouterr().err


def test_cli_loadgen(tmp_path, capsys):
    led = str(tmp_path / "l.jsonl")
    argv = ["loadgen", "--device", "cpu", "--requests", "24", "--window-s", "0.01",
            "--min-windows", "2", "--trace", "--ledger", led]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "# serve-loadgen OK" in out and "continuous/sync speedup" in out
    kinds = [json.loads(line)["kind"] for line in open(led)]
    assert kinds.count("serve:request_stats") == 2 and kinds.count("serve:trace") == 2


def test_cli_loadgen_min_windows_needs_window_s(capsys):
    assert cli.main(["loadgen", "--device", "cpu", "--requests", "8", "--min-windows", "1"]) == 1
    assert "--min-windows requires --window-s" in capsys.readouterr().err


def test_cli_replicas_kill_and_drain(tmp_path, capsys):
    argv = ["replicas", "--device", "cpu", "--replica-mode", "thread", "--kill-one",
            "--drain-one", "--requests", "32", "--persist-dir", str(tmp_path),
            "--guaranteed-share", "0.25", "--ledger", str(tmp_path / "l.jsonl")]
    assert cli.main(argv) == 0
    assert cli.main(argv + ["--max-compiles", "0"]) == 0
    out = capsys.readouterr().out
    assert out.count("# serve-replicas OK") == 2
    assert out.count("replacement r2 warmup unforeseen builds {'r2': 0}") == 2


def test_cli_parser_device_choices():
    p = cli.build_parser()
    assert p.parse_args(["smoke"]).device == "cuda"
    for cmd in ("smoke", "loadgen", "replicas"):
        assert p.parse_args([cmd, "--device", "cpu"]).device == "cpu"
        with pytest.raises(SystemExit):
            p.parse_args([cmd, "--device", "tpu"])


def test_guaranteed_share_spaces_posv_evenly():
    work = [("posv", None, None)] * 8 + [("lstsq", None, None)] * 3
    assert cli._tiers(work, 0.25).count("guaranteed") == 2
    assert cli._tiers(work, 0.0) == ["balanced"] * 11
    assert cli._tiers(work, 1.0)[:8] == ["guaranteed"] * 8
    with pytest.raises(ValueError):
        cli._tiers(work, 1.5)


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 5e-2), ("float32", 5e-5), ("float64", 1e-13),
                                       (torch.float32, 5e-5), (np.dtype("float64"), 1e-13)])
def test_tolerance_is_the_drivers(dtype, tol):
    assert cli._tolerance(dtype) == tol


# ---- the persistent tier ------------------------------------------------------

SPEC_X = ("posv", (8, 8), (8, 1), "float32")
SPEC_Y = ("lstsq", (40, 12), (40, 4), "float32")


def _spd(rng, n):
    G = rng.standard_normal((n, n)).astype(np.float32)
    return G @ G.T + n * np.eye(n, dtype=np.float32)


def test_warm_dir_builds_peers_programs(tmp_path):
    """An engine that warms nothing on a warm directory still builds
    every program its peers built there, and serves them with no build."""
    a = _engine(persist_dir=str(tmp_path))
    assert a.warmup([SPEC_X, SPEC_Y]) == 2
    assert a.cache_stats()["disk"] == dict(hits=0, misses=2, errors=0, skips=0, races=0)
    b = _engine(persist_dir=str(tmp_path), scheduler="sync")  # scheduler is not in the scope
    assert b.warmup([]) == 0
    rng = np.random.default_rng(0)
    assert b.solve("posv", _spd(rng, 7), rng.standard_normal((7, 1)).astype(np.float32)).ok
    assert b.solve("lstsq", rng.standard_normal((40, 10)).astype(np.float32),
                   rng.standard_normal((40, 3)).astype(np.float32)).ok
    st = b.cache_stats()
    assert st["misses"] == st["compiles"] == st["warmup_compiles"] == 0 and st["hits"] == 2
    assert st["disk"]["hits"] == 2 and st["entries"] == 2


def test_other_scope_and_stale_and_corrupt_lines(tmp_path):
    a = _engine(persist_dir=str(tmp_path))
    a.warmup([SPEC_X])
    path = os.path.join(str(tmp_path), cache_mod.MANIFEST)
    line = json.loads(open(path).read())
    stale = dict(line, fingerprint=dict(line["fingerprint"], kernels="0" * 16))
    with open(path, "a") as f:
        f.write(json.dumps(stale) + "\n")
        f.write("{not json\n")
        f.write(json.dumps({"key": 1}) + "\n")
    other = _engine(persist_dir=str(tmp_path), buckets=(8, 32))  # another config hash
    assert other.warmup([]) == 0 and other.cache_stats()["entries"] == 0
    assert other.cache_stats()["disk"] == dict(hits=0, misses=0, errors=2, skips=0, races=0)
    b = _engine(persist_dir=str(tmp_path))
    assert b.warmup([]) == 0
    assert b.cache_stats()["entries"] == 1
    assert b.cache_stats()["disk"] == dict(hits=1, misses=0, errors=2, skips=1, races=0)
    b.warmup([])  # a second read counts no line twice
    assert b.cache_stats()["disk"] == dict(hits=1, misses=0, errors=2, skips=1, races=0)


def test_lost_append_race_counts_race(tmp_path):
    a = _engine(persist_dir=str(tmp_path))
    b = _engine(persist_dir=str(tmp_path))
    b.cache.refresh()  # b read the manifest before a's first build ...
    a.warmup([SPEC_X])
    key = next(iter(a.cache._mem))
    b.cache._store(key, {"kind": "batch", "bucket": list(key[1])})  # ... and appends after it
    assert b.cache.disk_races == 1 and b.cache.disk_errors == 0
    assert len(open(os.path.join(str(tmp_path), cache_mod.MANIFEST)).readlines()) == 1


def test_unwritable_dir_is_an_error_not_a_raise(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    eng = _engine(persist_dir=str(blocker / "sub"))
    assert eng.warmup([SPEC_X]) == 1
    assert eng.cache_stats()["disk"]["errors"] == 2  # the unreadable manifest, the append
    rng = np.random.default_rng(1)
    assert eng.solve("posv", _spd(rng, 8), rng.standard_normal((8, 1)).astype(np.float32)).ok


def test_oversize_single_rides_the_manifest(tmp_path):
    a = _engine(persist_dir=str(tmp_path))
    assert a.warmup([("posv", (20, 20), (20, 1), "float32")]) == 1
    b = _engine(persist_dir=str(tmp_path))
    b.warmup([])
    rng = np.random.default_rng(2)
    r = b.solve("posv", _spd(rng, 20), rng.standard_normal((20, 1)).astype(np.float32))
    assert r.ok and not r.batched
    assert b.cache_stats()["misses"] == 0 and b.cache_stats()["compiles"] == 0


def test_fingerprint_names_runtime_card_and_sources():
    fp = cache_mod.fingerprint(torch.device("cpu"))
    assert fp["platform"] == "cpu" and fp["device"] == "cpu" and fp["torch"] == torch.__version__
    assert len(fp["kernels"]) == 16 and fp["entry_version"] == cache_mod.ENTRY_VERSION


def test_memory_only_cache_has_no_disk_block():
    st = _engine().cache_stats()
    assert "disk" not in st and set(st) == {"hits", "misses", "warmup_compiles", "compiles",
                                            "entries", "hit_rate"}
