"""The port's obs layer (capital_tpu_torch/obs: the ledger's validators,
`diff` and the CLI) held against the JAX package's (capital_tpu/obs).

One shared corpus: the records of one in-process `python -m
capital_tpu_torch.serve smoke --device cpu --trace` run and one small
windowed, traced `loadgen` run, the smoke's request_stats widened with a
real FactorCache block and with refine / replica blocks, plus synthetic
bench:*, lint:report, phase_seconds and session_stats blocks.  Every
validator of both packages reads the corpus and its seeded mutations
(a key dropped, a type swapped, percentiles out of order, a count off by
one, NaN or inf in a number) and must return the identical problem list;
`diff` must return identical regressions and raise identical messages;
each CLI command must give the same exit code and the same report lines
once the package name is normalised.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import math

import pytest

from capital_tpu.obs import __main__ as ref_cli
from capital_tpu.obs import ledger as ref_ledger
from capital_tpu_torch.obs import __main__ as port_cli
from capital_tpu_torch.obs import ledger as port_ledger

VALIDATORS = ("validate_request_stats", "validate_lint_report", "validate_phase_seconds",
              "validate_blocktri_measured", "validate_arrowhead_measured",
              "validate_update_measured", "validate_refine_measured", "validate_serve_trace",
              "validate_serve_window", "validate_session_stats")

PCTS = {"p50": 1.0, "p95": 2.0, "p99": 3.0}


def _bench(metric: str, **fields) -> dict:
    return {"metric": metric, "value": 10.0, "unit": "TFLOP/s", **fields}


BENCH = {
    "validate_blocktri_measured": [
        _bench("blocktri_tflops", nblocks=4, block=32, n=128, batch=2, nrhs=4, impl="pallas",
               speedup=1.5, wall_ms=dict(PCTS), partitions=2, depth=8, depth_seq=32,
               depth_reduction=4.0),
        _bench("blocktri_latency", nblocks=8, block=16, n=128, batch=1, nrhs=1, impl="xla"),
    ],
    "validate_arrowhead_measured": [
        _bench("arrowhead_tflops", nblocks=4, block=32, border=8, n=136, batch=2, nrhs=4,
               impl="auto", speedup=12.0, arrow_ms=0.5, dense_ms=6.0, factor_resid=1e-7,
               solve_resid=2e-7, wall_ms=dict(PCTS)),
    ],
    "validate_update_measured": [
        _bench("update_speedup", n=256, k=8, batch=4, impl="pallas", speedup=20.0,
               refactor_ms=4.0, update_ms=0.2, wall_ms=dict(PCTS),
               serve_smoke={"requests": 50, "recompiles": 0, "hit_rate": 1.0}),
    ],
    "validate_refine_measured": [
        _bench("refine_speedup", n=512, nrhs=4, batch=8, factor_dtype="float32",
               correction_dtype="float64", speedup=1.8, refined_ms=2.0, baseline_ms=3.6,
               resid_ratio=1.1, iters=3, tsqr_ortho=1e-12, wall_ms=dict(PCTS),
               serve_smoke={"requests": 20, "recompiles": 0}),
    ],
    "validate_phase_seconds": [
        _bench("cholinv_trace", n=4096, phase_seconds={"CI::trsm": 0.01, "CI::tmu": 0.02,
                                                        "CI::inv": 0.015},
               bubble_frac=0.12),
        _bench("cacqr_trace", n=1024, phase_seconds={"CQR::gram": 0.004}),
    ],
}


def _lint_block(ok: bool) -> dict:
    from capital_tpu_torch.lint import rules

    findings = [rules.make("broad-except", rules.ERROR, "pkg/a.py", "caught and dropped", line=3),
                rules.make("compute-outside-scope", rules.WARN, "pkg/ops/b.py", "`@` outside",
                           line=9)]
    rep = rules.Report(pass_name="source", fresh=findings if not ok else findings[1:],
                       suppressed=findings[:1] if ok else [], baseline_path=None)
    return rep.block("error")


SESSION = {"schema_version": 1, "opens": 5, "reseeds": 1, "appends": 12, "solves": 9,
           "contracts": 4, "closes": 3, "failures": 2, "evicted_failures": 2, "hits": 25,
           "misses": 2, "hit_rate": 25 / 27, "sessions_open": 2, "sessions_known": 4,
           "blocks_appended": 40, "blocks_dropped": 16}


def _factor_cache_block() -> dict:
    """A real FactorCache's counter block after installs, hits, a miss and
    evictions under its byte budget."""
    import torch

    from capital_tpu_torch.serve.factorcache import FactorCache

    blk = torch.zeros((2, 8, 8))
    fc = FactorCache(budget_bytes=3 * blk.numel() * blk.element_size(), device="cpu")
    for i in range(5):
        fc.put(f"t{i}", "dense", (blk,), {})
        fc.lookup(f"t{i}")
    fc.lookup("t0")
    return fc.stats()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(records by validator, ledger paths) — the shared corpus."""
    from capital_tpu_torch.serve import __main__ as serve_cli

    d = tmp_path_factory.mktemp("obs")
    serve = str(d / "serve.jsonl")
    with contextlib.redirect_stdout(io.StringIO()):
        assert serve_cli.main(["smoke", "--device", "cpu", "--trace", "--requests", "24",
                               "--ledger", serve]) == 0
        assert serve_cli.main(["loadgen", "--device", "cpu", "--requests", "32", "--concurrency",
                               "4", "--window-s", "0.05", "--trace", "--deadline-ms", "60000",
                               "--ledger", serve]) == 0
    recs = port_ledger.read(serve)
    stats = [r for r in recs if r.get("request_stats") is not None]
    traces = [r for r in recs if r.get("serve_trace") is not None]
    windows = [r for r in recs if r.get("serve_window") is not None]
    assert len(stats) == 3 and len(traces) == 3 and windows
    # the smoke's block widened with a real factor_cache block, a refine
    # block and the router's replica tags
    wide = copy.deepcopy(stats[0]["request_stats"])
    wide["factor_cache"] = _factor_cache_block()
    wide["refine"] = {"requests": 6, "converged": 5, "nonconverged": 1, "converged_frac": 5 / 6,
                      "iters_max": 3, "iters": dict(PCTS), "resid_max": 2e-15}
    wide.update(replica_id="r0", replicas=2, replica_ids=["r0", "r1"])
    blocks = {
        "validate_request_stats": [r["request_stats"] for r in stats] + [wide],
        "validate_lint_report": [_lint_block(True), _lint_block(False)],
        # the first traces of each record (the mutations copy the block once
        # a leaf); the whole records stand in the `valid` case
        "validate_serve_trace": [_head(r["serve_trace"], 3) for r in traces],
        "validate_serve_window": [r["serve_window"] for r in windows[:4]],
        "validate_session_stats": [dict(SESSION)],
        **BENCH,
    }
    return dict(blocks=blocks, serve=serve, records=recs, wide=wide, dir=d,
                whole_traces=[r["serve_trace"] for r in traces])


def _head(st: dict, k: int) -> dict:
    """A serve_trace block cut to its first `k` traces, its counts recounted."""
    from capital_tpu_torch.obs import spans

    traces = st["traces"][:k]
    return dict(st, traces=traces, requests=len(traces),
                complete=sum(not spans.trace_dict_problems(t, st["bubble_tol_ms"]) for t in traces),
                violations=sum(bool(t.get("violated")) for t in traces))


# ---- the validators ---------------------------------------------------------------


def _paths(obj, path=()):
    """Every (path, leaf) of a nested dict / list."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _paths(v, path + (k,))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from _paths(v, path + (i,))
    else:
        yield path, obj


def _set(obj, path, value):
    out = copy.deepcopy(obj)
    cur = out
    for k in path[:-1]:
        cur = cur[k]
    cur[path[-1]] = value
    return out


def _pct_dicts(obj, path=()):
    if isinstance(obj, dict):
        if all(p in obj for p in PCTS):
            yield path
        for k, v in obj.items():
            yield from _pct_dicts(v, path + (k,))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from _pct_dicts(v, path + (i,))


def _mutations(kind: str, block):
    """Seeded mutations of one block (all of one kind)."""
    if kind == "valid":
        yield block
    elif kind == "drop_key":
        for path, _ in list(_paths(block)):
            parent = copy.deepcopy(block)
            cur = parent
            for k in path[:-1]:
                cur = cur[k]
            if isinstance(cur, dict):
                del cur[path[-1]]
                yield parent
        for key in block:
            yield {k: v for k, v in block.items() if k != key}
    elif kind == "swap_type":
        for path, leaf in _paths(block):
            yield _set(block, path, "7" if not isinstance(leaf, str) else 7)
            if isinstance(leaf, int) and not isinstance(leaf, bool):
                yield _set(block, path, bool(leaf))
        for key in block:
            yield _set(block, (key,), [])
        yield [block]
    elif kind == "pct_order":
        for path in _pct_dicts(block):
            cur = block
            for k in path:
                cur = cur[k]
            yield _set(block, path + ("p50",), cur["p99"] + 1.0)
            yield _set(block, path + ("p95",), -1.0)
    elif kind == "count_off":
        for path, leaf in _paths(block):
            if isinstance(leaf, int) and not isinstance(leaf, bool):
                yield _set(block, path, leaf + 1)
                yield _set(block, path, leaf - 1)
    elif kind == "nonfinite":
        for path, leaf in _paths(block):
            if isinstance(leaf, (int, float)) and not isinstance(leaf, bool):
                for v in (math.nan, math.inf, -math.inf):
                    yield _set(block, path, v)


MUTATIONS = ("valid", "drop_key", "swap_type", "pct_order", "count_off", "nonfinite")


@pytest.mark.parametrize("kind", MUTATIONS)
@pytest.mark.parametrize("name", VALIDATORS)
def test_validator_parity(corpus, name, kind):
    ref, port = getattr(ref_ledger, name), getattr(port_ledger, name)
    n = flagged = 0
    for block in corpus["blocks"][name]:
        for m in _mutations(kind, block):
            got, want = port(m), ref(m)
            assert got == want, (name, kind, m)
            n += 1
            flagged += bool(got)
    if kind == "valid":
        assert n and not flagged, "the corpus itself must validate"
        if name == "validate_serve_trace":
            for st in corpus["whole_traces"]:
                assert port(st) == ref(st) == []
    elif kind in ("drop_key", "swap_type", "nonfinite"):
        assert flagged, f"{name}: no {kind} mutation was flagged"


def test_validators_flag_their_invariants(corpus):
    """The coherence checks fire on the real records: a window whose split
    does not add up, a trace whose recount disagrees, a stats block whose
    percentiles are out of order in a window."""
    w = corpus["blocks"]["validate_serve_window"][0]
    assert any("!= requests" in p for p in port_ledger.validate_serve_window(
        _set(w, ("ok",), w["ok"] + 1)))
    t = corpus["blocks"]["validate_serve_trace"][0]
    assert port_ledger.validate_serve_trace(_set(t, ("complete",), t["complete"] + 1))
    assert any("percentiles out of order" in p for p in port_ledger.validate_serve_window(
        _set(w, ("latency_ms", "p50"), w["latency_ms"]["p99"] + 1)))
    fc = corpus["wide"]["factor_cache"]
    assert fc["evictions"] > 0 and fc["entry_bytes"]
    assert not port_ledger.validate_request_stats(corpus["wide"])


# ---- diff ---------------------------------------------------------------------------


def _rec(value: float, **extra) -> dict:
    man = {"schema_version": 1, "platform": "gpu", "device": "NVIDIA H100 80GB HBM3",
           "dtype": "bfloat16", "grid": "g1", "config_id": "c"}
    return {"record": "capital_tpu.ledger", "kind": "bench:cholinv", "manifest": man,
            "measured": {"metric": "cholinv", "value": value, "unit": "TFLOP/s", "n": 4096},
            "audit": None, **extra}


def _tuples(regs):
    return [dataclasses.astuple(r) for r in regs]


def _diff_both(a, b, **kw):
    out = []
    for mod in (ref_ledger, port_ledger):
        try:
            out.append(("ok", _tuples(mod.diff(copy.deepcopy(a), copy.deepcopy(b), **kw))))
        except mod.LedgerIncompatible as e:
            out.append(("incompatible", str(e)))
    return out


def _diff_cases(corpus):
    recov = _rec(40.0, robust={"breakdown": 1, "shifted": 1, "escalated": 1, "info": 0},
                 event={"status": "recovered"})
    audited = _rec(100.0, audit={"collective_counts": {"all-reduce": 4}, "peak_hbm_bytes": 1000})
    grown = _rec(100.0, audit={"collective_counts": {"all-reduce": 6}, "peak_hbm_bytes": 1100})
    other_schema = _rec(100.0)
    other_schema["manifest"]["schema_version"] = 2
    other_device = _rec(100.0)
    other_device["manifest"]["device"] = "cpu"
    bad_stats = copy.deepcopy(corpus["records"][0])
    bad_stats["request_stats"]["latency_ms"]["p99"] = "slow"
    bad_window = next(copy.deepcopy(r) for r in corpus["records"] if r.get("serve_window"))
    bad_window["serve_window"]["ok"] += 1
    bad_bench = _rec(100.0)
    bad_bench["measured"].update(metric="blocktri_tflops", nblocks=0)
    legacy_a = {"schema_version": 1, "device": "x", "measured": {"metric": "m", "value": 5.0}}
    legacy_b = {"schema_version": 1, "device": "x", "measured": {"metric": "m", "value": 1.0}}
    return {
        "self": (corpus["records"], corpus["records"]),
        "robust_exempt": ([_rec(100.0)], [recov]),
        "drop_60pct": ([_rec(100.0)], [{k: v for k, v in recov.items()
                                         if k not in ("robust", "event")}]),
        "within_tol": ([_rec(100.0)], [_rec(95.0)]),
        "audit_growth": ([audited], [grown]),
        "schema_mismatch": ([_rec(100.0)], [other_schema]),
        "device_mismatch": ([_rec(100.0)], [other_device]),
        "malformed_request_stats": (corpus["records"], [bad_stats]),
        "malformed_window": ([bad_window], []),
        "malformed_bench": ([bad_bench], [_rec(1.0)]),
        "legacy_lines": ([legacy_a], [legacy_b]),
    }


DIFF_CASES = ("self", "robust_exempt", "drop_60pct", "within_tol", "audit_growth",
              "schema_mismatch", "device_mismatch", "malformed_request_stats",
              "malformed_window", "malformed_bench", "legacy_lines")
DIFF_EXPECT = {"self": "ok", "robust_exempt": "ok", "within_tol": "ok", "drop_60pct": "ok",
               "audit_growth": "ok", "legacy_lines": "ok"}


@pytest.mark.parametrize("case", DIFF_CASES)
def test_diff_parity(corpus, case):
    a, b = _diff_cases(corpus)[case]
    (rk, rv), (pk, pv) = _diff_both(a, b)
    assert (pk, pv) == (rk, rv)
    assert pk == DIFF_EXPECT.get(case, "incompatible")
    if case == "drop_60pct":
        assert [r[1] for r in pv] == ["measured.value"]
    if case == "audit_growth":
        assert sorted(r[1] for r in pv) == ["collectives.all-reduce", "peak_hbm_bytes"]
    if case in ("self", "robust_exempt", "within_tol"):
        assert pv == []


def test_diff_tolerances_parity():
    a, b = [_rec(100.0)], [_rec(85.0)]
    for tol in (0.1, 0.2):
        (rk, rv), (pk, pv) = _diff_both(a, b, tol_metric=tol)
        assert (pk, pv) == (rk, rv)
    assert _diff_both(a, b, tol_metric=0.1)[1][1] and not _diff_both(a, b, tol_metric=0.2)[1][1]


# ---- the CLI --------------------------------------------------------------------------


def _run(cli, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    norm = lambda s: s.getvalue().replace("capital_tpu_torch", "capital_tpu").splitlines()  # noqa: E731
    return rc, norm(out), norm(err)


def _write(path, recs):
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def ledgers(corpus):
    d = corpus["dir"]
    recs = corpus["records"]
    wide1 = copy.deepcopy(corpus["wide"])
    wide2 = copy.deepcopy(corpus["wide"])
    wide2.update(replica_id="r1")
    wide2["cache"]["hit_rate"] = 0.5
    tagged = [dict(recs[0], request_stats=wide1), dict(recs[0], request_stats=wide2),
              dict(recs[0], request_stats=None, router={"qps": 12.5})]
    sess = dict(recs[0], kind="serve:session_stats", request_stats=None,
                session_stats=dict(SESSION))
    bad = copy.deepcopy(recs[1])
    bad["serve_trace"]["requests"] = -1
    lint_ok = dict(recs[0], kind="lint:report", request_stats=None,
                   lint_report=_lint_block(True))
    lint_bad = dict(lint_ok, lint_report=_lint_block(False))
    lint_malformed = dict(lint_ok, lint_report={**_lint_block(True), "pass": "nope"})
    trace_recs = [{"kind": "bench:trace:cholinv", "manifest": recs[0]["manifest"], "measured": m}
                  for m in BENCH["validate_phase_seconds"]]
    bad_trace = copy.deepcopy(trace_recs[0])
    bad_trace["measured"]["bubble_frac"] = 1.5
    return {
        "serve": corpus["serve"],
        "full": _write(d / "full.jsonl", recs + tagged + [sess]),
        "empty": _write(d / "empty.jsonl", [trace_recs[0]]),
        "malformed": _write(d / "malformed.jsonl", [bad]),
        "lint": _write(d / "lint.jsonl", [lint_ok, lint_bad]),
        "lint_ok": _write(d / "lint_ok.jsonl", [lint_ok]),
        "lint_malformed": _write(d / "lint_malformed.jsonl", [lint_malformed]),
        "trace": _write(d / "trace.jsonl", trace_recs),
        "trace_malformed": _write(d / "trace_malformed.jsonl", [bad_trace]),
        "bench_a": _write(d / "bench_a.jsonl", [_rec(100.0)]),
        "bench_b": _write(d / "bench_b.jsonl", [_rec(40.0)]),
        "bench_cpu": _write(d / "bench_cpu.jsonl", [_rec(100.0, manifest={
            **_rec(0.0)["manifest"], "device": "cpu"})]),
    }


CLI_CASES = {
    # (argv with ledger names in braces, exit code)
    "diff_self": (["diff", "{full}", "{full}"], 0),
    "diff_regression": (["diff", "{bench_a}", "{bench_b}"], 1),
    "diff_tol": (["diff", "{bench_a}", "{bench_b}", "--tol-metric", "0.7"], 0),
    "diff_incomparable": (["diff", "{bench_a}", "{bench_cpu}"], 2),
    "diff_malformed": (["diff", "{malformed}", "{full}"], 2),
    "robust_gate": (["robust-gate"], 0),
    "serve_plain": (["serve-report", "{serve}"], 0),
    "serve_full": (["serve-report", "{full}"], 0),
    "serve_no_records": (["serve-report", "{empty}"], 0),
    "serve_no_records_gated": (["serve-report", "{empty}", "--min-hit-rate", "1.0"], 1),
    "serve_malformed": (["serve-report", "{malformed}"], 2),
    "hit_rate_pass": (["serve-report", "{serve}", "--min-hit-rate", "0.0"], 0),
    "hit_rate_fail": (["serve-report", "{serve}", "--min-hit-rate", "1.01"], 1),
    "p99_pass": (["serve-report", "{serve}", "--max-p99-ms", "1e9"], 0),
    "p99_fail": (["serve-report", "{serve}", "--max-p99-ms", "0.001"], 1),
    "p99_small_pass": (["serve-report", "{serve}", "--max-p99-ms-small", "1e9"], 0),
    "p99_small_fail": (["serve-report", "{serve}", "--max-p99-ms-small", "0.001"], 1),
    "occupancy_pass": (["serve-report", "{serve}", "--min-occupancy", "0.0"], 0),
    "occupancy_fail": (["serve-report", "{serve}", "--min-occupancy", "1.01"], 1),
    "queue_wait_pass": (["serve-report", "{serve}", "--max-queue-wait-ms", "1e9"], 0),
    "queue_wait_fail": (["serve-report", "{serve}", "--max-queue-wait-ms", "0.0"], 1),
    "residency_pass": (["serve-report", "{full}", "--min-residency-hit-rate", "0.0"], 0),
    "residency_fail": (["serve-report", "{full}", "--min-residency-hit-rate", "1.0"], 1),
    "residency_absent": (["serve-report", "{serve}", "--min-residency-hit-rate", "0.0"], 1),
    "refine_pass": (["serve-report", "{full}", "--max-refine-iters", "3",
                     "--min-converged-frac", "0.5"], 0),
    "refine_fail": (["serve-report", "{full}", "--max-refine-iters", "2",
                     "--min-converged-frac", "0.9"], 1),
    "refine_absent": (["serve-report", "{serve}", "--max-refine-iters", "9"], 1),
    "aggregate_pass": (["serve-report", "{full}", "--aggregate", "--min-replicas", "2"], 0),
    "aggregate_fail": (["serve-report", "{full}", "--aggregate", "--min-replicas", "3",
                        "--min-hit-rate", "0.9"], 1),
    "aggregate_untagged": (["serve-report", "{serve}", "--aggregate"], 1),
    "trace_complete_pass": (["serve-report", "{serve}", "--min-trace-complete", "1.0"], 0),
    "trace_complete_absent": (["serve-report", "{bench_a}", "--min-trace-complete", "1.0"], 1),
    "windows_pass": (["serve-report", "{serve}", "--min-windows", "1"], 0),
    "windows_fail": (["serve-report", "{serve}", "--min-windows", "100000"], 1),
    "session_pass": (["serve-report", "{full}", "--min-session-hit-rate", "0.9",
                      "--max-reseeds", "1"], 0),
    "session_fail": (["serve-report", "{full}", "--min-session-hit-rate", "0.99",
                      "--max-reseeds", "0"], 1),
    "session_absent": (["serve-report", "{serve}", "--max-reseeds", "5"], 1),
    "lint_report": (["lint-report", "{lint}"], 1),
    "lint_report_ok": (["lint-report", "{lint_ok}", "--require-pass", "source"], 0),
    "lint_report_missing_pass": (["lint-report", "{lint_ok}", "--require-pass",
                                  "concurrency"], 1),
    "lint_report_none": (["lint-report", "{serve}"], 0),
    "lint_report_malformed": (["lint-report", "{lint_malformed}"], 2),
    "trace_report": (["trace-report", "{trace}"], 0),
    "trace_report_gate_pass": (["trace-report", "{trace}", "--max-bubble-frac", "0.5"], 1),
    "trace_report_gate_fail": (["trace-report", "{trace}", "--max-bubble-frac", "0.05"], 1),
    "trace_report_none_gated": (["trace-report", "{serve}", "--max-bubble-frac", "0.5"], 1),
    "trace_report_malformed": (["trace-report", "{trace_malformed}"], 2),
    "timeline": (["timeline", "{serve}", "--top", "2"], 0),
    "timeline_none": (["timeline", "{bench_a}"], 1),
    "timeline_malformed": (["timeline", "{malformed}"], 2),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_parity(ledgers, case):
    argv, rc = CLI_CASES[case]
    argv = [a.format(**ledgers) for a in argv]
    ref, port = _run(ref_cli, argv), _run(port_cli, argv)
    assert port == ref
    assert port[0] == rc, port


def test_timeline_chrome_parity(ledgers, corpus):
    path = str(corpus["dir"] / "chrome.json")
    argv = ["timeline", ledgers["serve"], "--chrome", path]
    ref = _run(ref_cli, argv)
    with open(path) as f:
        ref_json = json.load(f)
    port = _run(port_cli, argv)
    with open(path) as f:
        port_json = json.load(f)
    assert port == ref and port[0] == 0
    assert port_json == ref_json
    # one complete chain per traced request: the export holds every span of
    # every traced request, in order, and each chain is complete
    traces = [t for r in port_ledger.read(ledgers["serve"]) if r.get("serve_trace")
              for t in r["serve_trace"]["traces"]]
    from capital_tpu_torch.obs import spans

    assert traces and not [p for t in traces for p in spans.trace_dict_problems(t)]
    events = [(e["name"], e["tid"]) for e in port_json["traceEvents"] if e["ph"] == "X"]
    assert events == [(sp["name"], t["request_id"]) for t in traces for sp in t["spans"]]


def test_cli_argument_errors_exit_2():
    for cli in (ref_cli, port_cli):
        with pytest.raises(SystemExit) as e, contextlib.redirect_stderr(io.StringIO()):
            cli.main(["serve-report"])
        assert e.value.code == 2
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        port_cli.main(["audit", "cholinv"])  # no XLA program to audit in the port
