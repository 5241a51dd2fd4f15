"""The port's lint (capital_tpu_torch/lint) held against the JAX package's
(capital_tpu/lint), and the port's own tree held clean by it.

* the source lint: the same bare-except / broad-except /
  unregistered-phase-tag findings on the same fixture sources, and the
  port's torch-aimed compute-outside-scope and host-only-dispatch rules;
* the concurrency static pass: the same findings on both packages'
  serve/ trees, and none on the port's;
* the interleaving explorer: every scenario holds every invariant over
  seeded schedules on the port's Router / FactorCache, the self-check
  flags the committed broken fixture on both layers, and a schedule
  replays from its seed;
* the invariant registry, the baseline round trip, and a lint:report
  record that ``obs lint-report`` reads.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import os
from pathlib import Path

import pytest

from capital_tpu.lint import concurrency as ref_concurrency
from capital_tpu.lint import invariants as ref_invariants
from capital_tpu.lint import source as ref_source
from capital_tpu_torch.lint import __main__ as lint_cli
from capital_tpu_torch.lint import baseline, concurrency, invariants, rules, schedule, source

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _at_root(monkeypatch):
    # findings name paths relative to the working directory
    monkeypatch.chdir(ROOT)


def _tuples(findings):
    return sorted(dataclasses.astuple(f) for f in findings)


def _run(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = lint_cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


# ---- the source lint ---------------------------------------------------------------

FIXTURES = {
    "bare": "try:\n    f()\nexcept:\n    pass\n",
    "broad_dropped": "try:\n    f()\nexcept Exception:\n    x = 1\n",
    "broad_base": "try:\n    f()\nexcept BaseException as e:\n    y = e\n",
    "broad_reraised": "try:\n    f()\nexcept Exception:\n    cleanup()\n    raise\n",
    "broad_logged": "try:\n    f()\nexcept Exception as e:\n    log.warning('x %s', e)\n",
    "broad_suppressed": "try:\n    f()\nexcept Exception:  # lint: allow-broad-except — why\n    pass\n",
    "broad_noqa": "try:\n    f()\nexcept Exception:  # noqa: BLE001\n    pass\n",
    "narrow": "try:\n    f()\nexcept (OSError, ValueError):\n    pass\n",
    "nested": ("def g():\n    try:\n        f()\n    except:\n        try:\n            h()\n"
               "        except Exception:\n            pass\n"),
    "tags": ("with tracing.scope('CI::trsm'):\n    pass\n"
             "with scope('not::registered'):\n    pass\n"
             "x = faultinject.tap(a, point='bogus::point')\n"
             "y = tap(a, 'serve::ingest')\n"
             "z = tap(a, 'bogus::positional')\n"),
}
COMPARED = {source.BARE_EXCEPT, source.BROAD_EXCEPT, source.UNREGISTERED_PHASE_TAG}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_source_rules_match_reference(name):
    path = os.path.join("pkg", "serve", f"{name}.py")
    text = FIXTURES[name]
    port = [f for f in source.lint_source(path, text) if f.rule in COMPARED]
    ref = [f for f in ref_source.lint_source(path, text) if f.rule in COMPARED]
    assert _tuples(port) == _tuples(ref)
    flagged = name in ("bare", "broad_dropped", "broad_base", "nested", "tags")
    assert bool(port) == flagged, port


def test_port_registry_is_the_tracing_literal():
    import capital_tpu_torch.utils.tracing as tracing

    assert source.phase_registry() == frozenset(tracing.PHASE_REGISTRY)


COMPUTE = (
    "import torch\n"
    "def f(a, b, L):\n"
    "    c = a @ b\n"
    "    d = torch.matmul(a, b)\n"
    "    e = torch.linalg.solve_triangular(L, b, upper=False)\n"
    "    g = torch.cholesky_solve(b, L)\n"
    "    h = torch.bmm(a, b) + torch.addmm(c, a, b)\n"
    "    i = a.add(b)\n"
    "    with tracing.scope('CI::tmu'):\n"
    "        j = torch.mm(a, b) @ b\n"
    "    return torch.einsum('ij,jk->ik', a, b)  # noqa\n"
)


def test_compute_outside_scope_aims_at_torch():
    got = [(f.line, f.message.split("`")[1])
           for f in source.lint_source(os.path.join("pkg", "ops", "k.py"), COMPUTE)]
    assert got == [(3, "@"), (4, "torch.matmul"), (5, "torch.linalg.solve_triangular"),
                   (6, "torch.cholesky_solve"), (7, "torch.bmm"), (7, "torch.addmm")]
    assert all(f.severity == rules.WARN for f in source.lint_source("pkg/ops/k.py", COMPUTE))
    assert source.lint_source(os.path.join("pkg", "serve", "k.py"), COMPUTE) == []


@pytest.mark.parametrize("path,flagged", [
    ("pkg/serve/router.py", True), ("pkg/serve/loadgen.py", True),
    ("pkg/serve/telemetry.py", True), ("pkg/serve/replica.py", True),
    ("pkg/obs/ledger.py", True), ("pkg/lint/schedule.py", True),
    ("pkg/serve/engine.py", False), ("pkg/models/obs_like.py", False),
])
def test_host_only_dispatch(path, flagged):
    text = ("import numpy as np\nfrom torch import nn\nimport triton.language as tl\n"
            "def f():\n    import torch\n    return torch\n")
    got = [f.line for f in source.lint_source(path, text) if f.rule == source.HOST_ONLY_DISPATCH]
    assert got == ([2, 3] if flagged else [])


def test_port_tree_is_clean_against_its_baseline():
    rc, out, _ = _run(["source", "capital_tpu_torch", "--fail-on", "warn"])
    assert rc == 0, out
    assert "0 error(s), 0 warn(s)" in out
    # the suppressed debt still exists, and is warn-only
    full = source.lint_tree("capital_tpu_torch")
    assert full and {f.rule for f in full} == {source.COMPUTE_OUTSIDE_SCOPE}
    fresh, suppressed = baseline.apply(full, baseline.load(baseline.DEFAULT_PATH))
    assert not fresh and len(suppressed) == len(full)


def test_baseline_lines_carry_reasons():
    import json

    with open(baseline.DEFAULT_PATH) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    assert recs and all(r.get("reason") for r in recs)


def test_baseline_round_trip(tmp_path):
    path = str(tmp_path / "bl.jsonl")
    text = "try:\n    f()\nexcept:\n    pass\n"
    findings = source.lint_source("pkg/a.py", text)
    assert baseline.write(path, findings) == 1
    assert baseline.load(path) == {findings[0].fingerprint}
    with open(path) as f:
        line = f.read().replace('"}', '", "reason": "accepted"}')
    with open(path, "w") as f:
        f.write(line)
    # a rewrite keeps the reason of a surviving fingerprint, even with the
    # finding moved to another line
    moved = source.lint_source("pkg/a.py", "\n\n" + text)
    assert baseline.write(path, moved) == 1
    assert '"reason": "accepted"' in open(path).read()
    fresh, sup = baseline.apply(moved, baseline.load(path))
    assert fresh == [] and sup == moved
    with open(path, "a") as f:
        f.write("not json\n")
    with pytest.raises(ValueError, match="malformed baseline line"):
        baseline.load(path)
    assert baseline.load(str(tmp_path / "missing.jsonl")) == set()


def test_cli_gates_on_fresh_findings(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("try:\n    f()\nexcept:\n    pass\n")
    bl = str(tmp_path / "bl.jsonl")
    rc, out, _ = _run(["source", str(bad), "--baseline", bl])
    assert rc == 1 and "bare-except" in out
    assert _run(["source", str(bad), "--baseline", bl, "--update-baseline"])[0] == 0
    rc, out, _ = _run(["source", str(bad), "--baseline", bl])
    assert rc == 0 and "1 baseline-suppressed" in out
    assert _run(["source", str(bad), "--baseline", bl, "--no-baseline"])[0] == 1
    assert _run(["concurrency", "--schedules", "0"])[0] == 2
    assert _run(["concurrency", "--static-only", "--scenario", "nope", "--no-self-check",
                 "--no-baseline"])[0] == 0
    assert _run(["concurrency", "--dynamic-only", "--scenario", "nope"])[0] == 2


# ---- the concurrency static pass --------------------------------------------------


def _serve_paths(pkg: str) -> list[str]:
    serve = os.path.join(pkg, "serve")
    return sorted(os.path.join(serve, f) for f in os.listdir(serve) if f.endswith(".py")) + [
        os.path.join(pkg, "obs", "spans.py")]


@pytest.mark.parametrize("pkg", ["capital_tpu", "capital_tpu_torch"])
def test_concurrency_static_matches_reference(pkg):
    paths = _serve_paths(pkg)
    port = concurrency.lint_tree(paths)
    assert _tuples(port) == _tuples(ref_concurrency.lint_tree(paths))
    assert [f for f in port if f.severity == rules.ERROR] == []


def test_concurrency_default_paths_are_the_ports():
    assert concurrency.default_paths() == _serve_paths("capital_tpu_torch")
    assert concurrency.lint_tree() == []


def test_concurrency_rules_fire():
    text = (
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()  # guarded-by: <lock>\n"
        "        self.n = 0  # guarded-by: self._lock\n"
        "        self.cfg = 1  # guarded-by: <frozen>\n"
        "        self.q = None\n"
        "    def bump(self):\n"
        "        self.n += 1\n"
        "        self.cfg = 2\n"
        "        with self._lock:\n"
        "            self.q.join()\n"
    )
    for mod in (concurrency, ref_concurrency):
        got = {f.rule for f in mod.lint_concurrency_source("pkg/x.py", text)}
        assert got == {"guarded-by", "guarded-by-frozen", "guarded-by-missing",
                       "blocking-under-lock"}
    assert _tuples(concurrency.lint_concurrency_source("pkg/x.py", text)) == _tuples(
        ref_concurrency.lint_concurrency_source("pkg/x.py", text))


# ---- the interleaving explorer -----------------------------------------------------


@pytest.mark.parametrize("name", [s.name for s in schedule.SCENARIOS])
def test_scenario_holds_every_invariant(name):
    sc = next(s for s in schedule.SCENARIOS if s.name == name)
    failing, runs = schedule.explore(sc, 24, seed=7)
    assert failing is None, failing.violation if failing else None
    assert runs == 24


def test_schedule_replays_from_its_seed():
    sc = schedule.SCENARIOS[0]
    a, b = schedule.run_schedule(sc, seed=11), schedule.run_schedule(sc, seed=11)
    assert a.violation is None and a.choices == b.choices and a.trace == b.trace
    forced = schedule.run_schedule(sc, seed=0, forced=a.choices)
    assert forced.choices == a.choices


def test_self_check_flags_the_seeded_fault_on_both_layers():
    import argparse

    out = lint_cli._self_check(argparse.Namespace(schedules=50, seed=0))
    assert [f.rule for f in out] == ["self-check"], [f.render() for f in out]
    assert "flagged on both layers" in out[0].message
    assert lint_cli._fixture_path() == str(ROOT / "tests" / "fixtures" / "concurrency_fault.py")
    static = {f.rule for f in concurrency.lint_concurrency_source(lint_cli._fixture_path())}
    assert {concurrency.GUARDED_BY, concurrency.LOCK_ORDER_CYCLE} <= static


def test_invariant_registry_matches_reference():
    assert [(i.name, i.subject, i.description) for i in invariants.REGISTRY] == [
        (i.name, i.subject, i.description) for i in ref_invariants.REGISTRY]
    router = {"dispatched": 3, "completed": 1, "parked": 1, "redispatched": 0, "duplicates": 0,
              "failed_replicas": 0, "per_replica": {"r0": {"outstanding": 1, "completed": 1,
                                                           "dispatched": 3}}}
    window = {"ok": 2, "failed": 0, "shed": 1, "requests": 3, "sampled": 2,
              "hist_ms": {"counts": [1, 1]}}
    cache = {"hits": 1, "misses": 0, "evictions": 1, "installs": 3, "released": 0, "entries": 2,
             "bytes": 10, "budget_bytes": 20, "entry_bytes": {"a": 4, "b": 6},
             "eviction_age_hist": {"2": 1}}
    sessions = {"misses": 1, "evicted_failures": 1, "reseeds": 0, "opens": 1, "hits": 3,
                "appends": 1, "solves": 1, "contracts": 1, "blocks_dropped": 0,
                "blocks_appended": 2}
    states = {invariants.ROUTER: router, invariants.SERVE_WINDOW: window,
              invariants.FACTOR_CACHE: cache, invariants.SESSIONS: sessions}
    assert invariants.check(states) == ref_invariants.check(states) == []
    broken = {invariants.ROUTER: dict(router, completed=2),
              invariants.SERVE_WINDOW: dict(window, shed=0),
              invariants.FACTOR_CACHE: dict(cache, bytes=11),
              invariants.SESSIONS: {"misses": 1}}
    got = invariants.check(broken)
    assert got == ref_invariants.check(broken) and len(got) == 4


# ---- the lint:report record ----------------------------------------------------------


def test_lint_report_record_reads_back(tmp_path):
    from capital_tpu.obs import ledger as ref_ledger
    from capital_tpu_torch.obs import __main__ as obs_cli
    from capital_tpu_torch.obs import ledger

    led = str(tmp_path / "lint.jsonl")
    assert _run(["concurrency", "--static-only", "--ledger", led])[0] == 0
    assert _run(["source", "capital_tpu_torch/obs", "--ledger", led])[0] == 0
    recs = ledger.read(led)
    assert [r["lint_report"]["pass"] for r in recs] == ["concurrency", "source"]
    for r in recs:
        assert r["manifest"]["platform"] == "host"
        assert ledger.validate_lint_report(r["lint_report"]) == []
        assert ref_ledger.validate_lint_report(r["lint_report"]) == []
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = obs_cli.main(["lint-report", led, "--require-pass", "concurrency",
                           "--require-pass", "source"])
    assert rc == 0, out.getvalue()
