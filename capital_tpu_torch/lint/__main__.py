"""CLI: ``python -m capital_tpu_torch.lint {source,concurrency} ...``
(counterpart of capital_tpu/lint/__main__.py, less ``program``).

``source`` AST-lints a tree (default: the port's package); ``concurrency``
runs the serve-plane concurrency sanitizer — the guarded-by/lock-order
static pass (lint/concurrency.py, default: the port's serve/ plus
obs/spans.py), the seeded interleaving explorer (lint/schedule.py), and a
self-check against the committed broken fixture
(tests/fixtures/concurrency_fault.py) that proves the gate is alive.  Both
apply the port's baseline (``capital_tpu_torch/lint/baseline.jsonl``)
unless ``--no-baseline``, can regenerate it with ``--update-baseline``,
and append ONE schema-tagged ``lint:report`` ledger record with
``--ledger`` — the record ``python -m capital_tpu_torch.obs lint-report``
reads.  Run them from the repository root: findings name paths relative
to the working directory, and so do the baseline's fingerprints.

The reference's ``program`` pass sanitises jaxprs and compiled HLO; the
port has no such IR (README, "The port's obs and lint").

Exit codes: 0 clean (or only findings below --fail-on), 1 gate failure,
2 malformed invocation (bad scenario name, non-positive --schedules;
argparse errors exit 2 as well).

Examples::

    python -m capital_tpu_torch.lint source capital_tpu_torch --fail-on warn
    python -m capital_tpu_torch.lint source capital_tpu_torch --no-baseline
    python -m capital_tpu_torch.lint concurrency --schedules 200 --ledger lint.jsonl
    python -m capital_tpu_torch.lint concurrency --static-only capital_tpu_torch/serve
"""

from __future__ import annotations

import argparse
import sys

from capital_tpu_torch.lint import baseline as baseline_mod
from capital_tpu_torch.lint import rules


def _report(pass_name: str, findings, args) -> rules.Report:
    if args.no_baseline:
        fresh, suppressed, bl_path = list(findings), [], None
    else:
        bl_path = args.baseline
        fresh, suppressed = baseline_mod.apply(
            findings, baseline_mod.load(bl_path))
    return rules.Report(pass_name=pass_name, fresh=fresh,
                        suppressed=suppressed, baseline_path=bl_path)


def _finish(pass_name: str, findings, args) -> int:
    if args.update_baseline:
        n = baseline_mod.write(args.baseline, findings)
        print(f"# wrote {n} baseline record(s) to {args.baseline}")
        return 0
    rep = _report(pass_name, findings, args)
    for f in rules.sort_findings(rep.fresh):
        print(f.render())
    counts = rep.counts()
    ok = rep.ok(args.fail_on)
    print(
        f"# lint {pass_name}: {counts['error']} error(s), "
        f"{counts['warn']} warn(s), {counts['info']} info, "
        f"{len(rep.suppressed)} baseline-suppressed "
        f"[fail-on={args.fail_on}] -> {'OK' if ok else 'FAIL'}"
    )
    if args.ledger:
        from capital_tpu_torch.obs import ledger

        ledger.append(args.ledger, ledger.record(
            "lint:report", ledger.host_manifest(),
            lint_report=rep.block(args.fail_on),
        ))
    return 0 if ok else 1


def _source(args) -> int:
    from capital_tpu_torch.lint import source

    findings = []
    for path in args.paths or ["capital_tpu_torch"]:
        findings.extend(source.lint_tree(path))
    return _finish("source", findings, args)


def _fixture_path() -> str:
    """tests/fixtures/concurrency_fault.py, located relative to the
    port's package so the self-check works from any cwd inside a
    checkout."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "tests", "fixtures", "concurrency_fault.py")


def _self_check(args) -> list:
    """Dead-gate discipline: the sanitizer must flag the committed
    broken fixture on BOTH layers, every run.  A sanitizer that stops
    flagging it gets a loud ``self-check-dead`` error, not a green."""
    import importlib.util
    import os

    from capital_tpu_torch.lint import concurrency, schedule

    fix = _fixture_path()
    if not os.path.exists(fix):
        return [rules.make(
            "self-check-dead", rules.ERROR, fix,
            "seeded-fault fixture missing — the gate cannot prove it is "
            "alive (restore tests/fixtures/concurrency_fault.py)")]
    out = []
    static = concurrency.lint_concurrency_source(fix)
    got = {f.rule for f in static}
    for want in (concurrency.GUARDED_BY, concurrency.LOCK_ORDER_CYCLE):
        if want not in got:
            out.append(rules.make(
                "self-check-dead", rules.ERROR, fix,
                f"static layer no longer emits {want!r} on the seeded "
                f"fault (got {sorted(got) or 'nothing'}) — the rule is "
                "dead"))
    spec = importlib.util.spec_from_file_location("concurrency_fault", fix)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    failing, runs = schedule.explore(
        schedule.fault_scenario(mod), min(args.schedules, 50),
        seed=args.seed)
    if failing is None or not failing.trace:
        out.append(rules.make(
            "self-check-dead", rules.ERROR, fix,
            f"interleaving explorer swept {runs} schedules without "
            "reproducing the seeded lost update — the explorer is dead"))
    if not out:
        out.append(rules.make(
            "self-check", rules.INFO, fix,
            "seeded fault flagged on both layers "
            f"({len(static)} static finding(s); lost update reproduced "
            f"in {runs} schedule(s), minimal trace {len(failing.trace)} "
            "step(s))"))
    return out


def _concurrency(args) -> int:
    from capital_tpu_torch.lint import concurrency, schedule

    if args.schedules < 1:
        print("--schedules must be >= 1", file=sys.stderr)
        return 2
    findings = []
    if not args.dynamic_only:
        findings.extend(concurrency.lint_tree(args.paths or None))
    if not args.static_only:
        scenarios = schedule.SCENARIOS
        if args.scenario:
            byname = {s.name: s for s in schedule.SCENARIOS}
            unknown = [n for n in args.scenario if n not in byname]
            if unknown:
                print(f"unknown scenario(s) {unknown}; known: "
                      f"{sorted(byname)}", file=sys.stderr)
                return 2
            scenarios = tuple(byname[n] for n in args.scenario)
        print(f"# exploring {len(scenarios)} scenario(s) x "
              f"{args.schedules} seeded schedule(s)")
        findings.extend(schedule.lint_schedules(
            args.schedules, seed=args.seed, scenarios=scenarios))
    if not args.no_self_check:
        findings.extend(_self_check(args))
    return _finish("concurrency", findings, args)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="capital_tpu_torch.lint")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--fail-on", default="error",
                        choices=["warn", "error"],
                        help="lowest severity that fails the gate")
        sp.add_argument("--baseline", default=baseline_mod.DEFAULT_PATH,
                        help="suppression file (JSONL of fingerprints)")
        sp.add_argument("--no-baseline", action="store_true",
                        help="ignore the baseline: report the full debt")
        sp.add_argument("--update-baseline", action="store_true",
                        help="rewrite the baseline from current findings "
                             "and exit 0")
        sp.add_argument("--ledger", default=None,
                        help="append one lint:report record to this JSONL "
                             "ledger")

    s = sub.add_parser("source", help="AST lint over source trees")
    s.add_argument("paths", nargs="*",
                   help="files or directories (default: capital_tpu_torch)")
    common(s)
    s.set_defaults(fn=_source)

    c = sub.add_parser(
        "concurrency",
        help="serve-plane concurrency sanitizer: guarded-by lint, "
             "lock-order graph, seeded interleaving explorer")
    c.add_argument("paths", nargs="*",
                   help="files/dirs for the static layer (default: "
                        "capital_tpu_torch/serve + obs/spans.py)")
    c.add_argument("--static-only", action="store_true",
                   help="skip the interleaving explorer")
    c.add_argument("--dynamic-only", action="store_true",
                   help="skip the static guarded-by/lock-order pass")
    c.add_argument("--schedules", type=int, default=200,
                   help="seeded schedules per scenario (default 200)")
    c.add_argument("--seed", type=int, default=0,
                   help="base seed for the schedule sweep")
    c.add_argument("--scenario", action="append", default=None,
                   help="run only this scenario (repeatable)")
    c.add_argument("--no-self-check", action="store_true",
                   help="skip the seeded-fault dead-gate self-check")
    common(c)
    c.set_defaults(fn=_concurrency)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
