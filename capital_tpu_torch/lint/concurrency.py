"""The concurrency sanitizer, static layer: guarded-by contracts and the
lock-acquisition graph over the serve host plane (counterpart of
capital_tpu/lint/concurrency.py, the same grammar and rules, aimed at the
port's serve/ and obs/spans.py).

The serve tier's threading model (the reference's docs/SERVING.md "The
locking model")
is simple by design — ONE real lock (the Router's RLock) plus a fleet of
single-owner classes that ride one dispatch loop — but nothing enforced
it: a new method touching ``router._parked`` outside the lock, or a
second lock acquired in the wrong order, would compile, pass the lucky
interleavings pytest produces, and ship.  This pass makes the model a
checked contract:

* **guarded-by** — every shared attribute of the registered serve
  classes carries a ``# guarded-by: <guard>`` annotation at its
  ``__init__`` assignment; the pass errors on any attribute access that
  violates the guard's discipline (and on registered classes whose
  annotations are not exhaustive — a contract with holes is not a
  contract).
* **lock-order-cycle** — the static lock-acquisition graph (lexical
  ``with``-nesting plus the intra-class call graph) must be acyclic; a
  cycle is a potential deadlock no test will reliably reproduce.
* **blocking-under-lock** — a blocking call (pipe/queue roundtrips,
  ``Event.wait``, ``join``, ``sleep``) made while lexically holding a
  lock stalls every thread contending for it; the three deliberate
  router roundtrip sites carry visible inline suppressions with reasons
  (same discipline as ``# lint: allow-broad-except``).

Annotation grammar (trailing comment on the ``__init__`` assignment)::

    self._states = {}          # guarded-by: self._lock
    self._lock = RLock()       # guarded-by: <lock>          (a guard itself)
    self.cfg = cfg             # guarded-by: <frozen>        (set once)
    self._entries = {}         # guarded-by: <owner-thread>  (single owner)
    self._stop = Event()       # guarded-by: <self-sync>     (primitive)
    self.attempts = 0          # guarded-by: <router-lock>   (owner's lock)
    self.response = None       # guarded-by: <published-by: self._event>

Enforcement per guard: ``self.<lock>`` — every access outside
``__init__`` must sit lexically inside ``with self.<lock>:`` or in a
method marked ``# lock-held: self.<lock>`` on its ``def`` line;
``<frozen>`` — no writes outside ``__init__``; the contract guards
(``<owner-thread>``, ``<self-sync>``, ``<router-lock>``,
``<published-by: ...>``) document an ownership discipline the dynamic
layer (lint/schedule.py) exercises instead of a lexical scope.  Methods
marked lock-held are themselves checked at their call sites: calling one
without holding its lock is the same bug as touching the attribute.

Pure stdlib ``ast`` + source-line comment scans — nothing is imported,
so the pass lints the deliberately broken self-check fixture safely.
Findings reuse the rules engine verbatim (lint/rules.py: fingerprints,
severities, baseline, Report.block).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Optional

from capital_tpu_torch.lint import rules

GUARDED_BY = "guarded-by"
GUARDED_BY_MISSING = "guarded-by-missing"
GUARDED_BY_GRAMMAR = "guarded-by-grammar"
GUARDED_BY_FROZEN = "guarded-by-frozen"
LOCK_HELD_CALL = "lock-held-call"
LOCK_ORDER_CYCLE = "lock-order-cycle"
BLOCKING_UNDER_LOCK = "blocking-under-lock"

CONCURRENCY_RULES = (
    GUARDED_BY, GUARDED_BY_MISSING, GUARDED_BY_GRAMMAR, GUARDED_BY_FROZEN,
    LOCK_HELD_CALL, LOCK_ORDER_CYCLE, BLOCKING_UNDER_LOCK,
)

#: Classes whose annotation coverage must be exhaustive: the shared state
#: of the serve host plane (path suffix, class name).  Any OTHER class
#: that carries at least one guarded-by annotation opts into the same
#: exhaustiveness contract (the self-check fixture does).
REGISTERED_CLASSES = frozenset({
    (os.path.join("serve", "router.py"), "Router"),
    (os.path.join("serve", "router.py"), "RouterTicket"),
    (os.path.join("serve", "router.py"), "_ReplicaState"),
    (os.path.join("serve", "scheduler.py"), "Scheduler"),
    (os.path.join("serve", "factorcache.py"), "FactorCache"),
    (os.path.join("serve", "sessions.py"), "SessionManager"),
    (os.path.join("serve", "telemetry.py"), "WindowAggregator"),
    (os.path.join("serve", "telemetry.py"), "_Window"),
    (os.path.join("serve", "engine.py"), "SolveEngine"),
    (os.path.join("obs", "spans.py"), "TraceLog"),
    (os.path.join("obs", "spans.py"), "RequestTrace"),
})

#: Contract guards: documented ownership disciplines with no lexical
#: scope to check (the dynamic layer exercises them instead).
CONTRACT_GUARDS = ("<owner-thread>", "<self-sync>", "<router-lock>",
                   "<frozen>", "<lock>")

#: Call names that block the calling thread: sync transport roundtrips
#: (drain / warmup / request_stats / ping / stop ride _roundtrip),
#: primitive waits, thread joins, sleeps.  Deliberate sites suppress
#: inline with a reason.
BLOCKING_NAMES = frozenset({
    "wait", "join", "sleep", "drain", "warmup", "request_stats", "ping",
    "stop", "_roundtrip", "_await", "recv",
})

#: Inline suppression markers (on the offending line, with a reason).
_SUPPRESS_MARKERS = ("noqa", "lint: allow-blocking-under-lock",
                     "lint: allow-unguarded")

_ANNOT_RE = re.compile(r"guarded-by:\s*(<[^>]+>|self\.\w+)")
_LOCK_HELD_RE = re.compile(r"lock-held:\s*(self\.\w+)")


def _attr_chain(node: ast.AST) -> list[str]:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return []


def _self_attr(node: ast.AST) -> Optional[str]:
    """'X' when node is exactly ``self.X``; None otherwise."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _is_lock_ctor(node: ast.AST) -> bool:
    """True for ``threading.Lock()`` / ``threading.RLock()`` / bare
    ``Lock()`` / ``RLock()`` value expressions."""
    if not isinstance(node, ast.Call):
        return False
    chain = _attr_chain(node.func)
    return bool(chain) and chain[-1] in ("Lock", "RLock")


class _ClassInfo:
    """Everything the checks need about one class: annotations, lock
    attributes, lock-held method markers, and the per-method acquisition
    facts feeding the global lock graph."""

    def __init__(self, name: str):
        self.name = name
        self.guards: dict[str, str] = {}       # attr -> guard string
        self.annot_lines: dict[str, int] = {}  # attr -> annotation lineno
        self.init_attrs: dict[str, int] = {}   # __init__ self.X -> lineno
        self.locks: set[str] = set()           # attrs that ARE locks
        self.lock_held: dict[str, str] = {}    # method -> lock attr it needs
        # method -> set of lock attrs it acquires directly (lexically)
        self.direct_acquires: dict[str, set[str]] = {}
        # method -> set of self-method names it calls
        self.self_calls: dict[str, set[str]] = {}
        # (held lock attr, acquired-or-called, lineno) acquisition events;
        # 'acquired' entries are lock attrs, 'called' entries method names
        self.nested_acquires: list[tuple[str, str, int]] = []
        self.calls_under_lock: list[tuple[str, str, int]] = []

    def lock_id(self, attr: str) -> str:
        return f"{self.name}.{attr}"


def _collect_class(cls: ast.ClassDef, lines: list[str]) -> _ClassInfo:
    info = _ClassInfo(cls.name)

    def line(n: int) -> str:
        return lines[n - 1] if 0 < n <= len(lines) else ""

    for item in cls.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        m = _LOCK_HELD_RE.search(line(item.lineno))
        if m:
            info.lock_held[item.name] = m.group(1).split(".", 1)[1]
        if item.name != "__init__":
            continue
        for node in ast.walk(item):
            targets: list[ast.AST] = []
            value: Optional[ast.AST] = None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            for tgt in targets:
                attr = _self_attr(tgt)
                if attr is None:
                    continue
                info.init_attrs.setdefault(attr, node.lineno)
                m = _ANNOT_RE.search(line(node.lineno))
                if m:
                    info.guards.setdefault(attr, m.group(1))
                    info.annot_lines.setdefault(attr, node.lineno)
                if value is not None and _is_lock_ctor(value):
                    info.locks.add(attr)
    for attr, guard in info.guards.items():
        if guard == "<lock>":
            info.locks.add(attr)
    return info


def _registered(path: str, info: _ClassInfo) -> bool:
    norm = os.path.normpath(path)
    if any(norm.endswith(sfx) and cname == info.name
           for sfx, cname in REGISTERED_CLASSES):
        return True
    return bool(info.guards)


def _check_class(path: str, cls: ast.ClassDef, info: _ClassInfo,
                 lines: list[str], findings: list[rules.Finding], *,
                 exhaustive: bool = True) -> None:
    def line(n: int) -> str:
        return lines[n - 1] if 0 < n <= len(lines) else ""

    def suppressed(n: int) -> bool:
        return any(mk in line(n) for mk in _SUPPRESS_MARKERS)

    # -- annotation exhaustiveness + grammar -------------------------------
    for attr, lineno in sorted(info.init_attrs.items()):
        guard = info.guards.get(attr)
        if guard is None:
            if exhaustive:
                findings.append(rules.make(
                    GUARDED_BY_MISSING, rules.ERROR, path,
                    f"{info.name}.{attr} has no guarded-by annotation — "
                    "the registry must be exhaustive (annotate the "
                    "__init__ assignment: # guarded-by: self.<lock> | "
                    "<frozen> | <owner-thread> | <self-sync> | <lock> "
                    "| ...)",
                    line=lineno,
                ))
            continue
        if guard.startswith("self."):
            lock_attr = guard.split(".", 1)[1]
            if lock_attr not in info.locks:
                findings.append(rules.make(
                    GUARDED_BY_GRAMMAR, rules.ERROR, path,
                    f"{info.name}.{attr} names guard {guard!r} but "
                    f"{info.name}.{lock_attr} is not a lock of this class "
                    "(no Lock()/RLock() assignment or <lock> annotation)",
                    line=info.annot_lines[attr],
                ))
        elif guard not in CONTRACT_GUARDS \
                and not guard.startswith("<published-by:"):
            findings.append(rules.make(
                GUARDED_BY_GRAMMAR, rules.ERROR, path,
                f"{info.name}.{attr} carries unknown guard {guard!r} — "
                f"use self.<lock>, <published-by: ...>, or one of "
                f"{CONTRACT_GUARDS}",
                line=info.annot_lines[attr],
            ))

    lock_guarded = {a: g.split(".", 1)[1] for a, g in info.guards.items()
                    if g.startswith("self.")}
    frozen = {a for a, g in info.guards.items() if g == "<frozen>"}

    # -- per-method coverage walk ------------------------------------------
    for item in cls.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        method = item.name
        held0 = frozenset(
            {info.lock_held[method]} if method in info.lock_held else ())
        info.direct_acquires.setdefault(method, set())
        info.self_calls.setdefault(method, set())

        def visit(node: ast.AST, held: frozenset, in_closure: bool,
                  method: str = method) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not item:
                # a nested def/lambda runs later, NOT under the lexically
                # enclosing lock (the router's pump-loop closure)
                body = node.body if isinstance(node.body, list) \
                    else [node.body]
                for child in body:
                    visit(child, frozenset(), True)
                return
            if isinstance(node, ast.With):
                acquired = []
                for w in node.items:
                    attr = _self_attr(w.context_expr)
                    if attr is not None and attr in info.locks:
                        acquired.append((attr, w.context_expr.lineno))
                for w in node.items:
                    visit(w.context_expr, held, in_closure)
                for attr, lineno in acquired:
                    for h in held:
                        if h != attr:
                            info.nested_acquires.append((h, attr, lineno))
                    if not in_closure:
                        info.direct_acquires[method].add(attr)
                    held = held | {attr}
                for child in node.body:
                    visit(child, held, in_closure)
                return
            if isinstance(node, ast.Call):
                chain = _attr_chain(node.func)
                callee = _self_attr(node.func)
                if callee is not None and not in_closure:
                    info.self_calls[method].add(callee)
                    for h in held:
                        info.calls_under_lock.append(
                            (h, callee, node.lineno))
                if callee is not None and callee in info.lock_held:
                    need = info.lock_held[callee]
                    if need not in held and not suppressed(node.lineno):
                        findings.append(rules.make(
                            LOCK_HELD_CALL, rules.ERROR, path,
                            f"{info.name}.{method} calls lock-held method "
                            f"{callee}() without holding self.{need}",
                            line=node.lineno,
                        ))
                if held and chain and chain[-1] in BLOCKING_NAMES \
                        and not suppressed(node.lineno):
                    findings.append(rules.make(
                        BLOCKING_UNDER_LOCK, rules.ERROR, path,
                        f"{info.name}.{method} calls blocking "
                        f"`{'.'.join(chain)}` while holding "
                        f"{', '.join(f'self.{h}' for h in sorted(held))} — "
                        "every contending thread stalls for the call's "
                        "full duration (suppress inline with a reason if "
                        "deliberate: # lint: allow-blocking-under-lock)",
                        line=node.lineno,
                    ))
            attr = _self_attr(node)
            if attr is not None and method != "__init__":
                if attr in lock_guarded:
                    need = lock_guarded[attr]
                    if need not in held and not suppressed(node.lineno):
                        rw = ("write" if isinstance(
                            getattr(node, "ctx", None),
                            (ast.Store, ast.Del)) else "read")
                        findings.append(rules.make(
                            GUARDED_BY, rules.ERROR, path,
                            f"{info.name}.{method} {rw}s self.{attr} "
                            f"(guarded-by self.{need}) outside the lock — "
                            f"wrap in `with self.{need}:` or mark the "
                            f"method `# lock-held: self.{need}`",
                            line=node.lineno,
                        ))
                elif attr in frozen and isinstance(
                        getattr(node, "ctx", None), (ast.Store, ast.Del)) \
                        and not suppressed(node.lineno):
                    findings.append(rules.make(
                        GUARDED_BY_FROZEN, rules.ERROR, path,
                        f"{info.name}.{method} writes self.{attr}, "
                        "annotated <frozen> (set once in __init__, "
                        "immutable after publication)",
                        line=node.lineno,
                    ))
            for child in ast.iter_child_nodes(node):
                visit(child, held, in_closure)

        visit(item, held0, False)


def _lock_graph_edges(infos: dict[str, _ClassInfo]
                      ) -> list[tuple[str, str, str, int]]:
    """Directed (held-lock-id, acquired-lock-id, path, lineno) edges:
    lexical nesting plus one level of intra-class call propagation
    (a call made under lock L to a method that eventually acquires M
    adds L -> M)."""
    edges: list[tuple[str, str, str, int]] = []
    for path, info in infos.items():
        # transitive closure of locks each method eventually acquires
        eventual: dict[str, set[str]] = {
            m: set(acq) for m, acq in info.direct_acquires.items()}
        changed = True
        while changed:
            changed = False
            for m, callees in info.self_calls.items():
                for c in callees:
                    extra = eventual.get(c, set()) - eventual.setdefault(
                        m, set())
                    if extra:
                        eventual[m].update(extra)
                        changed = True
        for held, acquired, lineno in info.nested_acquires:
            edges.append((info.lock_id(held), info.lock_id(acquired),
                          path, lineno))
        for held, callee, lineno in info.calls_under_lock:
            for acq in sorted(eventual.get(callee, ())):
                if acq != held:
                    edges.append((info.lock_id(held), info.lock_id(acq),
                                  path, lineno))
    return edges


def _find_cycles(edges: list[tuple[str, str, str, int]]
                 ) -> list[tuple[tuple[str, ...], str, int]]:
    """Canonical cycles in the lock graph: each reported once, rotated to
    start at its lexicographically smallest lock, with a witness site."""
    graph: dict[str, set[str]] = {}
    site: dict[tuple[str, str], tuple[str, int]] = {}
    for a, b, path, lineno in edges:
        graph.setdefault(a, set()).add(b)
        site.setdefault((a, b), (path, lineno))
    cycles: dict[tuple[str, ...], tuple[str, int]] = {}

    def dfs(start: str, node: str, trail: list[str]) -> None:
        for nxt in sorted(graph.get(node, ())):
            if nxt == start:
                cyc = trail + [node]
                i = cyc.index(min(cyc))
                canon = tuple(cyc[i:] + cyc[:i])
                cycles.setdefault(canon, site[(node, start)])
            elif nxt not in trail + [node] and len(trail) < 8:
                dfs(start, nxt, trail + [node])

    for start in sorted(graph):
        dfs(start, start, [])
    return [(c, p, ln) for c, (p, ln) in sorted(cycles.items())]


def lint_concurrency_source(path: str, text: Optional[str] = None,
                            _graph_sink: Optional[dict] = None
                            ) -> list[rules.Finding]:
    """Every per-file concurrency finding (guarded-by family + blocking
    under lock).  Lock-graph facts accumulate into `_graph_sink` when
    given (lint_tree passes one and runs the cycle check globally);
    standalone calls get their cycles checked file-locally."""
    if text is None:
        with open(path) as f:
            text = f.read()
    try:
        tree = ast.parse(text, filename=path)
    except SyntaxError as e:
        return [rules.make(
            "syntax", rules.ERROR, path,
            f"not parseable: {e.msg}", line=e.lineno or 0)]
    lines = text.splitlines()
    findings: list[rules.Finding] = []
    infos: dict[str, _ClassInfo] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        info = _collect_class(node, lines)
        registered = _registered(path, info)
        if not registered and not info.locks:
            continue
        # unregistered lock-owning classes still feed the lock graph and
        # the blocking-under-lock check; only the guarded-by family and
        # the exhaustiveness contract are registry-scoped
        _check_class(path, node, info, lines, findings,
                     exhaustive=registered)
        infos[f"{path}::{node.name}"] = info
    if _graph_sink is not None:
        _graph_sink.update(infos)
    else:
        findings.extend(cycle_findings(infos))
    return rules.sort_findings(findings)


def cycle_findings(infos: dict[str, _ClassInfo]) -> list[rules.Finding]:
    """lock-order-cycle findings over an accumulated lock graph (keys are
    'path::Class', values the per-class acquisition facts)."""
    edges: list[tuple[str, str, str, int]] = []
    for key, info in infos.items():
        path = key.split("::", 1)[0]
        edges.extend(_lock_graph_edges({path: info}))
    findings = []
    for cycle, path, lineno in _find_cycles(edges):
        findings.append(rules.make(
            LOCK_ORDER_CYCLE, rules.ERROR, path,
            "lock-acquisition cycle (potential deadlock): "
            + " -> ".join(cycle + (cycle[0],))
            + " — impose one global acquisition order",
            line=lineno,
        ))
    return findings


def default_paths() -> list[str]:
    """The serve host plane: every module under the port's serve/ plus the
    shared span accumulator (obs/spans.py) — paths relative to the cwd
    when possible so fingerprints are stable across checkouts."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = []
    serve = os.path.join(pkg, "serve")
    for fn in sorted(os.listdir(serve)):
        if fn.endswith(".py"):
            paths.append(os.path.join(serve, fn))
    paths.append(os.path.join(pkg, "obs", "spans.py"))
    out = []
    for p in paths:
        rel = os.path.relpath(p)
        out.append(rel if not rel.startswith("..") else p)
    return out


def lint_tree(paths: Optional[list[str]] = None) -> list[rules.Finding]:
    """The static layer over `paths` (default: the serve plane), with the
    lock-acquisition graph assembled ACROSS files before the cycle
    check — a deadlock between two modules' locks is the case that
    matters once replicas and their transports take locks of their own."""
    findings: list[rules.Finding] = []
    graph: dict[str, _ClassInfo] = {}
    for path in (paths if paths is not None else default_paths()):
        if os.path.isdir(path):
            for dirpath, dirnames, filenames in os.walk(path):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        findings.extend(lint_concurrency_source(
                            os.path.join(dirpath, fn), _graph_sink=graph))
        else:
            findings.extend(lint_concurrency_source(path,
                                                    _graph_sink=graph))
    findings.extend(cycle_findings(graph))
    return rules.sort_findings(findings)
