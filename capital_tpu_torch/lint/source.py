"""The source lint: AST rules enforcing the port's coding rules
(counterpart of capital_tpu/lint/source.py, its five rules aimed at the
port).

* ``bare-except`` — ``except:`` swallows KeyboardInterrupt and bugs alike.
* ``broad-except`` — ``except Exception`` (or BaseException) without a
  re-raise or a logging call in the handler.  Catch-and-drop turns every
  future bug into silence; the accepted spellings are (a) narrow the type,
  (b) re-raise after containment, (c) log what was swallowed, or (d) an
  explicit inline ``# noqa``/``# lint: allow-broad-except`` with a reason —
  visible suppression at the site, reviewable in diffs.
* ``compute-outside-scope`` — in ``models/``/``parallel/``/``ops/``,
  FLOP-bearing ``torch.`` calls (``matmul``, ``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, ``einsum``, ``tensordot``, every ``torch.linalg`` function,
  ``cholesky*``, ``triangular_solve``) and the ``@`` operator must sit
  lexically inside a ``tracing.scope(...)`` block, or the work lands in no
  phase of the cost model and in no ``record_function`` range of a
  ``torch.profiler`` trace.  Severity warn: lexical analysis cannot see
  callers that wrap the whole function in a scope, so a human decides
  (fix, or baseline with a reason).
* ``unregistered-phase-tag`` — string literals passed to ``scope(...)`` or
  ``tap(point=...)`` must be in ``capital_tpu_torch/utils/tracing.py``'s
  ``PHASE_REGISTRY``.  scope() refuses unknown tags when it runs; this rule
  moves the failure to lint time, before a rarely-run branch ships the
  ValueError.  The registry is read from that file's source (a literal
  tuple), so the lint loads no torch.
* ``host-only-dispatch`` — the serve dispatch plane (``serve/router.py``,
  ``serve/replica.py``, ``serve/loadgen.py``, ``serve/telemetry.py``) and
  the host tools (every file under ``obs/`` and ``lint/``) must not import
  a device runtime (torch, triton, jax) at module level: router pumps,
  loadgen clients and the report CLIs run in processes that never need
  one, and a spawned replica must apply its environment before torch
  initialises.  A lazy import inside a function is the sanctioned way in.

Pure stdlib ``ast`` — no file is imported, so linting broken code or code
with heavy import side effects is safe.
"""

from __future__ import annotations

import ast
import functools
import os
from typing import Optional

from capital_tpu_torch.lint import rules

BARE_EXCEPT = "bare-except"
BROAD_EXCEPT = "broad-except"
COMPUTE_OUTSIDE_SCOPE = "compute-outside-scope"
UNREGISTERED_PHASE_TAG = "unregistered-phase-tag"
HOST_ONLY_DISPATCH = "host-only-dispatch"

SOURCE_RULES = (
    BARE_EXCEPT, BROAD_EXCEPT, COMPUTE_OUTSIDE_SCOPE, UNREGISTERED_PHASE_TAG,
    HOST_ONLY_DISPATCH,
)

#: Files (path suffixes) that form the serve dispatch plane: host-only by
#: contract, no module-level device-runtime import allowed.
HOST_ONLY_FILES = tuple(os.path.join("serve", f) for f in
                        ("router.py", "replica.py", "loadgen.py", "telemetry.py"))

#: Package directories whose every file is host-only (the report and lint
#: CLIs and what they import).
HOST_ONLY_DIRS = ("obs", "lint")

#: Module roots whose import at module level couples a file to a device
#: runtime.
_DEVICE_ROOTS = frozenset({"torch", "triton", "jax", "jaxlib"})

#: FLOP-bearing torch entry points (besides every torch.linalg function
#: and the cholesky family, matched by prefix).
FLOP_FNS = frozenset({
    "matmul", "mm", "bmm", "addmm", "baddbmm", "einsum", "tensordot",
    "triangular_solve",
})

#: Roots a FLOP call must hang off to count: ``torch.`` (and a bare
#: ``linalg.`` imported from torch).  Host numpy carries no phase anyway.
_COMPUTE_ROOTS = frozenset({"torch", "linalg"})

#: Method names whose presence in a broad-except handler counts as "logged".
_LOG_METHODS = frozenset({
    "debug", "info", "warning", "warn", "error", "exception", "critical",
})

#: Inline suppression markers on the ``except`` line itself.
_SUPPRESS_MARKERS = ("noqa", "lint: allow-broad-except")

#: Directories (package segments) where compute-outside-scope applies.
SCOPED_DIRS = ("models", "parallel", "ops")

#: The module whose PHASE_REGISTRY literal the phase-tag rule reads.
TRACING_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "utils", "tracing.py")


@functools.lru_cache(maxsize=None)
def phase_registry() -> frozenset:
    """The tags of utils/tracing.py's ``PHASE_REGISTRY = (...)`` literal."""
    with open(TRACING_PATH) as f:
        tree = ast.parse(f.read(), filename=TRACING_PATH)
    for node in tree.body:
        target = node.target if isinstance(node, ast.AnnAssign) else (
            node.targets[0] if isinstance(node, ast.Assign) and len(node.targets) == 1 else None)
        if isinstance(target, ast.Name) and target.id == "PHASE_REGISTRY":
            return frozenset(ast.literal_eval(node.value))
    raise ValueError(f"{TRACING_PATH}: no PHASE_REGISTRY literal")


def _attr_chain(node: ast.AST) -> list[str]:
    """['torch', 'linalg', 'cholesky'] for torch.linalg.cholesky; [] when
    the expression is not a plain dotted name."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return []


def _is_scope_call(node: ast.AST) -> bool:
    """True for ``scope(...)`` / ``tracing.scope(...)`` context managers."""
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id == "scope"
    if isinstance(fn, ast.Attribute):
        return fn.attr == "scope"
    return False


def _is_logging_call(node: ast.Call) -> bool:
    fn = node.func
    if isinstance(fn, ast.Attribute) and fn.attr in _LOG_METHODS:
        return True
    if isinstance(fn, ast.Name) and fn.id in ("warn", "log"):
        return True
    return False


def _handler_contains_exit(handler: ast.ExceptHandler) -> bool:
    """Re-raise or logging anywhere inside the handler body."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call) and _is_logging_call(node):
            return True
    return False


def _phase_literal(call: ast.Call) -> Optional[tuple[str, int]]:
    """(tag, lineno) when `call` is scope(<str-literal>) or
    tap(..., point=<str-literal>); None otherwise."""
    fn = call.func
    name = fn.id if isinstance(fn, ast.Name) else (
        fn.attr if isinstance(fn, ast.Attribute) else None)
    if name == "scope" and call.args:
        arg = call.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return arg.value, arg.lineno
    if name == "tap":
        for kw in call.keywords:
            if kw.arg == "point" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                return kw.value.value, kw.value.lineno
        if len(call.args) >= 2:
            arg = call.args[1]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                return arg.value, arg.lineno
    return None


def _in_dirs(path: str, dirs) -> bool:
    parts = os.path.normpath(path).split(os.sep)[:-1]
    return any(p in dirs for p in parts)


def _host_only(path: str) -> bool:
    norm = os.path.normpath(path)
    return any(norm.endswith(sfx) for sfx in HOST_ONLY_FILES) or _in_dirs(path, HOST_ONLY_DIRS)


def _flop_call_name(node: ast.AST) -> Optional[str]:
    """The FLOP function name when `node` is a torch compute call or an
    ``@`` matmul expression; None otherwise."""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
        return "@"
    if isinstance(node, ast.Call):
        chain = _attr_chain(node.func)
        if len(chain) >= 2 and chain[0] in _COMPUTE_ROOTS and (
                chain[-1] in FLOP_FNS or chain[-1].startswith("cholesky")
                or "linalg" in chain):
            return ".".join(chain)
    return None


def lint_source(path: str, text: Optional[str] = None) -> list[rules.Finding]:
    """Every source finding for one file.  `text` overrides reading `path`
    (the tests lint synthetic snippets under invented paths)."""
    if text is None:
        with open(path) as f:
            text = f.read()
    registry = phase_registry()
    try:
        tree = ast.parse(text, filename=path)
    except SyntaxError as e:
        return [rules.make(
            "syntax", rules.ERROR, path,
            f"not parseable: {e.msg}", line=e.lineno or 0,
        )]
    lines = text.splitlines()
    findings: list[rules.Finding] = []

    def _suppressed(lineno: int) -> bool:
        if 0 < lineno <= len(lines):
            line = lines[lineno - 1]
            return any(m in line for m in _SUPPRESS_MARKERS)
        return False

    # -- except rules + phase-tag rule: flat walk --------------------------
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler):
            if node.type is None:
                findings.append(rules.make(
                    BARE_EXCEPT, rules.ERROR, path,
                    "bare `except:` swallows KeyboardInterrupt and bugs "
                    "alike — name the exception types",
                    line=node.lineno,
                ))
                continue
            tname = node.type.id if isinstance(node.type, ast.Name) else (
                node.type.attr if isinstance(node.type, ast.Attribute)
                else None)
            if tname in ("Exception", "BaseException") \
                    and not _handler_contains_exit(node) \
                    and not _suppressed(node.lineno):
                findings.append(rules.make(
                    BROAD_EXCEPT, rules.ERROR, path,
                    f"`except {tname}` without re-raise or logging — "
                    "narrow the type, re-raise after containment, log "
                    "what was swallowed, or suppress inline with a reason "
                    "(# lint: allow-broad-except)",
                    line=node.lineno,
                ))
        elif isinstance(node, ast.Call):
            lit = _phase_literal(node)
            if lit is not None and lit[0] not in registry:
                findings.append(rules.make(
                    UNREGISTERED_PHASE_TAG, rules.ERROR, path,
                    f"phase tag {lit[0]!r} is not in tracing.PHASE_REGISTRY "
                    "— scope() will raise at trace time; register it (or "
                    "register_phase) so downstream views can bucket it",
                    line=lit[1],
                ))

    # -- host-only-dispatch: module-level device-runtime imports -----------
    if _host_only(path):
        def _import_roots(node: ast.AST) -> list[tuple[str, int]]:
            if isinstance(node, ast.Import):
                return [(a.name.split(".")[0], node.lineno)
                        for a in node.names]
            if isinstance(node, ast.ImportFrom) and node.module and not node.level:
                return [(node.module.split(".")[0], node.lineno)]
            return []

        def scan_module_level(node: ast.AST) -> None:
            # function bodies are exempt: the lazy import inside a worker
            # or a scenario is the sanctioned way to reach the device
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    continue
                for root, lineno in _import_roots(child):
                    if root in _DEVICE_ROOTS and not _suppressed(lineno):
                        findings.append(rules.make(
                            HOST_ONLY_DISPATCH, rules.ERROR, path,
                            f"module-level `{root}` import in a host-only "
                            "module — the dispatch plane and the host tools "
                            "load no device runtime (import lazily inside "
                            "the function that needs it)",
                            line=lineno,
                        ))
                scan_module_level(child)

        scan_module_level(tree)

    # -- compute-outside-scope: recursive walk with scope context ----------
    if _in_dirs(path, SCOPED_DIRS):
        def visit(node: ast.AST, covered: bool) -> None:
            if isinstance(node, ast.With):
                covered = covered or any(
                    _is_scope_call(item.context_expr) for item in node.items
                )
            name = _flop_call_name(node)
            if name is not None and not covered \
                    and not _suppressed(node.lineno):
                findings.append(rules.make(
                    COMPUTE_OUTSIDE_SCOPE, rules.WARN, path,
                    f"FLOP-bearing `{name}` outside every tracing.scope() "
                    "block — the work lands in no phase of the cost model "
                    "and in no record_function range of a profile",
                    line=node.lineno,
                ))
            for child in ast.iter_child_nodes(node):
                visit(child, covered)

        visit(tree, covered=False)
    return rules.sort_findings(findings)


def lint_tree(root: str) -> list[rules.Finding]:
    """Lint every ``*.py`` under `root` (skipping __pycache__), findings
    keyed by path relative to the current directory."""
    findings: list[rules.Finding] = []
    if os.path.isfile(root):
        return lint_source(root)
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                findings.extend(lint_source(os.path.join(dirpath, fn)))
    return rules.sort_findings(findings)
