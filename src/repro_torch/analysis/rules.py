"""Trace-safety / serve-hygiene lint rules (the port's own copy).

The reference's five per-module rules, with its rule ids, docs and
messages, so both analyzers report the same findings on the same
input.  Each rule encodes one bug class of the project's history:

=====================  ===================================================
rule-id                what it catches
=====================  ===================================================
env-import-snapshot    ``os.environ`` read at import time: flipping the
                       variable later is silently ignored.  Read it
                       inside the function that uses it.
truthy-version         a truthiness test on a version / ticket integer,
                       where 0 is a real version.  Compare ``is None`` /
                       ``== NO_TICKET`` explicitly.
wall-clock             ``time.time()`` in deadline / interval arithmetic:
                       NTP steps move the wall clock.  Use
                       ``time.monotonic()``; epoch stamps for display get
                       an inline ignore.
broad-except           a bare / overbroad ``except`` that drops the
                       exception, which can swallow ``UpdaterError`` and
                       turn a failed updater into silent staleness.  Fine
                       if the body re-raises or uses the bound exception.
jit-nondeterminism     Python-side nondeterminism (env reads, clocks,
                       ``random``) inside a function decorated with a
                       ``jit``: its first value is baked into the cached
                       trace.  The decorator is matched by name, as the
                       reference matches it; the port has no such
                       function, so the rule finds nothing in the port.
=====================  ===================================================
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional

from repro_torch.analysis.findings import Finding

#: identifiers whose truthiness is never a safe emptiness test
_VERSIONISH = re.compile(r"(?:^|_)(?:version|ticket)$")

#: dotted call names that are nondeterministic / Python-side impure
_NONDET_CALLS = (
    "time.time", "time.monotonic", "time.perf_counter", "os.getenv",
    "getenv", "uuid.uuid4", "uuid4", "datetime.now",
)
_NONDET_PREFIXES = ("random.", "np.random.", "numpy.random.",
                    "jax.random.PRNGKey")
_NONDET_SUFFIXES = ("resolve_interpret",)


def _dotted(node: ast.AST) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_env_read(node: ast.AST) -> bool:
    if isinstance(node, ast.Subscript) and \
            isinstance(node.ctx, ast.Load) and \
            _dotted(node.value) in ("os.environ", "environ"):
        return True
    if isinstance(node, ast.Call):
        name = _dotted(node.func)
        if name in ("os.environ.get", "environ.get", "os.getenv",
                    "getenv"):
            return True
    return False


def _qualname_stack(stack: List[str]) -> str:
    return ".".join(stack) if stack else "<module>"


# --------------------------------------------------------------------------
def check_env_import_snapshot(path: str, tree: ast.Module) -> List[Finding]:
    """env reads executed at import time (module or class body)."""
    findings: List[Finding] = []

    def visit(node: ast.AST, ctx: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue  # runs at call time, not import time
            if isinstance(child, ast.ClassDef):
                visit(child, child.name)
                continue
            if _is_env_read(child):
                findings.append(Finding(
                    path, child.lineno, "env-import-snapshot",
                    "os.environ read at import time: the value is "
                    "snapshotted once and later env changes are ignored "
                    "(the PR 3 INTERPRET class); read it inside the "
                    "function that needs it", ctx))
            visit(child, ctx)

    visit(tree, "<module>")
    return findings


# --------------------------------------------------------------------------
def check_truthy_version(path: str, tree: ast.Module) -> List[Finding]:
    """Truthiness tests on version/ticket integers where 0 is valid."""
    findings: List[Finding] = []
    func_stack: List[str] = []

    def versionish(expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Name) and _VERSIONISH.search(expr.id):
            return expr.id
        if isinstance(expr, ast.Attribute) and \
                _VERSIONISH.search(expr.attr):
            return _dotted(expr) or expr.attr
        return None

    def flag(expr: ast.AST) -> None:
        name = versionish(expr)
        if name is not None:
            findings.append(Finding(
                path, expr.lineno, "truthy-version",
                f"truthiness test on '{name}': 0 is a valid "
                f"version/ticket (the PR 5 at_version=0 class); compare "
                f"'is None' or '== NO_TICKET' explicitly",
                _qualname_stack(func_stack)))

    def expand_test(expr: ast.AST) -> None:
        if isinstance(expr, ast.BoolOp):
            for value in expr.values:
                expand_test(value)
            return
        if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Not):
            expand_test(expr.operand)
            return
        flag(expr)

    def visit(node: ast.AST) -> None:
        pushed = False
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            func_stack.append(node.name)
            pushed = True
        if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            expand_test(node.test)
        elif isinstance(node, ast.comprehension):
            for cond in node.ifs:
                expand_test(cond)
        elif isinstance(node, (ast.BoolOp,)):
            # `version or default` coerces truthiness outside a test too
            for value in node.values:
                flag(value)
        elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            flag(node.operand)
        for child in ast.iter_child_nodes(node):
            visit(child)
        if pushed:
            func_stack.pop()

    visit(tree)
    # dedup: BoolOp inside an If.test is flagged via both paths
    seen = set()
    out = []
    for f in findings:
        key = (f.line, f.message)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


# --------------------------------------------------------------------------
def check_wall_clock(path: str, tree: ast.Module) -> List[Finding]:
    """``time.time()`` anywhere: deadline/interval math must be
    monotonic; true epoch-timestamp uses carry an inline ignore."""
    findings: List[Finding] = []
    func_stack: List[str] = []

    def visit(node: ast.AST) -> None:
        pushed = False
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            func_stack.append(node.name)
            pushed = True
        if isinstance(node, ast.Call) and _dotted(node.func) == "time.time":
            findings.append(Finding(
                path, node.lineno, "wall-clock",
                "time.time() in served code: wall clock steps under NTP "
                "and corrupts deadline/interval arithmetic; use "
                "time.monotonic() (epoch stamps for display: "
                "'# analysis: ignore[wall-clock]')",
                _qualname_stack(func_stack)))
        for child in ast.iter_child_nodes(node):
            visit(child)
        if pushed:
            func_stack.pop()

    visit(tree)
    return findings


# --------------------------------------------------------------------------
def check_broad_except(path: str, tree: ast.Module) -> List[Finding]:
    """Broad ``except`` that drops the exception on the floor."""
    findings: List[Finding] = []
    func_stack: List[str] = []

    def is_broad(htype: Optional[ast.AST]) -> bool:
        if htype is None:
            return True
        names = []
        if isinstance(htype, ast.Tuple):
            names = [_dotted(e) for e in htype.elts]
        else:
            names = [_dotted(htype)]
        return any(n.split(".")[-1] in ("Exception", "BaseException")
                   for n in names if n)

    def swallows(handler: ast.ExceptHandler) -> bool:
        for node in ast.walk(handler):
            if isinstance(node, ast.Raise):
                return False
            if handler.name and isinstance(node, ast.Name) and \
                    node.id == handler.name and \
                    isinstance(node.ctx, ast.Load):
                return False  # exception is routed somewhere, not dropped
        return True

    def visit(node: ast.AST) -> None:
        pushed = False
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            func_stack.append(node.name)
            pushed = True
        if isinstance(node, ast.ExceptHandler) and is_broad(node.type) \
                and swallows(node):
            what = "bare except" if node.type is None else \
                "except " + (_dotted(node.type) or "Exception")
            findings.append(Finding(
                path, node.lineno, "broad-except",
                f"{what} drops the exception: this can swallow "
                f"UpdaterError and turn a dead updater into silent "
                f"staleness; re-raise, narrow the type, or route the "
                f"bound exception into the failure slot",
                _qualname_stack(func_stack)))
        for child in ast.iter_child_nodes(node):
            visit(child)
        if pushed:
            func_stack.pop()

    visit(tree)
    return findings


# --------------------------------------------------------------------------
def _is_jitted(fnode) -> bool:
    for deco in fnode.decorator_list:
        name = _dotted(deco if not isinstance(deco, ast.Call)
                       else deco.func)
        if name.split(".")[-1] == "jit":
            return True
        if isinstance(deco, ast.Call) and \
                name.split(".")[-1] == "partial" and deco.args and \
                _dotted(deco.args[0]).split(".")[-1] == "jit":
            return True
    return False


def check_jit_nondeterminism(path: str, tree: ast.Module) -> List[Finding]:
    """Python-side nondeterminism inside a jit-traced function."""
    findings: List[Finding] = []

    def nondet(call: ast.Call) -> Optional[str]:
        name = _dotted(call.func)
        if not name:
            return None
        if name in _NONDET_CALLS or _is_env_read(call):
            return name
        if any(name.startswith(p) for p in _NONDET_PREFIXES):
            return name
        if any(name.split(".")[-1] == s for s in _NONDET_SUFFIXES):
            return name
        return None

    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not _is_jitted(node):
            continue
        for inner in ast.walk(node):
            bad = None
            if isinstance(inner, ast.Call):
                bad = nondet(inner)
            elif _is_env_read(inner):
                bad = "os.environ"
            if bad:
                findings.append(Finding(
                    path, inner.lineno, "jit-nondeterminism",
                    f"'{bad}' inside jit-traced '{node.name}': runs once "
                    f"at trace time and its value is baked into the "
                    f"cached computation (the PR 3 INTERPRET class); "
                    f"hoist it outside the jit boundary and pass the "
                    f"result in", node.name))

    return findings


ALL_RULES = {
    "env-import-snapshot": check_env_import_snapshot,
    "truthy-version": check_truthy_version,
    "wall-clock": check_wall_clock,
    "broad-except": check_broad_except,
    "jit-nondeterminism": check_jit_nondeterminism,
}

#: rule-id -> one-line description, for --list-rules / README parity
LOCK_RULES = {
    "lock-order": "nested lock acquisition inverts the declared "
                  "hierarchy (PR 6 snapshot() hang class)",
    "lock-undeclared": "nested acquisition of a lock missing from "
                       "repro_torch/analysis/hierarchy.py",
    "lock-reentry": "re-acquisition of a non-reentrant lock "
                    "(self-deadlock)",
    "cond-wait-unheld": "Condition.wait/notify without holding the "
                        "condition",
    "unlocked-attr": "lock-protected attribute accessed outside any "
                     "with block",
}
RULE_DOCS = {
    "env-import-snapshot": "os.environ read at import time "
                           "(PR 3 INTERPRET class)",
    "truthy-version": "truthiness test on version/ticket ints where 0 "
                      "is valid (PR 5 at_version=0 class)",
    "wall-clock": "time.time() where deadline math needs "
                  "time.monotonic()",
    "broad-except": "broad except that can swallow UpdaterError",
    "jit-nondeterminism": "Python-side nondeterminism inside a "
                          "jit-traced function",
    **LOCK_RULES,
}


def run(path: str, tree: ast.Module) -> List[Finding]:
    """Run every per-module rule over one parsed module."""
    findings: List[Finding] = []
    for checker in ALL_RULES.values():
        findings.extend(checker(path, tree))
    return findings
