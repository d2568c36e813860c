"""AST lock-order + lock-hygiene analyzer (the port's own copy).

What it does, per scanned file set:

1. **Registry.**  Finds every lock *creation* site: ``self.X =
   make_lock("canonical.name")`` / ``make_rlock`` / ``make_condition``
   (the ``repro_torch.analysis.shadow`` factories, which carry the
   canonical hierarchy name) and raw ``threading.Lock/RLock/Condition()``
   constructors (which yield *anonymous* locks -- legal as leaves,
   flagged the moment they participate in a nested acquisition).

2. **Acquisition structure.**  For every method (and nested function) it
   tracks the set of locks held at each point: ``with self.X:`` blocks,
   ``self.X.acquire()`` / ``.release()`` pairs (branch acquisitions leak
   conservatively to subsequent statements), and ``@locks_required``
   seeds for functions whose contract is "caller holds the lock".

3. **Call edges.**  Calls made while holding a lock are resolved to
   methods of scanned classes -- ``self.m()`` directly, ``self.attr.m()``
   through ``__init__`` parameter annotations / direct constructor
   assignments, property loads (``self.service.applied``) through the
   same type map, and otherwise by method-name match across scanned
   classes -- and each callee's *transitive* acquisitions become nested
   pairs under the held locks (fixed point over the call graph).

4. **Checks.**  Every nested pair must move strictly down the declared
   hierarchy (``repro_torch.analysis.hierarchy``):

   ===================  ===================================================
   rule-id              fires when
   ===================  ===================================================
   lock-order           nested acquisition whose ranks do not strictly
                        increase (the deadlock / lock-convoy class: a
                        ``snapshot()`` that hung behind a convoy)
   lock-undeclared      a nested acquisition involves a lock with no
                        canonical name or rank
   lock-reentry         re-acquisition of a non-reentrant lock already
                        held by the same thread (self-deadlock)
   cond-wait-unheld     ``Condition.wait/notify`` outside any ``with``
                        of that condition (runtime error / lost wakeup)
   unlocked-attr        an attribute that is *written under a lock*
                        somewhere in its class is read or written with
                        no lock held (torn read / lost update)
   ===================  ===================================================

Known static limits (by design, documented here): lambda bodies are not
analyzed; distinct *instances* of the same class/attr lock are one
static lock; calls through local variables (e.g. a serving closure
handed across threads) are not linked.  The runtime shadow checker
(``repro_torch.analysis.shadow``) covers those paths with real
acquisition stacks.

Rule ids, messages and the order of the findings are the reference's
(``repro.analysis.lockorder``), but for the hierarchy's path in them.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis import hierarchy
from repro_torch.analysis.findings import Finding

#: shadow factory name -> (kind, reentrant)
LOCK_FACTORIES = {
    "make_lock": ("lock", False),
    "make_rlock": ("rlock", True),
    "make_condition": ("condition", True),
}

#: raw threading constructor -> (kind, reentrant)
THREADING_CTORS = {
    "Lock": ("lock", False),
    "RLock": ("rlock", True),
    "Condition": ("condition", True),
}

#: Method names never linked by the name-match fallback: they collide
#: with stdlib/container idioms and would fabricate call edges.
_FALLBACK_SKIP = frozenset({
    "get", "put", "append", "pop", "popleft", "extend", "clear", "join",
    "set", "is_set", "items", "keys", "values", "add", "remove",
    "update", "copy", "format", "reshape", "astype", "min", "max",
    "sum", "mean", "any", "all", "wait", "sort", "index", "count",
    "split", "strip", "startswith", "endswith", "qsize", "release",
    "acquire", "notify", "notify_all", "start", "close",
})

Key = Tuple[str, str]  # (class name, attribute name)


@dataclasses.dataclass(frozen=True)
class LockInfo:
    cls: str
    attr: str
    name: Optional[str]      # canonical hierarchy name (None = anonymous)
    kind: str                # lock | rlock | condition
    reentrant: bool
    path: str
    line: int

    @property
    def display(self) -> str:
        return self.name if self.name else f"{self.cls}.{self.attr}"


@dataclasses.dataclass
class ClassInfo:
    name: str
    path: str
    locks: Dict[str, LockInfo] = dataclasses.field(default_factory=dict)
    methods: Dict[str, ast.AST] = dataclasses.field(default_factory=dict)
    properties: Set[str] = dataclasses.field(default_factory=set)
    attr_types: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class FunctionResult:
    cls: str
    name: str                # method name (nested defs get dotted names)
    path: str
    acquires: Set[Key] = dataclasses.field(default_factory=set)
    #: direct nesting: (outer key, inner key, line)
    pairs: List[Tuple[Key, Key, int]] = dataclasses.field(
        default_factory=list)
    #: (held keys at site, receiver descriptor, line)
    calls: List[Tuple[Tuple[Key, ...], tuple, int]] = dataclasses.field(
        default_factory=list)
    #: (attr, is_store, held?, line) for the unlocked-attr rule
    accesses: List[Tuple[str, bool, bool, int]] = dataclasses.field(
        default_factory=list)

    @property
    def qualname(self) -> str:
        return f"{self.cls}.{self.name}"


def _multiset_diff(after: List[Key], before: List[Key]) -> List[Key]:
    out = list(after)
    for key in before:
        if key in out:
            out.remove(key)
    return out


def _dotted(node: ast.AST) -> str:
    """'a.b.c' for nested Attribute/Name chains, '' otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _call_name(func: ast.AST) -> str:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return ""


def _str_arg(call: ast.Call) -> Optional[str]:
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


class Program:
    """All scanned modules: registry, analyses and the pair checker."""

    def __init__(self) -> None:
        self.classes: Dict[str, ClassInfo] = {}
        self.functions: Dict[Tuple[str, str], FunctionResult] = {}
        self.findings: List[Finding] = []

    # -- phase A: registry ---------------------------------------------------
    def scan_module(self, path: str, tree: ast.Module) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                self._scan_class(path, node)

    def _scan_class(self, path: str, cnode: ast.ClassDef) -> None:
        info = self.classes.setdefault(cnode.name,
                                       ClassInfo(cnode.name, path))
        for item in cnode.body:
            if not isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            info.methods[item.name] = item
            for deco in item.decorator_list:
                if _dotted(deco).split(".")[-1] in ("property",
                                                    "cached_property"):
                    info.properties.add(item.name)
            self._scan_method_assignments(path, cnode.name, item, info)

    def _scan_method_assignments(self, path, cls, fnode, info) -> None:
        ann = {a.arg: _dotted(a.annotation).split(".")[-1]
               for a in fnode.args.args
               if a.annotation is not None and _dotted(a.annotation)}
        for node in ast.walk(fnode):
            target = value = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target, value = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                target, value = node.target, node.value
                if node.annotation is not None and _dotted(node.annotation):
                    if isinstance(target, ast.Attribute) and \
                            isinstance(target.value, ast.Name) and \
                            target.value.id == "self":
                        info.attr_types[target.attr] = \
                            _dotted(node.annotation).split(".")[-1]
            if not (isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"):
                continue
            attr = target.attr
            # lock creation sites
            if isinstance(value, ast.Call):
                fname = _call_name(value.func)
                if fname in LOCK_FACTORIES:
                    kind, reent = LOCK_FACTORIES[fname]
                    name = _str_arg(value)
                    info.locks[attr] = LockInfo(
                        cls, attr, name, kind,
                        reent or (name in hierarchy.REENTRANT),
                        path, node.lineno)
                elif fname in THREADING_CTORS and \
                        _dotted(value.func).startswith(("threading.",
                                                        fname)):
                    kind, reent = THREADING_CTORS[fname]
                    info.locks[attr] = LockInfo(cls, attr, None, kind,
                                                reent, path, node.lineno)
                elif fname and fname[0].isupper() and \
                        isinstance(value.func, ast.Name):
                    info.attr_types.setdefault(attr, fname)
            # attr type from annotated parameter: self._x = param
            if isinstance(value, ast.Name) and value.id in ann:
                info.attr_types.setdefault(attr, ann[value.id])

    # -- phase B: per-function analysis --------------------------------------
    def analyze_all(self) -> None:
        for cname, cinfo in self.classes.items():
            for mname, fnode in list(cinfo.methods.items()):
                self._analyze_function(cinfo, mname, fnode)

    def _seed_held(self, fnode) -> List[Key]:
        held: List[Key] = []
        for deco in getattr(fnode, "decorator_list", ()):
            if isinstance(deco, ast.Call) and \
                    _call_name(deco.func) == "locks_required":
                for arg in deco.args:
                    if isinstance(arg, ast.Constant) and \
                            isinstance(arg.value, str):
                        key = self._key_for_canonical(arg.value)
                        if key is not None:
                            held.append(key)
        return held

    def _key_for_canonical(self, name: str) -> Optional[Key]:
        for cinfo in self.classes.values():
            for attr, lk in cinfo.locks.items():
                if lk.name == name:
                    return (cinfo.name, attr)
        return None

    def _lock_for(self, key: Key) -> Optional[LockInfo]:
        cinfo = self.classes.get(key[0])
        return cinfo.locks.get(key[1]) if cinfo else None

    def _analyze_function(self, cinfo: ClassInfo, name: str,
                          fnode) -> FunctionResult:
        res = FunctionResult(cinfo.name, name, cinfo.path)
        self.functions[(cinfo.name, name)] = res
        held = self._seed_held(fnode)
        nested: List[Tuple[str, ast.AST]] = []

        def resolve_lock(node) -> Optional[Key]:
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id == "self" and node.attr in cinfo.locks:
                return (cinfo.name, node.attr)
            return None

        def record_acquisition(key: Key, line: int) -> None:
            res.acquires.add(key)
            for h in held:
                res.pairs.append((h, key, line))

        def walk_expr(node) -> None:
            if node is None or isinstance(node, ast.Lambda):
                return  # lambda bodies: see module doc (static limit)
            if isinstance(node, ast.Call):
                func = node.func
                if isinstance(func, ast.Attribute):
                    key = resolve_lock(func.value)
                    if key is not None:
                        lk = self._lock_for(key)
                        if func.attr == "acquire":
                            record_acquisition(key, node.lineno)
                            held.append(key)
                        elif func.attr == "release":
                            if key in held:
                                held.remove(key)
                        elif func.attr in ("wait", "wait_for", "notify",
                                           "notify_all"):
                            if key not in held:
                                self.findings.append(Finding(
                                    cinfo.path, node.lineno,
                                    "cond-wait-unheld",
                                    f"'{lk.display}.{func.attr}()' called "
                                    f"without holding the condition: "
                                    f"runtime RuntimeError or lost wakeup",
                                    res.qualname))
                        for arg in list(node.args) + \
                                [k.value for k in node.keywords]:
                            walk_expr(arg)
                        return
                    # ordinary method call site
                    desc = self._receiver_desc(func)
                    res.calls.append((tuple(held), desc, node.lineno))
                    walk_expr(func.value)
                else:
                    walk_expr(func)
                for arg in node.args:
                    walk_expr(arg)
                for kw in node.keywords:
                    walk_expr(kw.value)
                return
            if isinstance(node, ast.Attribute):
                # self.X access (unlocked-attr) ...
                if isinstance(node.value, ast.Name) and \
                        node.value.id == "self":
                    res.accesses.append(
                        (node.attr, isinstance(node.ctx, ast.Store),
                         bool(held), node.lineno))
                # ... and potential property-with-lock edge
                if isinstance(node.ctx, ast.Load):
                    desc = self._receiver_desc(node)
                    res.calls.append((tuple(held), ("prop",) + desc[1:],
                                      node.lineno))
            for child in ast.iter_child_nodes(node):
                walk_expr(child)

        def walk_stmt(stmt) -> None:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                nested.append((f"{name}.<locals>.{stmt.name}", stmt))
                return
            if isinstance(stmt, ast.ClassDef):
                return
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                added: List[Key] = []
                for item in stmt.items:
                    key = resolve_lock(item.context_expr)
                    if key is not None:
                        record_acquisition(key, item.context_expr.lineno)
                        held.append(key)
                        added.append(key)
                    else:
                        walk_expr(item.context_expr)
                for s in stmt.body:
                    walk_stmt(s)
                for key in reversed(added):
                    held.remove(key)
                return
            if isinstance(stmt, ast.If):
                # branches are mutually exclusive: walk each from the
                # same base held set, then keep the union of what either
                # branch left acquired (conservative leak)
                walk_expr(stmt.test)
                base = list(held)
                for s in stmt.body:
                    walk_stmt(s)
                body_adds = _multiset_diff(held, base)
                held[:] = base
                for s in stmt.orelse:
                    walk_stmt(s)
                orelse_adds = _multiset_diff(held, base)
                held[:] = base
                for key in dict.fromkeys(body_adds + orelse_adds):
                    held.append(key)
                return
            if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                for t in targets:
                    base = t
                    while isinstance(base, ast.Subscript):
                        base = base.value
                    if isinstance(base, ast.Attribute) and \
                            isinstance(base.value, ast.Name) and \
                            base.value.id == "self":
                        res.accesses.append((base.attr, True, bool(held),
                                             t.lineno))
                    elif not isinstance(t, ast.Name):
                        walk_expr(t)
                walk_expr(getattr(stmt, "value", None))
                return
            # compound statements: walk tests/iterables as expressions,
            # bodies as statements, all against the same (conservatively
            # leaking) held list
            for field in ("test", "iter", "exc", "cause", "value",
                          "subject"):
                walk_expr(getattr(stmt, field, None))
            for field in ("body", "orelse", "finalbody"):
                for s in getattr(stmt, field, ()) or ():
                    walk_stmt(s)
            for handler in getattr(stmt, "handlers", ()) or ():
                for s in handler.body:
                    walk_stmt(s)

        for s in fnode.body:
            walk_stmt(s)
        # Nested defs get a fresh held set: they run on whatever thread
        # later calls them, which the static pass cannot see -- the
        # shadow checker covers those runtime stacks.
        for nested_name, nnode in nested:
            self._analyze_function(cinfo, nested_name, nnode)
        return res

    def _receiver_desc(self, node: ast.Attribute) -> tuple:
        v = node.value
        if isinstance(v, ast.Name) and v.id == "self":
            return ("self", node.attr)
        if isinstance(v, ast.Attribute) and \
                isinstance(v.value, ast.Name) and v.value.id == "self":
            return ("self_attr", v.attr, node.attr)
        return ("other", node.attr)

    # -- phase C: linking + checks -------------------------------------------
    def _resolve_callees(self, caller_cls: str,
                         desc: tuple) -> List[Tuple[str, str]]:
        if desc[0] == "self":
            m = desc[1]
            if m in self.classes.get(caller_cls,
                                     ClassInfo("", "")).methods:
                return [(caller_cls, m)]
            return []
        if desc[0] in ("self_attr",):
            attr, m = desc[1], desc[2]
            t = self.classes.get(caller_cls,
                                 ClassInfo("", "")).attr_types.get(attr)
            if t in self.classes and m in self.classes[t].methods:
                return [(t, m)]
            return self._fallback(m, prop=False)
        if desc[0] == "prop":
            m = desc[-1]
            if len(desc) == 3:  # ("prop", attr, name) from self.attr.name
                attr = desc[1]
                t = self.classes.get(caller_cls,
                                     ClassInfo("", "")).attr_types.get(attr)
                if t in self.classes:
                    if m in self.classes[t].properties:
                        return [(t, m)]
                    return []
            return self._fallback(m, prop=True)
        return self._fallback(desc[-1], prop=False)

    def _fallback(self, m: str, *, prop: bool) -> List[Tuple[str, str]]:
        if m in _FALLBACK_SKIP or m.startswith("__"):
            return []
        out = []
        for cname, cinfo in self.classes.items():
            if m in cinfo.methods and (not prop or m in cinfo.properties):
                out.append((cname, m))
        return out

    def _transitive_acquires(self) -> Dict[Tuple[str, str], Set[Key]]:
        trans = {fid: set(fr.acquires)
                 for fid, fr in self.functions.items()}
        changed = True
        while changed:
            changed = False
            for fid, fr in self.functions.items():
                for _, desc, _ in fr.calls:
                    for callee in self._resolve_callees(fr.cls, desc):
                        extra = trans.get(callee, set()) - trans[fid]
                        if extra:
                            trans[fid] |= extra
                            changed = True
        return trans

    def check(self) -> List[Finding]:
        trans = self._transitive_acquires()
        pairs: List[Tuple[Key, Key, str, int, str]] = []
        for fid, fr in self.functions.items():
            for a, b, line in fr.pairs:
                pairs.append((a, b, fr.path, line, fr.qualname))
            for held, desc, line in fr.calls:
                if not held:
                    continue
                for callee in self._resolve_callees(fr.cls, desc):
                    for b in trans.get(callee, ()):
                        for a in held:
                            pairs.append((a, b, fr.path, line,
                                          fr.qualname))
        seen = set()
        edges: Dict[str, Set[str]] = {}
        for a, b, path, line, ctx in pairs:
            la, lb = self._lock_for(a), self._lock_for(b)
            if la is None or lb is None:
                continue
            dedup = (a, b, path, line)
            if dedup in seen:
                continue
            seen.add(dedup)
            if a == b:
                if not la.reentrant:
                    self.findings.append(Finding(
                        path, line, "lock-reentry",
                        f"re-acquisition of non-reentrant lock "
                        f"'{la.display}' while already held: "
                        f"self-deadlock", ctx))
                continue
            ra = hierarchy.RANKS.get(la.name) if la.name else None
            rb = hierarchy.RANKS.get(lb.name) if lb.name else None
            if ra is None or rb is None:
                missing = la.display if ra is None else lb.display
                self.findings.append(Finding(
                    path, line, "lock-undeclared",
                    f"nested acquisition of '{lb.display}' while holding "
                    f"'{la.display}': '{missing}' is not in the declared "
                    f"hierarchy (repro_torch/analysis/hierarchy.py); create "
                    f"it through the shadow factories and declare its rank",
                    ctx))
                continue
            edges.setdefault(la.name, set()).add(lb.name)
            if ra >= rb:
                self.findings.append(Finding(
                    path, line, "lock-order",
                    f"acquires '{lb.name}' (rank {rb}) while holding "
                    f"'{la.name}' (rank {ra}): inverts the declared "
                    f"hierarchy (repro_torch/analysis/hierarchy.py)", ctx))
        self._check_cycles(edges)
        self._check_unlocked_attrs()
        return self.findings

    def _check_cycles(self, edges: Dict[str, Set[str]]) -> None:
        """Report cycles in the observed nesting digraph.  With a total
        declared order every cycle also contains a rank inversion, so
        this is a defensive second witness that names the whole loop."""
        state: Dict[str, int] = {}
        stack: List[str] = []

        def dfs(node: str) -> None:
            state[node] = 1
            stack.append(node)
            for nxt in sorted(edges.get(node, ())):
                if state.get(nxt) == 1:
                    cycle = stack[stack.index(nxt):] + [nxt]
                    self.findings.append(Finding(
                        "<lock-graph>", 0, "lock-order",
                        f"cycle in observed lock nesting: "
                        f"{' -> '.join(cycle)}", "<graph>"))
                elif state.get(nxt) is None:
                    dfs(nxt)
            stack.pop()
            state[node] = 2

        for node in sorted(edges):
            if state.get(node) is None:
                dfs(node)

    def _check_unlocked_attrs(self) -> None:
        protected: Dict[str, Set[str]] = {}
        for (cls, mname), fr in self.functions.items():
            if mname == "__init__" or not self.classes.get(cls, None) \
                    or not self.classes[cls].locks:
                continue
            for attr, is_store, under, _ in fr.accesses:
                if is_store and under:
                    protected.setdefault(cls, set()).add(attr)
        for (cls, mname), fr in self.functions.items():
            if mname == "__init__":
                continue
            prot = protected.get(cls, ())
            for attr, is_store, under, line in fr.accesses:
                if attr in prot and not under:
                    self.findings.append(Finding(
                        fr.path, line, "unlocked-attr",
                        f"'self.{attr}' is written under a lock elsewhere "
                        f"in {cls} but accessed here with no lock held "
                        f"(torn read / lost update); guard it, or mark an "
                        f"intentional lock-free read with "
                        f"'# analysis: ignore[unlocked-attr]'",
                        fr.qualname))


def analyze(modules: List[Tuple[str, ast.Module]]) -> List[Finding]:
    """Run the lock analyses over parsed ``(path, tree)`` modules."""
    prog = Program()
    for path, tree in modules:
        prog.scan_module(path, tree)
    prog.analyze_all()
    return prog.check()
