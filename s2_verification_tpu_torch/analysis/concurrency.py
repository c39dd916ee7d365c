"""concurrency: unlocked shared-state writes in thread-spawning classes.

Rule ``concurrency-unlocked-write`` (error)
-------------------------------------------

Scope: classes that spawn threads (``threading.Thread``/``Timer`` with a
``target=`` bound to ``self`` or to a nested closure), hand bound methods to
an executor (``pool.submit(self.x)``), or register bound-method callbacks
invoked from foreign threads (``gc.callbacks.append(self.x)``).

Within such a class we build the ``self.*`` call graph and compute, for
every method, the set of *entry points* that can reach it:

- each spawned/submitted/registered target is its own entry (one thread);
- the public surface (non-underscore methods, ``__call__``/``__enter__``/
  ``__exit__``) is one collective entry — any caller thread.

An attribute is **shared** when an *unlocked write* to it happens in method
M and *any* access happens in method N with ``entries(M) ∪ entries(N)`` ≥ 2
distinct entries (M may equal N: a method both public and used as a thread
target races against itself).  Shared attributes must be written under a
held ``with self._lock``-style context (any ``with`` whose subject name
matches ``lock|cv|cond|mu``) or be a declared thread-safe type.

Exemptions — the repo's established discipline, encoded:

- ``__init__`` / ``__del__`` bodies (construction happens-before publish);
- methods named ``*_locked`` (contract: caller holds the lock);
- attributes constructed in ``__init__`` from thread-safe types
  (``threading.Event/Lock/RLock/Condition/Semaphore``, ``queue.*``,
  ``collections.deque``, ``itertools.count`` — their mutators are atomic);
- attributes whose own name matches the lock pattern.
"""

from __future__ import annotations

import ast
import re

from .engine import ERROR, FileInfo, FilePass, Finding, dotted_name

_LOCKISH = re.compile(r"lock|cv|cond|mu(tex)?$", re.I)
_THREADSAFE_CTORS = re.compile(
    r"(^|\.)(Event|Lock|RLock|Condition|Semaphore|BoundedSemaphore|Barrier|"
    r"Queue|SimpleQueue|LifoQueue|PriorityQueue|deque|count)$"
)
_MUTATORS = {
    "append",
    "appendleft",
    "add",
    "update",
    "pop",
    "popleft",
    "popitem",
    "setdefault",
    "clear",
    "extend",
    "remove",
    "discard",
    "insert",
    "sort",
    "reverse",
}
_SPAWN_CALLS = re.compile(r"(^|\.)(Thread|Timer)$")
_PUBLIC_DUNDERS = {"__call__", "__enter__", "__exit__", "__iter__", "__next__"}
_EXEMPT_METHODS = {"__init__", "__del__", "__post_init__"}

PUBLIC = "<public>"


def _self_attr(node: ast.AST) -> str | None:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _target_self_method(node: ast.expr) -> str | None:
    """self.X, or functools.partial(self.X, ...) -> 'X'."""
    attr = _self_attr(node)
    if attr:
        return attr
    if isinstance(node, ast.Call):
        fname = dotted_name(node.func)
        if fname in ("partial", "functools.partial") and node.args:
            return _self_attr(node.args[0])
    return None


def _target_local_name(node: ast.expr) -> str | None:
    if isinstance(node, ast.Name):
        return node.id
    return None


def _lockish_expr(node: ast.expr) -> bool:
    attr = _self_attr(node)
    if attr is not None:
        return bool(_LOCKISH.search(attr))
    if isinstance(node, ast.Name):
        return bool(_LOCKISH.search(node.id))
    if isinstance(node, ast.Attribute):
        return bool(_LOCKISH.search(node.attr))
    return False


class _Access:
    __slots__ = ("attr", "write", "locked", "atomic", "line", "method")

    def __init__(self, attr: str, write: bool, locked: bool, atomic: bool, line: int, method: str):
        self.attr = attr
        self.write = write
        self.locked = locked
        self.atomic = atomic  # plain rebind vs read-modify-write
        self.line = line
        self.method = method


class _MethodFacts:
    def __init__(self, name: str):
        self.name = name
        self.accesses: list[_Access] = []
        self.calls: set[str] = set()  # self.X() targets (and local closures)
        self.spawn_entries: set[str] = set()  # methods/closures used as targets


class _MethodVisitor(ast.NodeVisitor):
    """Collect accesses/calls for one method body; nested closures become
    their own pseudo-methods named ``outer.<inner>`` and are implicitly
    'called' by the outer method unless only used as a thread target."""

    def __init__(self, facts: _MethodFacts, all_facts: dict[str, _MethodFacts]):
        self.facts = facts
        self.all = all_facts
        self.lock_depth = 0

    # -- lock scoping ------------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        lockish = any(_lockish_expr(item.context_expr) for item in node.items)
        for item in node.items:
            self.visit(item.context_expr)
        if lockish:
            self.lock_depth += 1
        for stmt in node.body:
            self.visit(stmt)
        if lockish:
            self.lock_depth -= 1

    visit_AsyncWith = visit_With  # type: ignore[assignment]

    # -- nested closures ---------------------------------------------------
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        sub_name = f"{self.facts.name}.{node.name}"
        sub = _MethodFacts(sub_name)
        self.all[sub_name] = sub
        v = _MethodVisitor(sub, self.all)
        for stmt in node.body:
            v.visit(stmt)
        # outer method can call the closure locally
        self.facts.calls.add(sub_name)

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self.visit(node.body)

    # -- accesses ----------------------------------------------------------
    def _rec(self, attr: str | None, write: bool, atomic: bool, line: int) -> None:
        if attr is None:
            return
        self.facts.accesses.append(
            _Access(attr, write, self.lock_depth > 0, atomic, line, self.facts.name)
        )

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            if isinstance(t, ast.Tuple):
                for el in t.elts:
                    self._assign_target(el)
            else:
                self._assign_target(t)
        self.visit(node.value)

    def _assign_target(self, t: ast.expr) -> None:
        attr = _self_attr(t)
        if attr is not None:
            self._rec(attr, write=True, atomic=True, line=t.lineno)
            return
        if isinstance(t, ast.Subscript):
            attr = _self_attr(t.value)
            if attr is not None:
                self._rec(attr, write=True, atomic=False, line=t.lineno)
            else:
                self.visit(t.value)
            self.visit(t.slice)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        attr = _self_attr(node.target)
        if attr is not None:
            self._rec(attr, write=True, atomic=False, line=node.lineno)
        elif isinstance(node.target, ast.Subscript):
            sub = _self_attr(node.target.value)
            if sub is not None:
                self._rec(sub, write=True, atomic=False, line=node.lineno)
        self.visit(node.value)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            if isinstance(t, ast.Subscript):
                attr = _self_attr(t.value)
                if attr is not None:
                    self._rec(attr, write=True, atomic=False, line=node.lineno)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        # self.X(...)  -> call edge
        callee = _self_attr(node.func)
        if callee is not None:
            self.facts.calls.add(callee)
        # self.attr.mutator(...)  -> non-atomic write to attr
        if isinstance(node.func, ast.Attribute) and node.func.attr in _MUTATORS:
            attr = _self_attr(node.func.value)
            if attr is not None:
                self._rec(attr, write=True, atomic=False, line=node.lineno)
        # thread spawn / executor submit / callback registration
        fname = dotted_name(node.func) or ""
        if _SPAWN_CALLS.search(fname):
            for kw in node.keywords:
                if kw.arg == "target":
                    self._record_entry(kw.value)
            # Timer(interval, self.cb)
            if fname.endswith("Timer") and len(node.args) >= 2:
                self._record_entry(node.args[1])
        elif isinstance(node.func, ast.Attribute) and node.func.attr == "submit" and node.args:
            self._record_entry(node.args[0])
        elif (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "append"
            and dotted_name(node.func.value) in ("gc.callbacks",)
            and node.args
        ):
            self._record_entry(node.args[0])
        self.generic_visit(node)

    def _record_entry(self, node: ast.expr) -> None:
        m = _target_self_method(node)
        if m is not None:
            self.facts.spawn_entries.add(m)
            return
        local = _target_local_name(node)
        if local is not None:
            self.facts.spawn_entries.add(f"{self.facts.name}.{local}")

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr is not None and isinstance(node.ctx, ast.Load):
            self._rec(attr, write=False, atomic=True, line=node.lineno)
        self.generic_visit(node)


class ConcurrencyPass(FilePass):
    name = "concurrency"

    def check_file(self, info: FileInfo) -> list[Finding]:
        tree = info.tree
        assert tree is not None
        out: list[Finding] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                out.extend(self._check_class(info, node))
        return out

    def _check_class(self, info: FileInfo, cls: ast.ClassDef) -> list[Finding]:
        facts: dict[str, _MethodFacts] = {}
        threadsafe_attrs: set[str] = set()

        for item in cls.body:
            if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            mf = _MethodFacts(item.name)
            facts[item.name] = mf
            v = _MethodVisitor(mf, facts)
            for stmt in item.body:
                v.visit(stmt)
            if item.name == "__init__":
                for stmt in ast.walk(item):
                    if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
                        ctor = dotted_name(stmt.value.func) or ""
                        if _THREADSAFE_CTORS.search(ctor):
                            for t in stmt.targets:
                                attr = _self_attr(t)
                                if attr:
                                    threadsafe_attrs.add(attr)

        # thread entries declared anywhere in the class
        entries: set[str] = set()
        for mf in facts.values():
            entries.update(e for e in mf.spawn_entries if e in facts)
        if not entries:
            return []  # class spawns nothing trackable — out of scope

        public = {
            name
            for name in facts
            if (not name.startswith("_") and "." not in name) or name in _PUBLIC_DUNDERS
        }

        # entry -> reachable methods via the self-call graph
        def reachable(start: set[str]) -> set[str]:
            seen = set(start)
            work = list(start)
            while work:
                cur = work.pop()
                mf = facts.get(cur)
                if mf is None:
                    continue
                for callee in mf.calls:
                    if callee in facts and callee not in seen:
                        seen.add(callee)
                        work.append(callee)
            return seen

        method_entries: dict[str, set[str]] = {name: set() for name in facts}
        for e in sorted(entries):
            for m in reachable({e}):
                method_entries[m].add(e)
        for m in reachable(public):
            method_entries[m].add(PUBLIC)

        # collect per-attribute access sites
        by_attr: dict[str, list[_Access]] = {}
        for mf in facts.values():
            segments = mf.name.split(".")
            if segments[0] in _EXEMPT_METHODS:
                continue
            if any(seg.endswith("_locked") for seg in segments):
                continue
            for acc in mf.accesses:
                by_attr.setdefault(acc.attr, []).append(acc)

        out: list[Finding] = []
        reported: set[tuple[str, str]] = set()
        for attr, accs in sorted(by_attr.items()):
            if attr in threadsafe_attrs or _LOCKISH.search(attr):
                continue
            first_read: dict[str, int] = {}
            for a in accs:
                if not a.write:
                    cur = first_read.get(a.method)
                    if cur is None or a.line < cur:
                        first_read[a.method] = a.line
            for w in accs:
                if not w.write or w.locked:
                    continue
                # A plain rebind not preceded by a read of the same attr in
                # the same method is one-shot publication (`self._stop = ev`,
                # `self._loop = get_running_loop()` then local use): the GIL
                # makes the store atomic and the repo's Event-handshake idiom
                # orders it.  Only read-THEN-write shapes (delta computation,
                # check-then-act) race.
                if w.atomic and first_read.get(w.method, w.line + 1) > w.line:
                    continue
                w_entries = method_entries.get(w.method, set())
                for other in accs:
                    o_entries = method_entries.get(other.method, set())
                    joint = w_entries | o_entries
                    if len(joint) < 2:
                        continue
                    key = (attr, w.method)
                    if key in reported:
                        break
                    reported.add(key)
                    out.append(
                        Finding(
                            "concurrency-unlocked-write",
                            ERROR,
                            info.rel,
                            w.line,
                            f"{cls.name}.{attr} written outside a lock in "
                            f"'{w.method}' but reachable from multiple thread "
                            "entry points — guard with the instance lock or use "
                            "a thread-safe type",
                        )
                    )
                    break
        return out
