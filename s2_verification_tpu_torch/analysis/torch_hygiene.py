"""torch-hygiene: the port's counterpart of the JAX package's jit-hygiene.

The port has no ``jax.jit`` sites.  What it has in their place are lazy
kernel builds (``nvcc`` / ``g++`` into ``_build/``, loaded through
``ctypes``) and host syncs between PyTorch launches.  Each rule here is
the PyTorch meaning of a jit-hygiene rule:

``build-unrecorded`` (error; jit-hygiene's ``jit-unwrapped``)
    A function that runs a compiler through ``subprocess.run`` / ``Popen``
    (an argv that starts with ``nvcc_path()``, a compiler's name such as
    ``"g++"``, or a name bound to one of those) must call
    ``obs.introspect.record_build``.  An unrecorded build is invisible to
    the introspector and to the job's trace, as an unwrapped jit's
    compiles are.

``build-in-loop`` (error; ``jit-in-loop``)
    A build entry (``build(``, ``compile_library(``, ``ctypes.CDLL(``,
    ``torch.utils.cpp_extension.load*(``) inside a ``for`` / ``while``
    body asks for a build (or at least a library load) every iteration.

``sync-in-loop`` (error; ``jit-traced-branch``)
    A host sync (``_fetch(``, ``.item()``, ``.tolist()``, ``.cpu()``,
    ``torch.cuda.synchronize()``) inside a ``for`` / ``while`` body of
    ``checker/device.py``, ``ops/`` or ``parallel/``.  Reading a device
    value in Python inside the program is refused under ``jax.jit``; in
    the port it is allowed, but each one is a device round trip per
    iteration.  The message names the function and the sync, not the
    line, so the baseline key survives edits and the count of syncs in
    the layer loops is a ratchet.

jit-hygiene's ``jit-unhashable-static`` has no counterpart: the port's
builds key on one bool (``trace``), never on a user's static arguments.

"In a loop" means in a ``for`` body or a ``while`` test or body of the
same function: a loop's ``iter`` and ``else`` run once, and a function or
lambda defined in a loop starts afresh.
"""

from __future__ import annotations

import ast
import os

from .engine import ERROR, FileInfo, FilePass, Finding, dotted_name

#: executables that compile (matched on the basename of a string literal)
_COMPILERS = {"nvcc", "g++", "gcc", "c++", "cc", "clang", "clang++"}
#: functions whose result is a compiler's path
_COMPILER_FUNCS = {"nvcc_path"}
_RUNNERS = {"subprocess.run", "subprocess.Popen"}
_BUILD_ENTRIES = {"build", "compile_library", "CDLL"}
_SYNC_METHODS = {"item", "tolist", "cpu"}
#: bodies that do not run where they are written
_NEW_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _last(name: str | None) -> str:
    return (name or "").rpartition(".")[2]


def _loop_calls(fn: ast.AST):
    """Yield every ``ast.Call`` that runs once per iteration of a loop in
    ``fn``'s own body (nested functions and lambdas excluded)."""

    def visit(node: ast.AST, in_loop: bool):
        if isinstance(node, _NEW_SCOPES):
            return
        if isinstance(node, (ast.For, ast.AsyncFor)):
            yield from visit(node.target, in_loop)
            yield from visit(node.iter, in_loop)
            for sub in node.body:
                yield from visit(sub, True)
            for sub in node.orelse:
                yield from visit(sub, in_loop)
            return
        if isinstance(node, ast.While):
            yield from visit(node.test, True)
            for sub in node.body:
                yield from visit(sub, True)
            for sub in node.orelse:
                yield from visit(sub, in_loop)
            return
        if in_loop and isinstance(node, ast.Call):
            yield node
        for child in ast.iter_child_nodes(node):
            yield from visit(child, in_loop)

    for stmt in fn.body:
        yield from visit(stmt, False)


def _scopes(tree: ast.AST):
    """``(name, node)`` for the module and every function in it."""
    yield "<module>", tree
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name, node


def _own_nodes(scope: ast.AST):
    """Nodes of ``scope``'s own body, not descending into nested defs."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, _NEW_SCOPES):
            stack.extend(ast.iter_child_nodes(node))


def _assignments(tree: ast.AST) -> dict[str, list[ast.expr]]:
    """NAME -> every expression assigned to it anywhere in the module."""
    out: dict[str, list[ast.expr]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.setdefault(t.id, []).append(node.value)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            if isinstance(node.target, ast.Name):
                out.setdefault(node.target.id, []).append(node.value)
    return out


def _names_compiler(expr: ast.AST, compilers: set[str]) -> str | None:
    """What makes ``expr`` a compiler's path, or None."""
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Call) and _last(dotted_name(sub.func)) in _COMPILER_FUNCS:
            return f"{_last(dotted_name(sub.func))}()"
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            if os.path.basename(sub.value) in _COMPILERS:
                return sub.value
        if isinstance(sub, ast.Name) and sub.id in compilers:
            return sub.id
    return None


def _compiler_names(assigned: dict[str, list[ast.expr]]) -> set[str]:
    """Names bound (transitively) to a compiler's path."""
    names: set[str] = set()
    changed = True
    while changed:
        changed = False
        for name, exprs in assigned.items():
            if name not in names and any(_names_compiler(e, names) for e in exprs):
                names.add(name)
                changed = True
    return names


def _argv_head(call: ast.Call, assigned: dict[str, list[ast.expr]]) -> list[ast.expr]:
    """The candidates for argv[0] of a subprocess call."""
    argv = call.args[0] if call.args else next(
        (kw.value for kw in call.keywords if kw.arg == "args"), None
    )
    lists = [argv] if isinstance(argv, (ast.List, ast.Tuple)) else []
    if isinstance(argv, ast.Name):
        lists = [e for e in assigned.get(argv.id, []) if isinstance(e, (ast.List, ast.Tuple))]
    return [lst.elts[0] for lst in lists if lst.elts and not isinstance(lst.elts[0], ast.Starred)]


def _is_build_entry(name: str | None) -> bool:
    if name is None:
        return False
    last = _last(name)
    return last in _BUILD_ENTRIES or ("cpp_extension" in name and last.startswith("load"))


def _sync_name(call: ast.Call) -> str | None:
    name = dotted_name(call.func)
    if name == "torch.cuda.synchronize":
        return "torch.cuda.synchronize()"
    if isinstance(call.func, ast.Name) and call.func.id == "_fetch":
        return "_fetch()"
    if isinstance(call.func, ast.Attribute) and call.func.attr in _SYNC_METHODS and not call.args:
        return f".{call.func.attr}()"
    return None


def _sync_scope(rel: str) -> bool:
    parts = rel.split("/")
    return rel.endswith("checker/device.py") or "ops" in parts[:-1] or "parallel" in parts[:-1]


class TorchHygienePass(FilePass):
    name = "torch-hygiene"

    def check_file(self, info: FileInfo) -> list[Finding]:
        tree = info.tree
        assert tree is not None
        out: list[Finding] = []
        assigned = _assignments(tree)
        compilers = _compiler_names(assigned)
        syncs = _sync_scope(info.rel)

        for fname, scope in _scopes(tree):
            own = list(_own_nodes(scope))
            records = any(
                isinstance(n, ast.Call) and _last(dotted_name(n.func)) == "record_build" for n in own
            )
            for node in own:
                if not (isinstance(node, ast.Call) and dotted_name(node.func) in _RUNNERS):
                    continue
                what = next(
                    (w for h in _argv_head(node, assigned) if (w := _names_compiler(h, compilers))),
                    None,
                )
                if what is not None and not records:
                    out.append(
                        Finding(
                            "build-unrecorded",
                            ERROR,
                            info.rel,
                            node.lineno,
                            f"'{fname}' runs a compiler ({what}) without "
                            "obs.introspect.record_build — its builds are invisible "
                            "to the introspector and the job's trace",
                        )
                    )

            for call in _loop_calls(scope):
                name = dotted_name(call.func)
                if _is_build_entry(name):
                    out.append(
                        Finding(
                            "build-in-loop",
                            ERROR,
                            info.rel,
                            call.lineno,
                            f"{_last(name)}() inside a loop of '{fname}' asks for a "
                            "kernel build or library load every iteration",
                        )
                    )
                elif syncs and (sync := _sync_name(call)) is not None:
                    out.append(
                        Finding(
                            "sync-in-loop",
                            ERROR,
                            info.rel,
                            call.lineno,
                            f"host sync {sync} inside a loop of '{fname}' — one "
                            "device round trip per iteration",
                        )
                    )
        return out
