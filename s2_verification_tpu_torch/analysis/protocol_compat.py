"""protocol-compat: frame sites must agree with protocol.py's field table.

``service/protocol.py`` now carries the wire contract explicitly:
``FRAME_FIELDS`` (op -> {field: required|optional}) and ``UNSIGNED_FIELDS``
(the MAC exclusion list).  This pass holds every construction site
(``client.py``) and parse site (``daemon.py`` / ``router.py``) to it, so a
frame field can only be added by declaring it — and because the MAC covers
everything outside ``UNSIGNED_FIELDS``, a declared field is HMAC-covered by
construction.

Rules (all error severity)
--------------------------

``protocol-no-table``
    ``protocol.py`` found but ``FRAME_FIELDS``/``UNSIGNED_FIELDS`` missing
    or not statically readable.

``protocol-unknown-op``
    A frame literal ``{"op": X}`` with an op the table does not declare.

``protocol-unknown-field``
    A construction site sends, or a parse site reads, a field no op
    declares.  Constant-resolution covers the ``TRACE_FIELD`` import and
    ``for key in ("shape", "backend", ...)`` literal loops.

``protocol-missing-required``
    A frame literal omits a required field of its op (and no later
    ``req["field"] = ...`` store in the same function supplies it).

``protocol-unguarded-read``
    A parse site reads an optional field with bare ``req["f"]`` outside an
    ``if req.get("f")``-style guard — optional-with-default is the
    compatibility contract, so an unguarded subscript is a KeyError on
    every older peer.

``protocol-unsigned-mismatch``
    ``_frame_mac``'s exclusion set disagrees with ``UNSIGNED_FIELDS`` —
    fields silently escaping (or double-entering) the authenticated region.
"""

from __future__ import annotations

import ast

from .engine import (
    ERROR,
    FileInfo,
    Finding,
    Pass,
    TreeContext,
    const_str,
    literal_str_tuple,
    module_constants,
    name_resolver,
)

_PARSE_BASENAMES = {"client.py", "daemon.py", "router.py"}
_REQ_NAMES = {"req", "frame", "request"}


def _load_table(info: FileInfo) -> tuple[dict[str, dict[str, str]] | None, list[str] | None]:
    consts = module_constants(info.tree)
    table_expr = consts.get("FRAME_FIELDS")
    unsigned_expr = consts.get("UNSIGNED_FIELDS")
    table: dict[str, dict[str, str]] | None = None
    if isinstance(table_expr, ast.Dict):
        table = {}
        for k, v in zip(table_expr.keys, table_expr.values):
            op = const_str(k) if k is not None else None
            if op is None or not isinstance(v, ast.Dict):
                return None, None
            fields: dict[str, str] = {}
            for fk, fv in zip(v.keys, v.values):
                fname = const_str(fk) if fk is not None else None
                fmode = const_str(fv)
                if fname is None or fmode not in ("required", "optional"):
                    return None, None
                fields[fname] = fmode
            table[op] = fields
    unsigned = literal_str_tuple(unsigned_expr) if unsigned_expr is not None else None
    return table, unsigned


def _mac_exclusions(info: FileInfo, resolve) -> set[str] | None:
    """The key-exclusion set of ``_frame_mac``'s body comprehension."""
    for node in ast.walk(info.tree):
        if isinstance(node, ast.FunctionDef) and node.name == "_frame_mac":
            for sub in ast.walk(node):
                if not isinstance(sub, (ast.DictComp, ast.SetComp, ast.GeneratorExp)):
                    continue
                for gen in sub.generators:
                    for cond in gen.ifs:
                        if not (
                            isinstance(cond, ast.Compare) and len(cond.ops) == 1
                        ):
                            continue
                        comp = cond.comparators[0]
                        if isinstance(cond.ops[0], ast.NotEq):
                            s = const_str(comp)
                            if s is not None:
                                return {s}
                        elif isinstance(cond.ops[0], ast.NotIn):
                            lits = literal_str_tuple(comp)
                            if lits is None and isinstance(comp, ast.Name):
                                lits = literal_str_tuple(resolve(comp.id))
                            if lits is not None:
                                return set(lits)
            return None
    return None


def _resolve_key(node: ast.expr, resolve) -> str | None:
    s = const_str(node)
    if s is not None:
        return s
    if isinstance(node, ast.Name):
        return const_str(resolve(node.id))
    return None


class ProtocolCompatPass(Pass):
    name = "protocol-compat"

    def run(self, ctx: TreeContext) -> list[Finding]:
        out: list[Finding] = []
        protos = [f for f in ctx.by_basename("protocol.py") if f.tree is not None]
        if not protos:
            return []  # nothing speaking the wire protocol in scope
        proto = protos[0]
        table, unsigned = _load_table(proto)
        if table is None or unsigned is None:
            out.append(
                Finding(
                    "protocol-no-table",
                    ERROR,
                    proto.rel,
                    1,
                    "FRAME_FIELDS / UNSIGNED_FIELDS missing or not statically "
                    "readable — the wire contract must be declared",
                )
            )
            return out

        resolve_proto = name_resolver(ctx, proto)
        excl = _mac_exclusions(proto, resolve_proto)
        if excl is not None and excl != set(unsigned):
            out.append(
                Finding(
                    "protocol-unsigned-mismatch",
                    ERROR,
                    proto.rel,
                    1,
                    f"_frame_mac excludes {sorted(excl)} but UNSIGNED_FIELDS "
                    f"declares {sorted(unsigned)} — the authenticated region "
                    "and the declaration must agree",
                )
            )

        all_fields: set[str] = {"op", *unsigned}
        for fields in table.values():
            all_fields.update(fields)

        for info in ctx.files:
            if info.tree is None:
                continue
            base = info.rel.rsplit("/", 1)[-1]
            if base not in _PARSE_BASENAMES:
                continue
            resolve = name_resolver(ctx, info)
            for fn in ast.walk(info.tree):
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._check_function(info, fn, table, unsigned, all_fields, resolve, out)
        # nested defs are visited both standalone and inside their parent's
        # walk — collapse the duplicates
        seen: set[tuple] = set()
        deduped: list[Finding] = []
        for f in out:
            key = (f.rule, f.path, f.line, f.message)
            if key not in seen:
                seen.add(key)
                deduped.append(f)
        return deduped

    # -- per-function checks ------------------------------------------------

    def _check_function(
        self,
        info: FileInfo,
        fn: ast.AST,
        table: dict[str, dict[str, str]],
        unsigned: list[str],
        all_fields: set[str],
        resolve,
        out: list[Finding],
    ) -> None:
        implicit = {"op", *unsigned}
        # op-dict variables: var name -> (op, keys seen so far)
        op_vars: dict[str, str] = {}
        dict_lits: list[tuple[ast.Dict, str, str | None]] = []  # (node, op, var)

        for node in ast.walk(fn):
            if isinstance(node, ast.Dict):
                op = None
                for k, v in zip(node.keys, node.values):
                    if k is not None and const_str(k) == "op":
                        op = const_str(v)
                if op is not None:
                    dict_lits.append((node, op, None))
            elif isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if isinstance(t, ast.Name) and isinstance(node.value, ast.Dict):
                    for k, v in zip(node.value.keys, node.value.values):
                        if k is not None and const_str(k) == "op":
                            opv = const_str(v)
                            if opv is not None:
                                op_vars[t.id] = opv

        # literal contents + later key stores
        stores: dict[str, set[str]] = {v: set() for v in op_vars}
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Subscript)
                and isinstance(node.targets[0].value, ast.Name)
                and node.targets[0].value.id in op_vars
            ):
                key = _resolve_key(node.targets[0].slice, resolve)
                var = node.targets[0].value.id
                if key is not None:
                    stores[var].add(key)
                    self._check_field(
                        info, node.lineno, op_vars[var], key, table, implicit, out
                    )

        for dnode, op, _var in dict_lits:
            if op not in table:
                out.append(
                    Finding(
                        "protocol-unknown-op",
                        ERROR,
                        info.rel,
                        dnode.lineno,
                        f"frame op '{op}' is not declared in FRAME_FIELDS",
                    )
                )
                continue
            lit_keys: set[str] = set()
            for k, _v in zip(dnode.keys, dnode.values):
                if k is None:
                    continue
                key = _resolve_key(k, resolve)
                if key is None:
                    continue
                lit_keys.add(key)
                if key != "op":
                    self._check_field(info, k.lineno, op, key, table, implicit, out)
            # required-field coverage: literal keys + later stores on the
            # variable this literal was assigned to (if any)
            var = next((v for v, o in op_vars.items() if o == op), None)
            supplied = lit_keys | (stores.get(var, set()) if var else set())
            for f, mode in table[op].items():
                if mode == "required" and f not in supplied:
                    out.append(
                        Finding(
                            "protocol-missing-required",
                            ERROR,
                            info.rel,
                            dnode.lineno,
                            f"frame op '{op}' omits required field '{f}'",
                        )
                    )

        # parse-site reads
        self._check_reads(info, fn, all_fields, resolve, table, out)

    def _check_field(
        self,
        info: FileInfo,
        line: int,
        op: str,
        key: str,
        table: dict[str, dict[str, str]],
        implicit: set[str],
        out: list[Finding],
    ) -> None:
        if op in table and key not in table[op] and key not in implicit:
            out.append(
                Finding(
                    "protocol-unknown-field",
                    ERROR,
                    info.rel,
                    line,
                    f"field '{key}' is not declared for frame op '{op}' — add "
                    "it to FRAME_FIELDS as optional-with-default",
                )
            )

    def _check_reads(
        self,
        info: FileInfo,
        fn: ast.AST,
        all_fields: set[str],
        resolve,
        table: dict[str, dict[str, str]],
        out: list[Finding],
    ) -> None:
        # loop vars ranging over literal key tuples: for key in ("a","b")
        loop_keys: dict[str, list[str]] = {}
        for node in ast.walk(fn):
            if isinstance(node, (ast.For, ast.AsyncFor)) and isinstance(
                node.target, ast.Name
            ):
                lits = literal_str_tuple(node.iter)
                if lits is None and isinstance(node.iter, ast.Name):
                    lits = literal_str_tuple(resolve(node.iter.id))
                if lits is not None:
                    loop_keys[node.target.id] = lits
        for node in ast.walk(fn):
            if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
                for gen in node.generators:
                    if isinstance(gen.target, ast.Name):
                        lits = literal_str_tuple(gen.iter)
                        if lits is None and isinstance(gen.iter, ast.Name):
                            lits = literal_str_tuple(resolve(gen.iter.id))
                        if lits is not None:
                            loop_keys[gen.target.id] = lits

        required_somewhere = {
            f for fields in table.values() for f, m in fields.items() if m == "required"
        }

        stack: list[tuple[ast.AST, list[ast.AST]]] = [(fn, [])]
        while stack:
            node, parents = stack.pop()
            for child in ast.iter_child_nodes(node):
                stack.append((child, parents + [node]))
            # req.get("x") / req.get(key)
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in _REQ_NAMES
                and node.args
            ):
                for key in self._read_keys(node.args[0], resolve, loop_keys):
                    if key not in all_fields:
                        out.append(
                            Finding(
                                "protocol-unknown-field",
                                ERROR,
                                info.rel,
                                node.lineno,
                                f"parse site reads undeclared frame field '{key}'",
                            )
                        )
            # req["x"]
            elif (
                isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Name)
                and node.value.id in _REQ_NAMES
                and isinstance(node.ctx, ast.Load)
            ):
                keys = self._read_keys(node.slice, resolve, loop_keys)
                for key in keys:
                    if key not in all_fields:
                        out.append(
                            Finding(
                                "protocol-unknown-field",
                                ERROR,
                                info.rel,
                                node.lineno,
                                f"parse site reads undeclared frame field '{key}'",
                            )
                        )
                    elif key not in required_somewhere and not self._guarded(
                        node, parents
                    ):
                        out.append(
                            Finding(
                                "protocol-unguarded-read",
                                ERROR,
                                info.rel,
                                node.lineno,
                                f"optional frame field '{key}' read with bare "
                                "subscript — guard with req.get() so older "
                                "peers' frames keep parsing",
                            )
                        )

    @staticmethod
    def _read_keys(node: ast.expr, resolve, loop_keys: dict[str, list[str]]) -> list[str]:
        s = const_str(node)
        if s is not None:
            return [s]
        if isinstance(node, ast.Name):
            if node.id in loop_keys:
                return loop_keys[node.id]
            s = const_str(resolve(node.id))
            if s is not None:
                return [s]
        return []

    @staticmethod
    def _guarded(sub: ast.Subscript, parents: list[ast.AST]) -> bool:
        """A bare req[key] read is fine under `if req.get(key) ...:`."""

        def mentions_get(test: ast.expr) -> bool:
            for n in ast.walk(test):
                if (
                    isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "get"
                    and isinstance(n.func.value, ast.Name)
                    and n.func.value.id in _REQ_NAMES
                ):
                    return True
                if (
                    isinstance(n, ast.Compare)
                    and len(n.ops) == 1
                    and isinstance(n.ops[0], ast.In)
                    and isinstance(n.comparators[0], ast.Name)
                    and n.comparators[0].id in _REQ_NAMES
                ):
                    return True
            return False

        for p in parents:
            if isinstance(p, (ast.If, ast.IfExp)) and mentions_get(p.test):
                return True
            if isinstance(p, ast.Try):
                return True  # KeyError-handled access is its own guard
        return False
