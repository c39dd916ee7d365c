"""metrics-cardinality: label values must come from closed literal sets.

Rules
-----

``metric-open-label`` (error)
    A keyword label on ``.inc()`` / ``.set()`` / ``.observe()`` whose value
    cannot be proven drawn from a closed set of literals.  Unbounded label
    values (f-strings, fingerprints, event-field passthroughs, user input)
    mint a new timeseries per distinct value — the classic cardinality
    explosion that OOMs the scrape path.  ``exemplar=`` is an exemplar, not
    a label, and is exempt by design (that is its whole point).

    A value is *closed* when it is:

    - a literal constant;
    - ``str(<closed>)`` of one;
    - a name assigned **only** from literals in the enclosing function;
    - a name that passes the repo's validation idiom before use::

          reason = str(fields.get("reason", "other"))
          if reason not in ("deadline", "client_gone", "shutdown"):
              reason = "other"

      (membership test against a literal tuple with a literal fallback
      rebind — the fold used by job_cancelled / admission_shed);
    - a name validated against a **frozen instance attribute**::

          # __init__: self._nodes = tuple(sorted(targets))
          if node not in self._nodes:
              node = "other"

      (the fleet-membership idiom: the attribute must be assigned in the
      class's ``__init__`` from a ``tuple(...)``/``frozenset(...)`` call,
      so the value set is fixed at construction — bounded by deployment
      config like the router's ``--backend`` list, not by traffic);
    - a for-loop variable ranging over a literal tuple/list;
    - ``<MODULE_CONST_DICT>.get(x, "literal")`` where the module-level dict
      has only literal values (the verdict-label table idiom).

    Labels on **info-style gauges** — families ending ``_info``, the
    Prometheus convention for build/version metadata (one series, value
    1, identity carried in labels) — are exempt: their labels are
    inherently open (version strings) but the family is one-series by
    construction, so there is no cardinality to explode.

``metric-name`` (error)
    Registered metric families must follow the exposition conventions:
    names start ``verifyd_``; counters end ``_total``; histograms end in a
    unit suffix (``_seconds``/``_bytes``/``_layers``/``_ratio``/``_ops``/
    ``_lanes``).
"""

from __future__ import annotations

import ast
import re

from .engine import (
    ERROR,
    FileInfo,
    FilePass,
    Finding,
    const_str,
    dotted_name,
    literal_str_tuple,
    module_constants,
)

_METRIC_METHODS = {"inc", "set", "observe"}
_REG_METHODS = {"counter": "_total", "gauge": None, "histogram": "UNIT"}
_HIST_SUFFIXES = ("_seconds", "_bytes", "_layers", "_ratio", "_ops", "_lanes")
_RECEIVER_RE = re.compile(r"(^|_)(m|g|h|metric|counter|gauge|hist(ogram)?)(_|$)", re.I)


def _is_literal(node: ast.expr) -> bool:
    return isinstance(node, ast.Constant)


def _frozen_attrs(cls: ast.ClassDef) -> set[str]:
    """Instance attributes assigned in ``__init__`` from a
    ``tuple(...)``/``frozenset(...)`` call — fixed at construction, so a
    membership test against them proves a closed value set."""
    out: set[str] = set()
    for stmt in cls.body:
        if not (isinstance(stmt, ast.FunctionDef) and stmt.name == "__init__"):
            continue
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Assign):
                continue
            if not (
                isinstance(node.value, ast.Call)
                and dotted_name(node.value.func) in ("tuple", "frozenset")
            ):
                continue
            for t in node.targets:
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    out.add(t.attr)
    return out


class _FnScope:
    """Per-function facts about local names: literal-only assignment and
    the membership-validation idiom."""

    def __init__(
        self,
        fn: ast.AST,
        mod_consts: dict[str, ast.expr],
        frozen_attrs: set[str] | None = None,
    ):
        self.literal_only: dict[str, bool] = {}
        self.validated: set[str] = set()
        self.loop_literal: set[str] = set()
        self.mod_consts = mod_consts
        self.frozen_attrs = frozen_attrs or set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        closed = self._closed_expr(node.value, shallow=True)
                        prev = self.literal_only.get(t.id, True)
                        self.literal_only[t.id] = prev and closed
            elif isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Name):
                self.literal_only[node.target.id] = False
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                if isinstance(node.target, ast.Name) and literal_str_tuple(node.iter) is not None:
                    self.loop_literal.add(node.target.id)
            elif isinstance(node, ast.If):
                self._scan_validation(node)

    def _closed_container(self, node: ast.expr) -> bool:
        """Membership-test comparators that prove a closed set: a literal
        tuple, or a frozen instance attribute (``self._nodes`` assigned in
        ``__init__`` from ``tuple(...)``/``frozenset(...)``)."""
        if literal_str_tuple(node) is not None:
            return True
        return (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and node.attr in self.frozen_attrs
        )

    def _scan_validation(self, node: ast.If) -> None:
        """``if X not in <closed container>: X = <literal>`` marks X
        validated (see :meth:`_closed_container` for what qualifies)."""
        test = node.test
        if not (
            isinstance(test, ast.Compare)
            and len(test.ops) == 1
            and isinstance(test.ops[0], ast.NotIn)
            and isinstance(test.left, ast.Name)
            and self._closed_container(test.comparators[0])
        ):
            return
        var = test.left.id
        for stmt in node.body:
            if (
                isinstance(stmt, ast.Assign)
                and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and stmt.targets[0].id == var
                and _is_literal(stmt.value)
            ):
                self.validated.add(var)

    def _closed_expr(self, node: ast.expr, shallow: bool = False) -> bool:
        if _is_literal(node):
            return True
        if isinstance(node, ast.Call):
            fname = dotted_name(node.func)
            if fname == "str" and len(node.args) == 1:
                return self._closed_expr(node.args[0], shallow)
            # MODULE_DICT.get(x, "lit") with all-literal dict values
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "get"
                and isinstance(node.func.value, ast.Name)
                and len(node.args) == 2
                and _is_literal(node.args[1])
            ):
                table = self.mod_consts.get(node.func.value.id)
                if isinstance(table, ast.Dict) and all(
                    _is_literal(v) for v in table.values
                ):
                    return True
            return False
        if isinstance(node, ast.Name) and not shallow:
            return self.closed_name(node.id)
        if isinstance(node, (ast.IfExp,)):
            return self._closed_expr(node.body, shallow) and self._closed_expr(
                node.orelse, shallow
            )
        return False

    def closed_name(self, name: str) -> bool:
        if name in self.validated or name in self.loop_literal:
            return True
        if self.literal_only.get(name):
            return True
        const = self.mod_consts.get(name)
        return const is not None and _is_literal(const)

    def closed(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Name):
            return self.closed_name(node.id)
        return self._closed_expr(node)


def _looks_like_metric_receiver(recv: ast.expr) -> bool:
    """Heuristic gate so ``.set()`` on non-metric objects is not swept in."""
    if isinstance(recv, ast.Attribute):
        return bool(_RECEIVER_RE.search(recv.attr))
    if isinstance(recv, ast.Name):
        return bool(_RECEIVER_RE.search(recv.id))
    if isinstance(recv, ast.Call):
        fname = dotted_name(recv.func) or ""
        tail = fname.rsplit(".", 1)[-1]
        return tail in _REG_METHODS or bool(_RECEIVER_RE.search(tail))
    if isinstance(recv, ast.Subscript):
        return _looks_like_metric_receiver(recv.value)
    return False


class MetricsCardinalityPass(FilePass):
    name = "metrics-cardinality"

    def check_file(self, info: FileInfo) -> list[Finding]:
        tree = info.tree
        assert tree is not None
        out: list[Finding] = []
        mod_consts = module_constants(tree)

        # registration naming lint (works at module or method level)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Attribute):
                continue
            kind = node.func.attr
            if kind not in _REG_METHODS or not node.args:
                continue
            name = const_str(node.args[0])
            if name is None:
                continue
            msgs = []
            if not name.startswith("verifyd_"):
                msgs.append("must start with 'verifyd_'")
            if kind == "counter" and not name.endswith("_total"):
                msgs.append("counter must end with '_total'")
            if kind == "histogram" and not name.endswith(_HIST_SUFFIXES):
                msgs.append(
                    "histogram must end with a unit suffix "
                    f"({'/'.join(_HIST_SUFFIXES)})"
                )
            for m in msgs:
                out.append(
                    Finding(
                        "metric-name",
                        ERROR,
                        info.rel,
                        node.lineno,
                        f"metric family '{name}': {m}",
                    )
                )

        # receivers bound to *_info families: labels exempt (one-series
        # identity metrics — the Prometheus info-gauge convention)
        info_receivers: set[str] = set()
        for node in ast.walk(tree):
            if not (
                isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)
            ):
                continue
            call = node.value
            if not (
                isinstance(call.func, ast.Attribute)
                and call.func.attr in _REG_METHODS
                and call.args
            ):
                continue
            fam = const_str(call.args[0])
            if fam is None or not fam.endswith("_info"):
                continue
            for t in node.targets:
                if isinstance(t, ast.Attribute):
                    info_receivers.add(t.attr)
                elif isinstance(t, ast.Name):
                    info_receivers.add(t.id)

        # label closedness, per enclosing function (class-aware: frozen
        # instance attributes are closed membership containers)
        scopes: dict[int, _FnScope] = {}
        class_attrs: dict[int, set[str]] = {}

        def scope_for(parents: list[ast.AST]) -> _FnScope | None:
            frozen: set[str] = set()
            for p in reversed(parents):
                if isinstance(p, ast.ClassDef):
                    if id(p) not in class_attrs:
                        class_attrs[id(p)] = _frozen_attrs(p)
                    frozen = class_attrs[id(p)]
                    break
            for p in reversed(parents):
                if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if id(p) not in scopes:
                        scopes[id(p)] = _FnScope(p, mod_consts, frozen)
                    return scopes[id(p)]
            return None

        stack: list[tuple[ast.AST, list[ast.AST]]] = [(tree, [])]
        while stack:
            node, parents = stack.pop()
            for child in ast.iter_child_nodes(node):
                stack.append((child, parents + [node]))
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _METRIC_METHODS
                and node.keywords
                and _looks_like_metric_receiver(node.func.value)
            ):
                continue
            recv = node.func.value
            if isinstance(recv, ast.Call):
                fn = recv.func
                if (
                    isinstance(fn, ast.Attribute)
                    and fn.attr in _REG_METHODS
                    and recv.args
                    and (const_str(recv.args[0]) or "").endswith("_info")
                ):
                    continue  # inline-registered info gauge
            recv_name = (
                recv.attr
                if isinstance(recv, ast.Attribute)
                else recv.id if isinstance(recv, ast.Name) else None
            )
            if recv_name is not None and recv_name in info_receivers:
                continue
            scope = scope_for(parents)
            for kw in node.keywords:
                if kw.arg is None or kw.arg == "exemplar":
                    continue
                closed = (
                    scope.closed(kw.value) if scope is not None else _is_literal(kw.value)
                )
                if not closed:
                    out.append(
                        Finding(
                            "metric-open-label",
                            ERROR,
                            info.rel,
                            kw.value.lineno,
                            f"label '{kw.arg}' value is not provably from a closed "
                            "literal set — fold it through a validated enum "
                            "(`if v not in (...): v = 'other'`) before labeling",
                        )
                    )
        return out
