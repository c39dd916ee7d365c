"""event-schema: the ServiceStats event registry, cross-checked.

The stream's schema is implicit today: producers call
``stats.emit("name", **fields)`` and five consumer families pattern-match on
names and fields — the ``_count`` counter chain in ``service/stats.py``,
``AlertRule`` literals, the flight-recorder doctor sections, the archive /
sentinel / SLO-health ``observe_event`` folds, and soak scoring.  Drift
between them is exactly the bug class the false-verdict sentinel catches
at runtime; this pass catches it at commit time.

Extraction
----------

*Emit sites*: ``<expr>.emit("name", k=v, **kw)`` — a ``**kw`` splat marks
the event *open* (field set not statically known) — plus dict-literal feeds
``observe_event({"ev": "name", ...})`` / ``record_event({...})``.

*Consumers*:

- the ``name = ev.get("ev") or ev.get("event")`` idiom followed by
  ``name == "lit"`` / ``name in (...)`` / ``if name != "lit": return``
  branches, with ``ev.get("f")`` / ``ev["f"]`` field reads (comparator
  tuples resolve through module constants, e.g. ``_GOOD_EVENTS``);
- functions that compare a parameter against string literals while reading
  a dict parameter in the branches (the ``_count(event, fields)`` shape);
- ``AlertRule(event="...", field="...")`` keyword literals;
- ``{k: ev[k] for k in _COPY_FIELDS}`` comprehensions resolve the field
  tuple through module constants.

Rules
-----

``event-never-emitted`` (error)
    A consumer matches an event name no emit site produces — dead consumer
    code, or a producer someone renamed out from under it.

``event-field-unwritten`` (error)
    A consumer reads field F of event E, every emit site of E is closed
    (no ``**`` splat), and none of them writes F.  Auto fields (``t``,
    ``ev``, ``event``) are exempt.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .engine import (
    ERROR,
    FileInfo,
    Finding,
    Pass,
    TreeContext,
    const_str,
    dotted_name,
    literal_str_tuple,
    name_resolver,
)

_AUTO_FIELDS = {"t", "ev", "event"}
_FEED_FUNCS = {"observe_event", "record_event", "record"}


@dataclass
class EmitSite:
    path: str
    line: int
    fields: set[str]
    open: bool


@dataclass
class ConsumerRef:
    path: str
    line: int
    kind: str  # counter | alert-rule | fold
    field: str | None = None


@dataclass
class EventEntry:
    emits: list[EmitSite] = field(default_factory=list)
    consumers: list[ConsumerRef] = field(default_factory=list)

    @property
    def open(self) -> bool:
        return any(e.open for e in self.emits)

    @property
    def fields(self) -> set[str]:
        out: set[str] = set()
        for e in self.emits:
            out |= e.fields
        return out


Registry = dict[str, EventEntry]


# --------------------------------------------------------------------------
# extraction


def _collect_emits(info: FileInfo, reg: Registry) -> None:
    for node in ast.walk(info.tree):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute) and node.func.attr == "emit" and node.args:
            name = const_str(node.args[0])
            if name is None:
                continue
            fields = {kw.arg for kw in node.keywords if kw.arg is not None}
            is_open = any(kw.arg is None for kw in node.keywords)
            reg.setdefault(name, EventEntry()).emits.append(
                EmitSite(info.rel, node.lineno, fields, is_open)
            )
        elif (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _FEED_FUNCS
            and node.args
            and isinstance(node.args[0], ast.Dict)
        ):
            d = node.args[0]
            name = None
            fields: set[str] = set()
            is_open = False
            for k, v in zip(d.keys, d.values):
                if k is None:
                    is_open = True
                    continue
                ks = const_str(k)
                if ks in ("ev", "event"):
                    name = const_str(v) or name
                elif ks is not None:
                    fields.add(ks)
            if name is not None:
                reg.setdefault(name, EventEntry()).emits.append(
                    EmitSite(info.rel, node.lineno, fields, is_open)
                )


def _is_name_assign(node: ast.stmt) -> tuple[str, str] | None:
    """``N = D.get("ev") or D.get("event")`` (or a single get) -> (N, D)."""
    if not (
        isinstance(node, ast.Assign)
        and len(node.targets) == 1
        and isinstance(node.targets[0], ast.Name)
    ):
        return None
    calls: list[ast.expr] = []
    v = node.value
    if isinstance(v, ast.BoolOp) and isinstance(v.op, ast.Or):
        calls = list(v.values)
    else:
        calls = [v]
    dvar = None
    for c in calls:
        if not (
            isinstance(c, ast.Call)
            and isinstance(c.func, ast.Attribute)
            and c.func.attr == "get"
            and isinstance(c.func.value, ast.Name)
            and c.args
            and const_str(c.args[0]) in ("ev", "event")
        ):
            return None
        if dvar is None:
            dvar = c.func.value.id
        elif dvar != c.func.value.id:
            return None
    if dvar is None:
        return None
    return node.targets[0].id, dvar


def _events_in_test(test: ast.expr, nvar: str, resolve) -> tuple[list[str], bool]:
    """Events matched by an If test on the name var.

    Returns (events, negated): ``negated`` means the test *excludes* the
    events (the ``if name != "done": return`` guard shape).
    """
    if not (
        isinstance(test, ast.Compare)
        and len(test.ops) == 1
        and isinstance(test.left, ast.Name)
        and test.left.id == nvar
    ):
        return [], False
    comp = test.comparators[0]
    op = test.ops[0]
    if isinstance(op, (ast.Eq, ast.NotEq)):
        s = const_str(comp)
        return ([s] if s is not None else []), isinstance(op, ast.NotEq)
    if isinstance(op, (ast.In, ast.NotIn)):
        lits = literal_str_tuple(comp)
        if lits is None and isinstance(comp, ast.Name):
            lits = literal_str_tuple(resolve(comp.id))
        return (lits or []), isinstance(op, ast.NotIn)
    return [], False


def _field_reads(nodes: list[ast.stmt], dvar: str, resolve) -> list[tuple[str, int]]:
    """(field, line) reads on the payload var within the given statements."""
    out: list[tuple[str, int]] = []
    comp_vars: dict[str, list[str]] = {}  # comprehension var -> resolved fields
    for stmt in nodes:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
                for gen in node.generators:
                    if isinstance(gen.target, ast.Name):
                        lits = literal_str_tuple(gen.iter)
                        if lits is None and isinstance(gen.iter, ast.Name):
                            lits = literal_str_tuple(resolve(gen.iter.id))
                        if lits is not None:
                            comp_vars[gen.target.id] = lits
    for stmt in nodes:
        for node in ast.walk(stmt):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == dvar
                and node.args
            ):
                f = const_str(node.args[0])
                if f is not None:
                    out.append((f, node.lineno))
            elif (
                isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Name)
                and node.value.id == dvar
                and isinstance(node.ctx, ast.Load)
            ):
                f = const_str(node.slice)
                if f is not None:
                    out.append((f, node.lineno))
                elif isinstance(node.slice, ast.Name) and node.slice.id in comp_vars:
                    out.extend((cf, node.lineno) for cf in comp_vars[node.slice.id])
    return out


def _guard_exits(body: list[ast.stmt]) -> bool:
    """True when the branch body unconditionally leaves (return/continue/raise)."""
    return bool(body) and isinstance(body[-1], (ast.Return, ast.Continue, ast.Raise))


@dataclass
class _Consumption:
    event: str
    kind: str
    path: str
    line: int
    reads: list[tuple[str, int]] = field(default_factory=list)


def _collect_fold_consumers(info: FileInfo, resolve, out: list[_Consumption]) -> None:
    for fn in ast.walk(info.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        pairs: list[tuple[str, str]] = []  # (name var, payload var)
        for stmt in ast.walk(fn):
            if isinstance(stmt, ast.stmt):
                p = _is_name_assign(stmt)
                if p is not None:
                    pairs.append(p)
        # the _count(event, fields) shape: an `event` param compared to
        # literals while a `fields`/`payload` dict param is read in the
        # branches.  Restricted to the conventional parameter names — a
        # looser match sweeps in every string-dispatch function in the tree
        # (CLI backend selection, campaign fault classes).
        params = [a.arg for a in fn.args.args if a.arg != "self"]
        nvars = [p for p in params if p in ("event", "ev")]
        dvars = [p for p in params if p in ("fields", "payload")]
        for nvar in nvars:
            for dvar in dvars:
                pairs.append((nvar, dvar))
        if not pairs:
            continue
        for nvar, dvar in dict.fromkeys(pairs):
            _walk_branches(fn.body, nvar, dvar, resolve, info, out)


def _walk_branches(
    body: list[ast.stmt],
    nvar: str,
    dvar: str,
    resolve,
    info: FileInfo,
    out: list[_Consumption],
    _depth: int = 0,
) -> None:
    if _depth > 20:
        return
    for idx, stmt in enumerate(body):
        if isinstance(stmt, ast.If):
            evs, negated = _events_in_test(stmt.test, nvar, resolve)
            if evs and not negated:
                reads = _field_reads(stmt.body, dvar, resolve)
                for ev in evs:
                    out.append(_Consumption(ev, "fold", info.rel, stmt.lineno, reads))
                _walk_branches(stmt.orelse, nvar, dvar, resolve, info, out, _depth + 1)
                continue
            if evs and negated and _guard_exits(stmt.body):
                # `if name != "done": return` — the rest of this block is
                # the "done" branch.
                rest = body[idx + 1 :]
                reads = _field_reads(rest, dvar, resolve)
                for ev in evs:
                    out.append(_Consumption(ev, "fold", info.rel, stmt.lineno, reads))
                break
            _walk_branches(stmt.body, nvar, dvar, resolve, info, out, _depth + 1)
            _walk_branches(stmt.orelse, nvar, dvar, resolve, info, out, _depth + 1)
        elif isinstance(stmt, (ast.For, ast.While, ast.With, ast.Try)):
            inner: list[ast.stmt] = []
            for attr in ("body", "orelse", "finalbody", "handlers"):
                part = getattr(stmt, attr, None)
                if not part:
                    continue
                for el in part:
                    if isinstance(el, ast.ExceptHandler):
                        inner.extend(el.body)
                    else:
                        inner.append(el)
            _walk_branches(inner, nvar, dvar, resolve, info, out, _depth + 1)


def _collect_alert_rules(info: FileInfo, out: list[_Consumption]) -> None:
    for node in ast.walk(info.tree):
        if not isinstance(node, ast.Call):
            continue
        fname = dotted_name(node.func) or ""
        if fname.rsplit(".", 1)[-1] != "AlertRule":
            continue
        ev = fld = None
        for kw in node.keywords:
            if kw.arg == "event":
                ev = const_str(kw.value)
            elif kw.arg == "field":
                fld = const_str(kw.value)
        if ev is None:
            continue
        reads = [(fld, node.lineno)] if fld else []
        out.append(_Consumption(ev, "alert-rule", info.rel, node.lineno, reads))


# --------------------------------------------------------------------------
# the pass


def build_registry(ctx: TreeContext) -> tuple[Registry, list[_Consumption]]:
    reg: Registry = {}
    cons: list[_Consumption] = []
    for info in ctx.files:
        if info.tree is None:
            continue
        _collect_emits(info, reg)
    for info in ctx.files:
        if info.tree is None:
            continue
        resolve = name_resolver(ctx, info)
        _collect_fold_consumers(info, resolve, cons)
        _collect_alert_rules(info, cons)
    for c in cons:
        ent = reg.setdefault(c.event, EventEntry())
        if c.reads:
            for f, _line in sorted(set(c.reads)):
                ent.consumers.append(ConsumerRef(c.path, c.line, c.kind, f))
        else:
            ent.consumers.append(ConsumerRef(c.path, c.line, c.kind))
    return reg, cons


class EventSchemaPass(Pass):
    name = "event-schema"

    def run(self, ctx: TreeContext) -> list[Finding]:
        reg, cons = build_registry(ctx)
        out: list[Finding] = []
        for c in cons:
            ent = reg.get(c.event)
            if ent is None or not ent.emits:
                out.append(
                    Finding(
                        "event-never-emitted",
                        ERROR,
                        c.path,
                        c.line,
                        f"consumer matches event '{c.event}' but no emit site "
                        "produces it",
                    )
                )
                continue
            if ent.open:
                continue
            known = ent.fields | _AUTO_FIELDS
            for f, line in sorted(set(c.reads)):
                if f not in known:
                    out.append(
                        Finding(
                            "event-field-unwritten",
                            ERROR,
                            c.path,
                            line,
                            f"consumer reads field '{f}' of event '{c.event}' "
                            "but no emit site writes it",
                        )
                    )
        return out


# --------------------------------------------------------------------------
# docs generation (docs/EVENTS_torch.md)

_EVENTS_MD_HEADER = """\
# ServiceStats event registry

<!-- Generated by `python -m s2_verification_tpu_torch lint --events-md
     docs/EVENTS_torch.md`.  Do not edit by hand: `lint --check-events-md`
     fails when this file drifts from the tree. -->

Every event on the ServiceStats stream, extracted statically by the
`event-schema` verifylint pass: emit sites, the union of closed-form
fields (an *open* event has at least one `**splat` emitter, so its field
set is a lower bound), and every consumer that pattern-matches on the
event.  Auto fields `t` (emit wall clock) and `ev` (the name itself) ride
on every line and are not listed.
"""


def render_events_md(ctx: TreeContext) -> str:
    reg, _cons = build_registry(ctx)
    lines = [_EVENTS_MD_HEADER]
    for name in sorted(reg):
        ent = reg[name]
        if not ent.emits:
            continue  # never-emitted names are lint errors, not docs
        lines.append(f"## `{name}`\n")
        fields = sorted(ent.fields)
        suffix = " *(open: `**` emitter — lower bound)*" if ent.open else ""
        lines.append(
            "- **Fields:** " + (", ".join(f"`{f}`" for f in fields) if fields else "—") + suffix
        )
        emits = ", ".join(f"`{e.path}:{e.line}`" for e in sorted(ent.emits, key=lambda e: (e.path, e.line)))
        lines.append(f"- **Emitted from:** {emits}")
        if ent.consumers:
            seen: list[str] = []
            for c in sorted(ent.consumers, key=lambda c: (c.path, c.line, c.field or "")):
                tag = f"{c.kind} `{c.path}:{c.line}`"
                if c.field:
                    tag += f" (reads `{c.field}`)"
                if tag not in seen:
                    seen.append(tag)
            lines.append("- **Consumers:** " + "; ".join(seen))
        else:
            lines.append("- **Consumers:** — (flight recorder archives all events)")
        lines.append("")
    return "\n".join(lines).rstrip() + "\n"
