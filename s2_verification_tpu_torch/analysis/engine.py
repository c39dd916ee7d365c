"""verifylint engine: pass registry, caching, suppressions, baseline ratchet.

The port's copy of the JAX package's ``analysis/engine.py``: the same
findings, keys, suppressions, baseline and cache formats.  It scans
``s2_verification_tpu_torch`` by default, and its default passes hold
``torch_hygiene`` where the JAX package's hold ``jit_hygiene``.

Design notes
------------

*Findings* carry a stable **key** — ``path::rule::message`` — deliberately
excluding the line number, so a committed baseline survives unrelated edits
shuffling lines around.  The ratchet compares multisets of keys: a key not in
the baseline fails the gate; a baselined key that no longer fires is reported
as *stale* so the baseline only ever shrinks.

*Suppressions* are source comments::

    x = 1  # verifylint: disable=metric-open-label
    # verifylint: disable=metric-open-label,concurrency-unlocked-write
    # verifylint: disable-file=build-unrecorded

A same-line or preceding-line ``disable`` silences that rule at that site;
``disable-file`` silences the rule for the whole file.  ``disable=all``
matches every rule.  Suppressions are counted, never silent.

*Caching*: per-file passes are cached keyed on the sha256 of the file's bytes
(plus the engine's cache schema version), so a no-op re-run over the tree is
dominated by hashing, not parsing.  Tree passes (event-schema,
protocol-compat) are whole-program and always re-run — they are the cheap
ones anyway (one AST walk each over already-parsed trees).
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Iterable

ERROR = "error"
WARNING = "warning"
INFO = "info"

_SEV_ORDER = {ERROR: 0, WARNING: 1, INFO: 2}

CACHE_SCHEMA = 4  # bump to invalidate caches when pass logic changes

_SKIP_DIRS = {"__pycache__", ".git", ".mypy_cache", ".pytest_cache", "node_modules"}


@dataclass(frozen=True)
class Finding:
    rule: str
    severity: str  # error | warning | info
    path: str  # repo-root-relative, '/' separated
    line: int
    message: str

    @property
    def key(self) -> str:
        return f"{self.path}::{self.rule}::{self.message}"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "message": self.message,
        }

    @staticmethod
    def from_dict(d: dict) -> "Finding":
        return Finding(
            rule=str(d["rule"]),
            severity=str(d.get("severity", ERROR)),
            path=str(d["path"]),
            line=int(d.get("line", 0)),
            message=str(d.get("message", "")),
        )


class FileInfo:
    """Lazily-parsed view of one source file, shared across passes."""

    def __init__(self, root: str, rel: str):
        self.root = root
        self.rel = rel
        self._data: bytes | None = None
        self._tree: ast.AST | None = None
        self._tree_err: str | None = None
        self._sha: str | None = None

    @property
    def abspath(self) -> str:
        return os.path.join(self.root, self.rel.replace("/", os.sep))

    @property
    def data(self) -> bytes:
        if self._data is None:
            with open(self.abspath, "rb") as f:
                self._data = f.read()
        return self._data

    @property
    def sha(self) -> str:
        if self._sha is None:
            self._sha = hashlib.sha256(self.data).hexdigest()
        return self._sha

    @property
    def text(self) -> str:
        return self.data.decode("utf-8", "replace")

    @property
    def tree(self) -> ast.AST | None:
        if self._tree is None and self._tree_err is None:
            try:
                self._tree = ast.parse(self.text, filename=self.rel)
            except SyntaxError as e:  # surfaced as a finding by the engine
                self._tree_err = f"{e.msg} (line {e.lineno})"
        return self._tree

    @property
    def parse_error(self) -> str | None:
        self.tree
        return self._tree_err


class TreeContext:
    """All files under the lint roots, with shared parse caching."""

    def __init__(self, root: str, rel_paths: list[str]):
        self.root = root
        self.files = [FileInfo(root, rel) for rel in sorted(rel_paths)]
        self._by_rel = {f.rel: f for f in self.files}

    def get(self, rel: str) -> FileInfo | None:
        return self._by_rel.get(rel)

    def by_basename(self, name: str) -> list[FileInfo]:
        return [f for f in self.files if os.path.basename(f.rel) == name]


class Pass:
    """Base: a whole-tree pass.  Subclasses override ``run``."""

    name = "pass"
    #: per-file passes are cacheable; tree passes always run
    per_file = False

    def run(self, ctx: TreeContext) -> list[Finding]:  # pragma: no cover
        raise NotImplementedError

    def check_file(self, info: FileInfo) -> list[Finding]:  # pragma: no cover
        raise NotImplementedError


class FilePass(Pass):
    per_file = True

    def run(self, ctx: TreeContext) -> list[Finding]:
        out: list[Finding] = []
        for info in ctx.files:
            if info.tree is not None:
                out.extend(self.check_file(info))
        return out


# --------------------------------------------------------------------------
# suppressions


def scan_suppressions(text: str) -> tuple[dict[int, set[str]], set[str]]:
    """Return (line -> suppressed rules, file-level suppressed rules).

    A ``disable=`` comment applies to its own line and the line below it
    (so a comment-only line shields the statement it precedes).
    """
    per_line: dict[int, set[str]] = {}
    file_level: set[str] = set()
    for i, line in enumerate(text.splitlines(), start=1):
        idx = line.find("# verifylint:")
        if idx < 0:
            continue
        directive = line[idx + len("# verifylint:") :].strip()
        if directive.startswith("disable-file="):
            file_level.update(
                r.strip() for r in directive[len("disable-file=") :].split(",") if r.strip()
            )
        elif directive.startswith("disable="):
            rules = {r.strip() for r in directive[len("disable=") :].split(",") if r.strip()}
            stripped = line[:idx].strip()
            per_line.setdefault(i, set()).update(rules)
            if not stripped:  # comment-only line: shield the next line
                per_line.setdefault(i + 1, set()).update(rules)
    return per_line, file_level


def _suppressed(f: Finding, per_line: dict[int, set[str]], file_level: set[str]) -> bool:
    if "all" in file_level or f.rule in file_level:
        return True
    rules = per_line.get(f.line, ())
    return "all" in rules or f.rule in rules


# --------------------------------------------------------------------------
# baseline ratchet


def load_baseline(path: str) -> dict[str, int]:
    """Baseline file -> {finding key: allowed count}."""
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    out: dict[str, int] = {}
    for ent in doc.get("findings", []):
        key = f"{ent['path']}::{ent['rule']}::{ent['message']}"
        out[key] = out.get(key, 0) + int(ent.get("count", 1))
    return out


def write_baseline(findings: Iterable[Finding], path: str, justifications: dict[str, str] | None = None) -> None:
    """Write the error-severity findings as the new baseline, preserving any
    existing per-entry ``justification`` strings keyed by finding key."""
    just = dict(justifications or {})
    if os.path.exists(path):
        try:
            with open(path, "r", encoding="utf-8") as f:
                for ent in json.load(f).get("findings", []):
                    k = f"{ent['path']}::{ent['rule']}::{ent['message']}"
                    if ent.get("justification") and k not in just:
                        just[k] = ent["justification"]
        except (OSError, ValueError):
            pass
    counts: dict[str, dict] = {}
    for f in findings:
        if f.severity != ERROR:
            continue
        ent = counts.setdefault(
            f.key, {"rule": f.rule, "path": f.path, "message": f.message, "count": 0}
        )
        ent["count"] += 1
    entries = []
    for key in sorted(counts):
        ent = counts[key]
        if key in just:
            ent["justification"] = just[key]
        entries.append(ent)
    doc = {
        "comment": "verifylint baseline ratchet: existing debt, may only shrink. "
        "Regenerate with `lint --write-baseline`; every kept entry needs a "
        "justification.",
        "version": 1,
        "findings": entries,
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=False)
        f.write("\n")


@dataclass
class RatchetResult:
    new_errors: list[Finding] = field(default_factory=list)
    baselined: list[Finding] = field(default_factory=list)
    stale_keys: list[str] = field(default_factory=list)


def apply_baseline(findings: list[Finding], baseline: dict[str, int]) -> RatchetResult:
    res = RatchetResult()
    budget = dict(baseline)
    for f in findings:
        if f.severity != ERROR:
            continue
        if budget.get(f.key, 0) > 0:
            budget[f.key] -= 1
            res.baselined.append(f)
        else:
            res.new_errors.append(f)
    res.stale_keys = sorted(k for k, n in budget.items() if n > 0)
    return res


# --------------------------------------------------------------------------
# engine


@dataclass
class RunResult:
    findings: list[Finding]  # post-suppression, sorted
    suppressed: int
    files: int
    passes: list[str]
    cache_hits: int = 0

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == ERROR]


def _sort_key(f: Finding):
    return (f.path, f.line, _SEV_ORDER.get(f.severity, 9), f.rule, f.message)


def default_passes() -> list[Pass]:
    from .concurrency import ConcurrencyPass
    from .event_schema import EventSchemaPass
    from .metrics_cardinality import MetricsCardinalityPass
    from .protocol_compat import ProtocolCompatPass
    from .torch_hygiene import TorchHygienePass

    return [
        TorchHygienePass(),
        MetricsCardinalityPass(),
        ConcurrencyPass(),
        EventSchemaPass(),
        ProtocolCompatPass(),
    ]


def discover_files(root: str, paths: list[str] | None = None) -> list[str]:
    """Repo-relative .py paths under ``paths`` (default: the package dir)."""
    if not paths:
        paths = ["s2_verification_tpu_torch"]
    rels: set[str] = set()
    for p in paths:
        absp = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(absp) and absp.endswith(".py"):
            rels.add(os.path.relpath(absp, root).replace(os.sep, "/"))
            continue
        for dirpath, dirnames, filenames in os.walk(absp):
            dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
            for fn in filenames:
                if fn.endswith(".py"):
                    rel = os.path.relpath(os.path.join(dirpath, fn), root)
                    rels.add(rel.replace(os.sep, "/"))
    return sorted(rels)


class LintEngine:
    def __init__(
        self,
        root: str,
        passes: list[Pass] | None = None,
        cache_path: str | None = None,
    ):
        self.root = root
        self.passes = passes if passes is not None else default_passes()
        self.cache_path = cache_path
        self._cache: dict = {}
        if cache_path and os.path.exists(cache_path):
            try:
                with open(cache_path, "r", encoding="utf-8") as f:
                    doc = json.load(f)
                if doc.get("schema") == CACHE_SCHEMA:
                    self._cache = doc.get("files", {})
            except (OSError, ValueError):
                self._cache = {}

    def _save_cache(self) -> None:
        if not self.cache_path:
            return
        try:
            with open(self.cache_path, "w", encoding="utf-8") as f:
                json.dump({"schema": CACHE_SCHEMA, "files": self._cache}, f)
        except OSError:
            pass

    def run(self, rel_paths: list[str] | None = None, paths: list[str] | None = None) -> RunResult:
        selected = rel_paths if rel_paths is not None else discover_files(self.root, paths)
        if rel_paths is None and paths is None:
            ctx = TreeContext(self.root, selected)
            scope: set | None = None
        else:
            # Tree passes resolve cross-file references (emit sites, the
            # wire table, one-hop imports), so a partial scan still parses
            # the whole package — only the *findings* are scoped to the
            # selected files.  Otherwise `lint --changed` on a consumer
            # file would report every event as never-emitted.
            scope = set(selected)
            ctx = TreeContext(
                self.root, sorted(scope | set(discover_files(self.root, None)))
            )
        raw: list[Finding] = []
        cache_hits = 0

        for info in ctx.files:
            if scope is not None and info.rel not in scope:
                continue
            if info.parse_error is not None:
                raw.append(
                    Finding("parse-error", ERROR, info.rel, 0, f"syntax error: {info.parse_error}")
                )

        for p in self.passes:
            if p.per_file:
                for info in ctx.files:
                    if scope is not None and info.rel not in scope:
                        continue
                    ent = self._cache.get(info.rel)
                    if ent and ent.get("sha") == info.sha and p.name in ent.get("passes", {}):
                        raw.extend(Finding.from_dict(d) for d in ent["passes"][p.name])
                        cache_hits += 1
                        continue
                    if info.tree is None:
                        continue
                    found = p.check_file(info)
                    raw.extend(found)
                    ent = self._cache.setdefault(info.rel, {"sha": info.sha, "passes": {}})
                    if ent.get("sha") != info.sha:
                        ent["sha"] = info.sha
                        ent["passes"] = {}
                    ent["passes"][p.name] = [f.to_dict() for f in found]
            else:
                raw.extend(
                    f
                    for f in p.run(ctx)
                    if scope is None or f.path in scope
                )

        # drop cache entries for files no longer scanned? keep — cheap, stable.
        self._save_cache()

        suppressed = 0
        kept: list[Finding] = []
        supp_cache: dict[str, tuple[dict[int, set[str]], set[str]]] = {}
        for f in raw:
            info = ctx.get(f.path)
            if info is None:
                kept.append(f)
                continue
            if f.path not in supp_cache:
                supp_cache[f.path] = scan_suppressions(info.text)
            per_line, file_level = supp_cache[f.path]
            if _suppressed(f, per_line, file_level):
                suppressed += 1
            else:
                kept.append(f)
        kept.sort(key=_sort_key)
        return RunResult(
            findings=kept,
            suppressed=suppressed,
            files=len(ctx.files) if scope is None else len(scope),
            passes=[p.name for p in self.passes],
            cache_hits=cache_hits,
        )


# --------------------------------------------------------------------------
# small shared AST helpers used by several passes


def dotted_name(node: ast.AST) -> str | None:
    """'a.b.c' for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def const_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def module_constants(tree: ast.AST) -> dict[str, ast.expr]:
    """Module-level NAME = <expr> simple assignments."""
    out: dict[str, ast.expr] = {}
    for node in getattr(tree, "body", []):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Name):
                out[t.id] = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            if isinstance(node.target, ast.Name):
                out[node.target.id] = node.value
    return out


def literal_str_tuple(node: ast.expr | None) -> list[str] | None:
    """['a','b'] if node is a tuple/list/set of string constants, else None."""
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        vals = []
        for el in node.elts:
            s = const_str(el)
            if s is None:
                return None
            vals.append(s)
        return vals
    return None


def walk_with_parents(root: ast.AST) -> Iterable[tuple[ast.AST, list[ast.AST]]]:
    """Yield (node, ancestor-stack) depth-first.  Stack excludes the node."""
    stack: list[tuple[ast.AST, list[ast.AST]]] = [(root, [])]
    while stack:
        node, parents = stack.pop()
        yield node, parents
        child_parents = parents + [node]
        for child in ast.iter_child_nodes(node):
            stack.append((child, child_parents))


def iter_functions(tree: ast.AST) -> Iterable[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node  # type: ignore[misc]


Resolver = Callable[[str], ast.expr | None]


def name_resolver(ctx: TreeContext, info: FileInfo) -> Resolver:
    """Resolve NAME -> module-level constant expr, following one-hop
    ``from X import NAME`` imports into sibling modules in the tree."""
    consts = module_constants(info.tree) if info.tree else {}
    imports: dict[str, str] = {}
    for node in getattr(info.tree, "body", []):
        if isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                imports[alias.asname or alias.name] = f"{node.module}.{alias.name}"

    def resolve(name: str) -> ast.expr | None:
        if name in consts:
            return consts[name]
        target = imports.get(name)
        if not target:
            return None
        mod, _, attr = target.rpartition(".")
        modfile = mod.split(".")[-1] + ".py"
        for cand in ctx.by_basename(modfile):
            if cand.tree is None:
                continue
            other = module_constants(cand.tree)
            if attr in other:
                return other[attr]
        return None

    return resolve
