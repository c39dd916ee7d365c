"""verifylint in the port (``s2_verification_tpu_torch/analysis``), held
to ``tests/test_analysis.py``'s cases and against the JAX package's engine.

- the fixture corpus: every rule of the port's suite fires exactly at its
  ``# expect:`` anchors of ``tests/fixtures/lint/{tree,tree_notable}``
  and ``tests/fixtures/lint_torch/tree`` and nowhere else (the JAX
  package's ``jit-*`` anchors stay silent: the port has no jit pass);
- suppressions, the baseline ratchet, the per-file cache and partial
  scans, as in the JAX package;
- parity: the four shared passes give the JAX engine's findings on the
  fixture trees, and over the two real trees equal error findings and
  suppression counts once the package prefix is removed; the two event
  registries render equal once paths and lines are normalised;
- the port's tree is clean against its own baseline and events document;
- ``lint`` through ``cli.main`` on a copy of the tree keeps to the port's
  own records and never touches the JAX package's;
- the contention regressions of the prober, dashboard and stats labels,
  against the port's ``obs/`` and ``service/stats.py``.
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import subprocess
import threading

import pytest

from s2_verification_tpu.analysis.concurrency import ConcurrencyPass as JConcurrency
from s2_verification_tpu.analysis.engine import LintEngine as JLintEngine
from s2_verification_tpu.analysis.engine import TreeContext as JTreeContext
from s2_verification_tpu.analysis.engine import discover_files as jdiscover_files
from s2_verification_tpu.analysis.event_schema import EventSchemaPass as JEventSchema
from s2_verification_tpu.analysis.event_schema import render_events_md as jrender_events_md
from s2_verification_tpu.analysis.metrics_cardinality import MetricsCardinalityPass as JMetrics
from s2_verification_tpu.analysis.protocol_compat import ProtocolCompatPass as JProtocol
from s2_verification_tpu_torch import cli
from s2_verification_tpu_torch.analysis import (
    ERROR,
    Finding,
    LintEngine,
    apply_baseline,
    default_passes,
    load_baseline,
    write_baseline,
)
from s2_verification_tpu_torch.analysis.concurrency import ConcurrencyPass
from s2_verification_tpu_torch.analysis.engine import (
    TreeContext,
    discover_files,
    scan_suppressions,
)
from s2_verification_tpu_torch.analysis.event_schema import EventSchemaPass, render_events_md
from s2_verification_tpu_torch.analysis.metrics_cardinality import MetricsCardinalityPass
from s2_verification_tpu_torch.analysis.protocol_compat import ProtocolCompatPass

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
TREES = {
    "tree": os.path.join(FIXTURES, "lint", "tree"),
    "tree_notable": os.path.join(FIXTURES, "lint", "tree_notable"),
    "torch_tree": os.path.join(FIXTURES, "lint_torch", "tree"),
}
JAX_PKG, PORT_PKG = "s2_verification_tpu/", "s2_verification_tpu_torch/"
#: the JAX package's jit-hygiene rules, which the port does not have
JAX_ONLY = {"jit-unwrapped", "jit-in-loop", "jit-unhashable-static", "jit-traced-branch"}

_EXPECT_RE = re.compile(r"#\s*expect:\s*([\w\-, ]+?)\s*$")
_EXPECT_FILE_RE = re.compile(r"#\s*expect-file:\s*([\w\-]+)")


def _expectations(root: str):
    exact, file_level = [], []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, fn), root).replace(os.sep, "/")
            with open(os.path.join(dirpath, fn), encoding="utf-8") as f:
                for i, line in enumerate(f, 1):
                    m = _EXPECT_RE.search(line)
                    if m:
                        exact.extend((rel, i, r.strip()) for r in m.group(1).split(","))
                        continue
                    m = _EXPECT_FILE_RE.search(line)
                    if m:
                        file_level.append((rel, m.group(1)))
    return exact, file_level


def _shared_passes():
    return [MetricsCardinalityPass(), ConcurrencyPass(), EventSchemaPass(), ProtocolCompatPass()]


def _jax_shared_passes():
    return [JMetrics(), JConcurrency(), JEventSchema(), JProtocol()]


def _unprefixed(findings, pkg: str):
    return collections.Counter(
        (f.rule, f.path[len(pkg):] if f.path.startswith(pkg) else f.path, f.message) for f in findings
    )


@pytest.fixture(scope="module")
def results():
    return {name: LintEngine(root).run(paths=["."]) for name, root in TREES.items()}


@pytest.fixture(scope="module")
def tree_result(results):
    return results["tree"]


@pytest.fixture(scope="module")
def real_tree_result():
    return LintEngine(REPO).run()


@pytest.fixture(scope="module")
def real_trees_shared():
    """The four shared passes over each package's own tree."""
    jax = JLintEngine(REPO, passes=_jax_shared_passes()).run(paths=[JAX_PKG.rstrip("/")])
    port = LintEngine(REPO, passes=_shared_passes()).run()
    return jax, port


# --------------------------------------------------------------------------
# fixture corpus


ALL_RULES = sorted(
    [
        "build-unrecorded",
        "build-in-loop",
        "sync-in-loop",
        "metric-open-label",
        "metric-name",
        "concurrency-unlocked-write",
        "event-never-emitted",
        "event-field-unwritten",
        "protocol-no-table",
        "protocol-unknown-op",
        "protocol-unknown-field",
        "protocol-missing-required",
        "protocol-unguarded-read",
        "protocol-unsigned-mismatch",
        "parse-error",
    ]
)


def test_rule_list_is_the_shared_rules_and_the_torch_rules():
    # The JAX suite's 16 rules less its four jit-hygiene rules, plus the
    # three of torch-hygiene.
    from test_analysis import ALL_RULES as JAX_RULES

    assert set(ALL_RULES) == (set(JAX_RULES) - JAX_ONLY) | {
        "build-unrecorded",
        "build-in-loop",
        "sync-in-loop",
    }
    assert [p.name for p in default_passes()] == [
        "torch-hygiene",
        "metrics-cardinality",
        "concurrency",
        "event-schema",
        "protocol-compat",
    ]


@pytest.mark.parametrize("rule", ALL_RULES)
def test_every_rule_fires_on_fixtures(rule, results):
    fired = {f.rule for res in results.values() for f in res.findings}
    assert rule in fired


@pytest.mark.parametrize("tree", sorted(TREES))
def test_fixture_corpus_exact(tree, results):
    """Bidirectional: every annotation of a port rule fires at its line,
    nothing else fires, and the JAX-only jit anchors stay silent."""
    res = results[tree]
    exact, file_level = _expectations(TREES[tree])
    got = [(f.path, f.line, f.rule) for f in res.findings]
    unmatched = list(got)
    missing = []
    for e in exact:
        if e[2] in JAX_ONLY:
            assert not [g for g in got if g[:2] == e[:2]], f"a port rule fired at a jit anchor: {e}"
            continue
        if e in unmatched:
            unmatched.remove(e)
        else:
            missing.append(e)
    for rel, rule in file_level:
        hit = next((g for g in unmatched if g[0] == rel and g[2] == rule), None)
        if hit is not None:
            unmatched.remove(hit)
        else:
            missing.append((rel, None, rule))
    assert not missing, f"annotated findings that did not fire: {missing}"
    assert not unmatched, f"findings with no annotation: {unmatched}"


def test_fixture_suppressions_counted(results):
    # tree: client.py, metric_rules.py, threads_rules.py, one each.  The
    # JAX suite counts 4 there: its fourth, in jit_rules.py, silences a
    # jit-unwrapped finding that no pass of the port raises.
    assert results["tree"].suppressed == 3
    assert results["tree_notable"].suppressed == 0
    # torch_tree: build_rules.py two, checker/device.py one
    assert results["torch_tree"].suppressed == 3


def test_all_findings_are_errors(results):
    for res in results.values():
        for f in res.findings:
            assert f.severity == ERROR


@pytest.mark.parametrize("tree", ["tree", "tree_notable"])
def test_shared_passes_match_jax_on_fixtures(tree):
    root = TREES[tree]
    jax = JLintEngine(root, passes=_jax_shared_passes()).run(paths=["."])
    port = LintEngine(root, passes=_shared_passes()).run(paths=["."])
    assert [f.to_dict() for f in port.findings] == [f.to_dict() for f in jax.findings]
    assert (port.suppressed, port.files) == (jax.suppressed, jax.files)


# --------------------------------------------------------------------------
# suppression scanning


def test_scan_suppressions_same_line_and_shield():
    text = (
        "x = 1  # verifylint: disable=metric-open-label\n"
        "# verifylint: disable=build-unrecorded,build-in-loop\n"
        "y = 2\n"
        "# verifylint: disable-file=concurrency-unlocked-write\n"
    )
    per_line, file_level = scan_suppressions(text)
    assert per_line[1] == {"metric-open-label"}
    # a comment-only directive shields its own line AND the next
    assert per_line[2] == {"build-unrecorded", "build-in-loop"}
    assert per_line[3] == {"build-unrecorded", "build-in-loop"}
    assert file_level == {"concurrency-unlocked-write"}


def test_suppress_all(tmp_path):
    f = tmp_path / "mod.py"
    f.write_text(
        "# verifylint: disable-file=all\n"
        "import subprocess\n"
        "subprocess.run(['nvcc', 'k.cu'])\n"
    )
    res = LintEngine(str(tmp_path)).run(rel_paths=["mod.py"])
    assert res.findings == []
    assert res.suppressed == 1


# --------------------------------------------------------------------------
# baseline ratchet


def _finding(msg: str, line: int = 3) -> Finding:
    return Finding("metric-open-label", ERROR, "pkg/mod.py", line, msg)


def test_ratchet_new_error_fails_baselined_passes(tmp_path):
    old = _finding("old debt")
    new = _finding("fresh regression")
    path = str(tmp_path / "baseline.json")
    write_baseline([old], path)
    ratchet = apply_baseline([old, new], load_baseline(path))
    assert [f.message for f in ratchet.new_errors] == ["fresh regression"]
    assert [f.message for f in ratchet.baselined] == ["old debt"]
    assert ratchet.stale_keys == []


def test_ratchet_fixed_finding_goes_stale(tmp_path):
    old = _finding("old debt")
    path = str(tmp_path / "baseline.json")
    write_baseline([old], path)
    ratchet = apply_baseline([], load_baseline(path))
    assert ratchet.new_errors == []
    assert ratchet.stale_keys == [old.key]


def test_ratchet_keys_are_line_independent_but_count_bounded(tmp_path):
    path = str(tmp_path / "baseline.json")
    write_baseline([_finding("dup", line=10)], path)
    moved = _finding("dup", line=99)  # same key, shuffled line: still covered
    ratchet = apply_baseline([moved], load_baseline(path))
    assert ratchet.new_errors == []
    # a second occurrence of the same key exceeds the baselined count
    ratchet = apply_baseline([moved, _finding("dup", line=100)], load_baseline(path))
    assert len(ratchet.new_errors) == 1


def test_write_baseline_preserves_justifications(tmp_path):
    path = str(tmp_path / "baseline.json")
    f = _finding("kept debt")
    write_baseline([f], path, {f.key: "operator-bounded label"})
    write_baseline([f], path)  # rewrite without passing justifications
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    assert doc["findings"][0]["justification"] == "operator-bounded label"


def test_baseline_files_are_byte_compatible(tmp_path):
    # The same findings make the same baseline document in both packages.
    from s2_verification_tpu.analysis import Finding as JFinding
    from s2_verification_tpu.analysis import write_baseline as jwrite_baseline

    fs = [_finding("a"), _finding("b", line=7), _finding("a", line=9)]
    jwrite_baseline([JFinding(**f.to_dict()) for f in fs], str(tmp_path / "j.json"), {fs[0].key: "why"})
    write_baseline(fs, str(tmp_path / "p.json"), {fs[0].key: "why"})
    assert (tmp_path / "j.json").read_bytes() == (tmp_path / "p.json").read_bytes()


# --------------------------------------------------------------------------
# caching + partial scans


def test_cache_round_trip(tmp_path, tree_result):
    cache = str(tmp_path / "cache.json")
    root = TREES["tree"]
    first = LintEngine(root, cache_path=cache).run(paths=["."])
    second = LintEngine(root, cache_path=cache).run(paths=["."])
    assert first.cache_hits == 0
    assert second.cache_hits > 0
    assert [f.to_dict() for f in first.findings] == [
        f.to_dict() for f in second.findings
    ]
    assert [f.to_dict() for f in first.findings] == [
        f.to_dict() for f in tree_result.findings
    ]


def test_partial_scan_keeps_tree_context():
    """A scoped run (lint --changed) still parses the whole package, so
    tree passes don't report consumers of elsewhere-emitted events."""
    res = LintEngine(REPO).run(rel_paths=[PORT_PKG + "service/stats.py"])
    assert not [
        f
        for f in res.findings
        if f.rule in ("event-never-emitted", "event-field-unwritten")
    ]
    for f in res.findings:
        assert f.path == PORT_PKG + "service/stats.py"


def test_discover_files_defaults_to_the_port():
    rels = discover_files(REPO)
    assert rels and all(r.startswith(PORT_PKG) for r in rels)
    assert PORT_PKG + "analysis/torch_hygiene.py" in rels


# --------------------------------------------------------------------------
# whole-tree smoke, parity with the JAX tree + docs


def test_real_tree_no_new_errors(real_tree_result):
    baseline = load_baseline(os.path.join(REPO, cli.LINT_BASELINE))
    ratchet = apply_baseline(real_tree_result.errors, baseline)
    assert not ratchet.new_errors, [f.key for f in ratchet.new_errors]
    assert not ratchet.stale_keys


def test_real_tree_baseline_is_justified():
    with open(os.path.join(REPO, cli.LINT_BASELINE), encoding="utf-8") as f:
        doc = json.load(f)
    for ent in doc["findings"]:
        assert ent["path"].startswith(PORT_PKG) and ent.get("justification"), ent
        if ent["rule"] == "sync-in-loop":
            assert "ROADMAP.md queue 2 item" in ent["justification"], ent


def test_real_tree_sync_sites_are_the_device_layer_loops(real_tree_result):
    got = collections.Counter(
        f.message.split("loop of '")[1].split("'")[0]
        for f in real_tree_result.findings
        if f.rule == "sync-in-loop"
    )
    assert got == {
        "_auto_close": 1,
        "_expand_layer_chunked": 2,
        "_dive": 1,
        "run_search": 2,
        "_close_pin_shards": 1,
        "_spill_search": 4,
        "check_device": 3,
    }
    assert not [f for f in real_tree_result.findings if f.rule in ("build-unrecorded", "build-in-loop")]


def test_real_trees_agree_on_the_shared_passes(real_trees_shared):
    jax, port = real_trees_shared
    assert len(jax.errors) == len(port.errors) == 59
    assert jax.suppressed == port.suppressed == 10
    assert _unprefixed(port.errors, PORT_PKG) == _unprefixed(jax.errors, JAX_PKG)


def _normalised_registry(text: str) -> list[str]:
    body = text[text.index("\n## ") :]
    body = body.replace(PORT_PKG, "PKG/").replace(JAX_PKG, "PKG/")
    return re.sub(r"(PKG/[\w/]+\.py):\d+", r"\1:N", body).splitlines()


def test_event_registries_agree():
    port = render_events_md(TreeContext(REPO, discover_files(REPO)))
    jax = jrender_events_md(JTreeContext(REPO, jdiscover_files(REPO)))
    assert _normalised_registry(port) == _normalised_registry(jax)
    assert port.count("\n## `") == jax.count("\n## `") > 10


def test_events_md_up_to_date():
    ctx = TreeContext(REPO, discover_files(REPO))
    with open(os.path.join(REPO, cli.LINT_EVENTS_MD), encoding="utf-8") as f:
        assert f.read() == render_events_md(ctx)


# --------------------------------------------------------------------------
# the CLI, on a copy of the tree


_JAX_RECORDS = (".verifylint-baseline.json", "docs/EVENTS.md")


@pytest.fixture(scope="module")
def lint_copy(tmp_path_factory):
    """The port's package and both packages' lint records, copied."""
    root = tmp_path_factory.mktemp("lintrepo")
    shutil.copytree(
        os.path.join(REPO, PORT_PKG),
        root / PORT_PKG,
        ignore=shutil.ignore_patterns("__pycache__", "_build", "csrc"),
    )
    (root / "docs").mkdir()
    for rel in (cli.LINT_BASELINE, cli.LINT_EVENTS_MD, *_JAX_RECORDS):
        shutil.copy(os.path.join(REPO, rel), root / rel)
    return root


@pytest.fixture
def at_copy(lint_copy, monkeypatch):
    monkeypatch.setattr(cli, "_lint_root", lambda: str(lint_copy))
    before = {rel: (lint_copy / rel).read_bytes() for rel in _JAX_RECORDS}
    yield lint_copy
    assert {rel: (lint_copy / rel).read_bytes() for rel in _JAX_RECORDS} == before
    assert not (lint_copy / ".verifylint-cache.json").exists()


def test_cli_lint_is_clean_on_the_port(at_copy, capsys):
    assert cli.main(["lint"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert re.match(r"73 finding\(s\) in \d+ file\(s\): 73 error\(s\) \(0 new, 73 baselined\), 10 suppressed", out[-1])
    assert (at_copy / cli.LINT_CACHE).exists()
    assert cli.main(["lint", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert set(doc) == {
        "files", "suppressed", "cache_hits", "findings", "new_errors", "baselined", "stale_baseline_keys",
    }
    assert (doc["new_errors"], doc["stale_baseline_keys"], doc["baselined"]) == ([], [], 73)
    assert doc["cache_hits"] > 0
    assert cli.main(["lint", "--check-events-md"]) == 0
    assert capsys.readouterr().out.strip() == f"{cli.LINT_EVENTS_MD} is up to date"


def test_cli_lint_write_baseline_keeps_to_the_ports_records(at_copy, capsys):
    path = at_copy / cli.LINT_BASELINE
    before = path.read_bytes()
    assert cli.main(["lint", "--write-baseline", "--no-cache"]) == 0
    assert "73 errors baselined" in capsys.readouterr().out
    assert path.read_bytes() == before  # justifications kept, entries equal
    assert cli.main(["lint", "--write-baseline", PORT_PKG + "cli.py"]) == cli.USAGE_EXIT
    assert cli.main(["lint", "--write-baseline", "--changed"]) == cli.USAGE_EXIT
    assert path.read_bytes() == before


def test_cli_lint_fails_on_a_new_error_and_a_stale_events_md(at_copy, capsys):
    bad = at_copy / PORT_PKG / "ops" / "newbuild.py"
    bad.write_text("import subprocess\n\n\ndef b():\n    subprocess.run(['nvcc', 'k.cu'])\n")
    md = at_copy / cli.LINT_EVENTS_MD
    text = md.read_text()
    try:
        assert cli.main(["lint"]) == 1
        assert "ops/newbuild.py:5: error: [build-unrecorded]" in capsys.readouterr().out
        assert cli.main(["lint", "--no-cache", PORT_PKG + "ops/newbuild.py"]) == 1
        md.write_text(text + "drift\n")
        assert cli.main(["lint", "--check-events-md"]) == 1
        assert cli.main(["lint", "--events-md", cli.LINT_EVENTS_MD]) == 0
        assert md.read_text() == text
    finally:
        bad.unlink()
        md.write_text(text)


def test_cli_lint_changed_scans_only_the_ports_files(at_copy, capsys, monkeypatch):
    porcelain = (
        f" M {PORT_PKG}service/daemon.py\n"
        f" M {JAX_PKG}service/daemon.py\n"
        f"?? {PORT_PKG}README.txt\n"
        f"R  old.py -> {PORT_PKG}ops/xxh3.py\n"
        f"?? {PORT_PKG}gone.py\n"
    )
    real_run = subprocess.run

    def fake_run(argv, *a, **kw):
        if list(argv[:2]) == ["git", "status"]:
            assert kw["cwd"] == str(at_copy)
            return subprocess.CompletedProcess(argv, 0, stdout=porcelain, stderr="")
        return real_run(argv, *a, **kw)

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert cli._lint_changed_paths(str(at_copy)) == [PORT_PKG + "service/daemon.py", PORT_PKG + "ops/xxh3.py"]
    assert cli.main(["lint", "--changed", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["files"] == 2
    assert {f["path"] for f in doc["findings"]} <= {PORT_PKG + "service/daemon.py"}
    assert doc["suppressed"] == 1  # the drain counter's justified write

    def no_git(argv, *a, **kw):
        raise FileNotFoundError("git")

    monkeypatch.setattr(subprocess, "run", no_git)
    assert cli._lint_changed_paths(str(at_copy)) is None


def test_cli_lint_changed_in_a_git_repo(tmp_path):
    root = tmp_path / "repo"
    (root / PORT_PKG).mkdir(parents=True)
    (root / JAX_PKG).mkdir(parents=True)
    (root / PORT_PKG / "a.py").write_text("x = 1\n")
    (root / JAX_PKG / "a.py").write_text("x = 1\n")
    git = ["git", "-c", "user.email=t@t", "-c", "user.name=t"]
    subprocess.run([*git, "init", "-q"], cwd=root, check=True)
    subprocess.run([*git, "add", "-A"], cwd=root, check=True)
    subprocess.run([*git, "commit", "-qm", "seed"], cwd=root, check=True)
    assert cli._lint_changed_paths(str(root)) == []
    (root / PORT_PKG / "a.py").write_text("x = 2\n")
    (root / PORT_PKG / "b.py").write_text("y = 1\n")
    (root / JAX_PKG / "a.py").write_text("x = 2\n")
    assert sorted(cli._lint_changed_paths(str(root))) == [PORT_PKG + "a.py", PORT_PKG + "b.py"]


# --------------------------------------------------------------------------
# regression tests for the findings fixed in-tree


def test_prober_transition_fires_once_under_contention():
    """probe_once is both the poller tick and a public entry; the status
    read-modify-write is locked so a transition fires on_change once."""
    from s2_verification_tpu_torch.obs.probe import HealthProber

    fired = []
    fired_lock = threading.Lock()

    def on_change(name, up):
        with fired_lock:
            fired.append((name, up))

    prober = HealthProber({"b0": lambda: True}, on_change=on_change)
    n = 8
    barrier = threading.Barrier(n)

    def hammer():
        barrier.wait()
        prober.probe_once()

    threads = [threading.Thread(target=hammer) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # first observation is one transition (None -> up), seen exactly once
    assert fired == [("b0", True)]


def test_prober_transition_sequence():
    from s2_verification_tpu_torch.obs.probe import HealthProber

    state = {"up": True}
    fired = []
    prober = HealthProber(
        {"b0": lambda: state["up"]}, on_change=lambda n, up: fired.append(up)
    )
    prober.probe_once()
    prober.probe_once()  # steady: no edge
    state["up"] = False
    prober.probe_once()
    state["up"] = True
    prober.probe_once()
    assert fired == [True, False, True]
    assert prober.status == {"b0": True}


def test_dashboard_throughput_deltas_locked():
    """sample_once's prev_* baseline is read-then-write under the lock;
    sequential ticks must diff against the moving baseline exactly once."""
    from s2_verification_tpu_torch.obs.dashboard import Dashboard
    from s2_verification_tpu_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry()
    completed = reg.counter("verifyd_jobs_completed_total", "test")
    times = iter([0.0, 1.0, 2.0, 4.0])
    dash = Dashboard(reg, time_fn=lambda: next(times))
    assert dash.sample_once()["throughput"] == 0.0  # no baseline yet
    completed.inc(5)
    assert dash.sample_once()["throughput"] == 5.0  # 5 jobs / 1 s
    assert dash.sample_once()["throughput"] == 0.0  # baseline advanced
    completed.inc(4)
    assert dash.sample_once()["throughput"] == 2.0  # 4 jobs / 2 s
    assert len(dash.payload()["t"]) == 4


def test_stats_backend_label_folded():
    """Sized backend values must fold to the engine family before they
    become a label — no timeseries per mesh size / device ordinal."""
    from s2_verification_tpu_torch.obs.metrics import MetricsRegistry
    from s2_verification_tpu_torch.service.stats import ServiceStats

    reg = MetricsRegistry()
    stats = ServiceStats(sink=None, registry=reg)
    for backend in ("device-mesh[4]", "device-mesh[8]", "device-3", "native", "zzz-custom"):
        stats.emit("done", verdict=0, wall_s=0.1, backend=backend)
    wall = reg.get("verifyd_wall_seconds")
    assert wall.counts(backend="device-mesh")[2] == 2
    assert wall.counts(backend="device")[2] == 1
    assert wall.counts(backend="native")[2] == 1
    assert wall.counts(backend="other")[2] == 1
    assert wall.counts(backend="device-mesh[4]")[2] == 0


def test_stats_writer_label_folded():
    from s2_verification_tpu_torch.obs.metrics import MetricsRegistry
    from s2_verification_tpu_torch.service.stats import ServiceStats

    reg = MetricsRegistry()
    stats = ServiceStats(sink=None, registry=reg)
    stats.emit("writer_degraded", writer="surprise-writer-17")
    g = reg.get("verifyd_writer_degraded")
    assert g.value(writer="other") == 1
    stats.emit("writer_recovered", writer="surprise-writer-17")
    assert g.value(writer="other") == 0
    stats.emit("writer_degraded", writer="journal")
    assert g.value(writer="journal") == 1


def test_kernel_launch_labels_are_folded():
    """The daemon's ``verifyd_kernel_launches_total``: ``where`` through
    (inline, children), ``kernel`` through fold_cuda.LAUNCHES's keys, and
    every other kernel a child reports summed under ``other``."""
    from s2_verification_tpu_torch.obs.metrics import MetricsRegistry
    from s2_verification_tpu_torch.ops import fold_cuda
    from s2_verification_tpu_torch.service.daemon import Verifyd

    assert set(fold_cuda.LAUNCHES) == {"fold_lanes"}
    reg = MetricsRegistry()
    d = Verifyd.__new__(Verifyd)
    d._m_launches = reg.counter("verifyd_kernel_launches_total", "t", labelnames=("kernel", "where"))
    d._launch_metric_lock = threading.Lock()
    counts = {"inline": {"fold_lanes": 4}, "children": {"fold_lanes": 2, "k_a": 3, "k_b": 5}}
    d.launch_counts = lambda: counts
    d._refresh_launch_metrics()
    counts["children"]["k_b"] = 6
    d._refresh_launch_metrics()
    m = d._m_launches
    assert m.value(kernel="fold_lanes", where="inline") == 4
    assert m.value(kernel="fold_lanes", where="children") == 2
    assert m.value(kernel="other", where="children") == 9
    assert m.value(kernel="k_a", where="children") == 0
