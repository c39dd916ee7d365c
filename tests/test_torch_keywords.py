"""Port parity: the entry points take the JAX engine's keywords, and the
CLI's ``-device-rows``.

- Every keyword of the JAX ``check_device`` and ``check_device_auto``
  gives the JAX engine's result on the CPU (outcome, search statistics,
  witness, final states, refusals); ``witness=False`` answers OK without a
  linearization, and ``mesh`` (four CPU shards against the JAX engine's
  four-device mesh) answers as unsharded, with the JAX engine's per-shard
  peaks.
- A progress sink adds no host synchronisation, and its heartbeats equal
  the JAX engine's through the chunked tier too.
- ``check -device cpu -device-rows N -stats`` exits as the JAX CLI does with
  the same counters, ``N`` reaches the exhaustive phase, and the oracle
  backend warns and ignores it.
- ``VerifydConfig`` has every field of the JAX package's with its default,
  plus only ``torch_device``; ``serve`` and ``submit`` take the JAX flags
  with their defaults, and so do ``follow``, ``trace``, ``dash``,
  ``watch``, ``soak`` and ``route serve|drain|undrain|fleet``;
  ``RouterConfig``, ``BackendSpec``, ``DistSearchConfig`` and
  ``SoakConfig`` have the JAX fields with their defaults, and no more.
- Every keyword of the JAX ``check_batch_native`` and ``check_batch_vmap``
  gives the JAX engines' lane verdicts and layers (the port's vmap engine
  adds only ``device``), and ``BatchLane`` has the JAX fields;
  ``check_native(enc=)`` takes a padded encoding and answers as the JAX
  engine does.
- ``check_frontier``, ``check_frontier_auto`` and ``check_native`` take
  every keyword of the JAX package's, of the same kind and with the same
  default.
"""

import dataclasses
import importlib
import inspect
import json
import logging

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from s2_verification_tpu import cli as jcli
from s2_verification_tpu.checker.progress import ProgressSink as JaxSink
from s2_verification_tpu.models.encode import encode_batch as jax_encode_batch
from s2_verification_tpu_torch import cli as pcli
from s2_verification_tpu_torch.checker import batched as pbatched
from s2_verification_tpu_torch.checker import device as pdev
from s2_verification_tpu_torch.checker import native as pnative
from s2_verification_tpu_torch.checker.oracle import CheckOutcome
from s2_verification_tpu_torch.checker.progress import ProgressSink as PortSink
from s2_verification_tpu_torch.models.encode import encode_batch
from s2_verification_tpu_torch.parallel import frontier_mesh

from test_torch_device import assert_results_equal, both, jax_adversarial, jdev
from test_torch_encode import jax_text
from test_torch_progress import Clock

STAT_FIELDS = (
    "layers", "max_frontier", "expanded", "auto_closed", "pruned", "prune_commits",
    "prune_dead", "spec_launches", "spec_layers", "spec_accepts", "spec_rollbacks",
)

#: A setting of each JAX keyword (with whatever it needs beside it).  The
#: baseline is an exhaustive search of a small adversarial history whose
#: frontier (peak 161 rows) outgrows a 64-row bucket.
SETTINGS = {
    "max_frontier": dict(max_frontier=256),
    "exhaustive_cap": dict(exhaustive_cap=256),
    "beam_width": dict(beam_width=32),
    "state_slots": dict(state_slots=4),
    "beam": dict(beam=True, max_frontier=64),
    "start_frontier": dict(start_frontier=64),
    # Four shards: the JAX engine's four-device CPU mesh, the port's four
    # CPU shards.
    "mesh": dict(mesh=4),
    "collect_stats": dict(collect_stats=False),
    "profile": dict(profile=True),
    "checkpoint_path": dict(checkpoint_path="ck.npz"),
    "checkpoint_every": dict(checkpoint_every=3),
    "witness": dict(witness=False),
    # The log is on until the frontier outgrows 64 rows, then dropped.
    "witness_max_frontier": dict(witness_max_frontier=64),
    # Past the device bucket both engines hand off to the spill.
    "spill": dict(spill=True, max_frontier=64, beam_width=2, exhaustive_cap=64, device_rows_cap=0),
    "spill_host_cap": dict(spill_host_cap=1000),
    "exact_pack": dict(exact_pack=False),
    "sort_dedup": dict(sort_dedup=True),
    "device_rows_cap": dict(device_rows_cap=4096, max_frontier=64, exhaustive_cap=64),
    "pallas_fold": dict(pallas_fold=True),
    "progress": dict(progress="sink"),
    "prune": dict(prune=True),
    "speculate_depth": dict(speculate_depth=2, prune=True),
    "speculate_width": dict(speculate_width=8, speculate_depth=2),
}

ENTRIES = {
    "check_device": dict(max_frontier=4096, beam=False, collect_stats=True),
    "check_device_auto": dict(beam_width=16, exhaustive_cap=4096, collect_stats=True, spill=False),
}


def _keywords(entry):
    return [p for p in inspect.signature(getattr(jdev, entry)).parameters if p != "history"]


KEYWORD_CASES = [(e, k) for e in ENTRIES for k in _keywords(e)]


def _kw(entry, keyword, who):
    kw = dict(ENTRIES[entry])
    kw.update(SETTINGS[keyword])
    names = _keywords(entry)
    kw = {k: v for k, v in kw.items() if k in names}
    if kw.get("progress") == "sink":
        kw["progress"] = (JaxSink if who == "jax" else PortSink)(lambda r: None, time_fn=Clock(step=1.0))
    if "mesh" in kw:
        n = kw["mesh"]
        kw["mesh"] = Mesh(np.asarray(jax.devices()[:n]), ("fr",)) if who == "jax" else frontier_mesh(devices=["cpu"] * n)
    return kw


@pytest.mark.parametrize("entry,keyword", KEYWORD_CASES, ids=[f"{e}-{k}" for e, k in KEYWORD_CASES])
def test_jax_keywords_work_or_name_themselves(tmp_path, monkeypatch, entry, keyword):
    monkeypatch.chdir(tmp_path)
    assert set(_keywords(entry)) <= set(inspect.signature(getattr(pdev, entry)).parameters)
    hj, hp = both(jax_adversarial(5, batch=4, seed=1))
    port = getattr(pdev, entry)
    rj = getattr(jdev, entry)(hj, **_kw(entry, keyword, "jax"))
    rp = port(hp, device="cpu", **_kw(entry, keyword, "port"))
    assert rp.outcome == CheckOutcome.OK
    if keyword == "witness":
        assert rp.linearization is None and rj.linearization is None
    if keyword == "collect_stats":
        assert not hasattr(rp, "stats") and not hasattr(rj, "stats")
        assert rp.linearization == rj.linearization
        return
    assert_results_equal(rj, rp, hp)
    for f in STAT_FIELDS:
        assert getattr(rp.stats, f) == getattr(rj.stats, f), f
    if keyword == "mesh":
        plain = port(hp, device="cpu", **{k: v for k, v in _kw(entry, keyword, "port").items() if k != "mesh"})
        assert_results_equal(rj, plain, hp)
        assert [e["peak_occupancy"] for e in rp.stats.shards] == [e["peak_occupancy"] for e in rj.stats.shards]


@pytest.mark.parametrize("chunked", [False, True], ids=["in-core", "chunked"])
def test_progress_adds_no_sync_and_beats_match_jax(chunked):
    hj, hp = both(jax_adversarial(6, batch=4, seed=1, unsatisfiable=True))
    kw = dict(beam=False, collect_stats=True)
    kw.update(dict(max_frontier=64, device_rows_cap=4096) if chunked else dict(max_frontier=4096))
    plain = pdev.check_device(hp, device="cpu", **kw)
    beats = {}
    for who, sink_cls, run in (
        ("jax", JaxSink, lambda sink: jdev.check_device(hj, progress=sink, **kw)),
        ("port", PortSink, lambda sink: pdev.check_device(hp, device="cpu", progress=sink, **kw)),
    ):
        out = []
        sink = sink_cls(out.append, min_interval_s=0.5, time_fn=Clock(step=1.0))
        res = run(sink)
        beats[who] = (res.outcome.value, out)
    assert beats["port"] == beats["jax"] and beats["port"][1]
    assert res.stats.host_syncs == plain.stats.host_syncs > 0


def _write(tmp_path, events):
    path = tmp_path / "h.jsonl"
    path.write_text(jax_text(events))
    return str(path)


@pytest.mark.parametrize("unsat", [False, True])
def test_cli_device_rows_matches_jax(tmp_path, capsys, monkeypatch, unsat):
    monkeypatch.chdir(tmp_path)
    path = _write(tmp_path, jax_adversarial(6, batch=2, seed=3, unsatisfiable=unsat))
    rc_j = jcli.main(["check", f"-file={path}", "-backend=device", "-no-viz", "-stats", "-device-rows", "4096"])
    line_j = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    seen = []
    real = pdev.check_device

    def spy(history, **kw):
        seen.append(kw)
        return real(history, **kw)

    monkeypatch.setattr(pdev, "check_device", spy)
    rc_p = pcli.main(["check", f"-file={path}", "-backend=device", "-no-viz", "-device", "cpu", "-stats",
                      "-device-rows", "4096"])
    line_p = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc_p == rc_j == (1 if unsat else 0)
    for f in ("outcome", "layers", "max_frontier", "expanded", "auto_closed", "pruned", "witness"):
        assert line_p[f] == line_j[f], f
    exhaustive = [kw for kw in seen if not kw["beam"]]
    assert [kw["device_rows_cap"] for kw in exhaustive] == ([4096] if exhaustive else [])
    assert not any("device_rows_cap" in kw for kw in seen if kw["beam"])


def test_cli_oracle_warns_and_ignores_device_rows(tmp_path, capsys, caplog):
    path = _write(tmp_path, jax_adversarial(4, batch=2, seed=1))
    with caplog.at_level(logging.WARNING):
        rc = pcli.main(["check", f"-file={path}", "-backend=oracle", "-no-viz", "-device-rows", "7", "-stats"])
    assert rc == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["outcome"] == "ok"
    assert any("-device-rows only applies to the device search" in r.getMessage() for r in caplog.records)


# -- the batched engines and check_native(enc=) -------------------------------

jbatched = importlib.import_module("s2_verification_tpu.checker.batched")
jnative = importlib.import_module("s2_verification_tpu.checker.native")

#: a setting of each JAX keyword of the two batched engines, made for the
#: package (``who``) and the lane count (``n``)
BATCH_SETTINGS = {
    "capacity": lambda who, n: 4,
    "skip": lambda who, n: (lambda i: "cancelled" if i == 2 else None),
    "on_lane": lambda who, n: (lambda i, v: None),
    "progress": lambda who, n: [(JaxSink if who == "jax" else PortSink)(lambda r: None, time_fn=Clock(step=1.0))
                                for _ in range(n)],
    "profile": lambda who, n: True,
    "prune": lambda who, n: True,
}
BATCH_ENTRIES = ("check_batch_native", "check_batch_vmap")
BATCH_CASES = [(e, k) for e in BATCH_ENTRIES for k in inspect.signature(getattr(jbatched, e)).parameters
               if k != "lanes"]


def _batch_histories():
    return [
        both(jax_adversarial(4, batch=3, seed=s, unsatisfiable=s == 2)) for s in range(3)
    ] + [both(jax_adversarial(5, batch=2, seed=4))]


@pytest.mark.parametrize("entry,keyword", BATCH_CASES, ids=[f"{e}-{k}" for e, k in BATCH_CASES])
def test_batched_engines_take_the_jax_keywords(entry, keyword):
    assert keyword in inspect.signature(getattr(pbatched, entry)).parameters
    pairs = _batch_histories()
    out = {}
    for who, mod, hists, enc_batch in (
        ("jax", jbatched, [j for j, _ in pairs], jax_encode_batch),
        ("port", pbatched, [p for _, p in pairs], encode_batch),
    ):
        lanes = [mod.BatchLane(h, e) for h, e in zip(hists, enc_batch(hists))]
        kw = {keyword: BATCH_SETTINGS[keyword](who, len(hists))}
        if who == "port" and entry == "check_batch_vmap":
            kw["device"] = "cpu"
        verdicts = getattr(mod, entry)(lanes, **kw)
        out[who] = [(v.engine, v.result and v.result.outcome.value, v.layers, v.skipped) for v in verdicts]
    assert out["port"] == out["jax"]


def test_batched_engines_add_only_the_device_and_lanes_have_the_jax_fields():
    for entry in BATCH_ENTRIES:
        j = inspect.signature(getattr(jbatched, entry)).parameters
        p = inspect.signature(getattr(pbatched, entry)).parameters
        assert set(p) - set(j) == ({"device"} if entry == "check_batch_vmap" else set())
        assert {k: (p[k].kind, p[k].default) for k in j} == {k: (j[k].kind, j[k].default) for k in j}
    assert [f.name for f in dataclasses.fields(pbatched.BatchLane)] == [
        f.name for f in dataclasses.fields(jbatched.BatchLane)
    ]
    assert pbatched.default_engine() == jbatched.default_engine()


jfrontier = importlib.import_module("s2_verification_tpu.checker.frontier")
pfrontier = importlib.import_module("s2_verification_tpu_torch.checker.frontier")
HOST_ENGINES = (
    (jfrontier, pfrontier, "check_frontier"),
    (jfrontier, pfrontier, "check_frontier_auto"),
    (jnative, pnative, "check_native"),
)
HOST_CASES = [(j, p, e, k) for j, p, e in HOST_ENGINES for k in inspect.signature(getattr(j, e)).parameters]


@pytest.mark.parametrize("jmod,pmod,entry,keyword", HOST_CASES, ids=[f"{e}-{k}" for _, _, e, k in HOST_CASES])
def test_host_engines_take_every_jax_keyword(jmod, pmod, entry, keyword):
    jp = inspect.signature(getattr(jmod, entry)).parameters[keyword]
    pp = inspect.signature(getattr(pmod, entry)).parameters[keyword]
    assert (pp.kind, pp.default) == (jp.kind, jp.default)


def test_check_native_takes_enc_like_jax():
    assert "enc" in inspect.signature(pnative.check_native).parameters
    for hj, hp in _batch_histories():
        jenc, penc = jax_encode_batch([hj, hj])[0], encode_batch([hp, hp])[0]
        rj = jnative.check_native(hj, enc=jenc, prune=True)
        rp = pnative.check_native(hp, enc=penc, prune=True)
        assert (rp.outcome.value, rp.linearization, rp.deepest, rp.steps) == (
            rj.outcome.value, rj.linearization, rj.deepest, rj.steps
        )


# -- the supervised device escalation: supervised_device_check and drive --------

jresilient = importlib.import_module("s2_verification_tpu.checker.resilient")
jsupervise = importlib.import_module("s2_verification_tpu.service.supervise")
presilient = importlib.import_module("s2_verification_tpu_torch.checker.resilient")
psupervise = importlib.import_module("s2_verification_tpu_torch.service.supervise")
SUPERVISE_CASES = [
    (who, name, k)
    for who, name, jfn in (
        ("supervise", "supervised_device_check", jsupervise.supervised_device_check),
        ("resilient", "drive", jresilient.drive),
    )
    for k in inspect.signature(jfn).parameters
]


@pytest.mark.parametrize("who,name,keyword", SUPERVISE_CASES, ids=[f"{n}-{k}" for _, n, k in SUPERVISE_CASES])
def test_supervision_takes_every_jax_keyword(who, name, keyword):
    """``supervised_device_check`` and ``drive`` take every keyword of the
    JAX package's, of the same kind and with the same default (the port
    adds ``device`` to the first)."""
    jmod, pmod = (jsupervise, psupervise) if who == "supervise" else (jresilient, presilient)
    jp = inspect.signature(getattr(jmod, name)).parameters[keyword]
    pp = inspect.signature(getattr(pmod, name)).parameters[keyword]
    assert pp.kind == jp.kind
    if isinstance(jp.default, jresilient.Tracer):  # each package's NULL_TRACER
        assert pp.default is presilient.NULL_TRACER and not pp.default.enabled
    else:
        assert pp.default == jp.default


def test_supervised_device_check_adds_only_device():
    j = set(inspect.signature(jsupervise.supervised_device_check).parameters)
    p = set(inspect.signature(psupervise.supervised_device_check).parameters)
    assert p - j == {"device"}
    assert inspect.signature(psupervise.supervised_device_check).parameters["device"].default is None


# -- the daemon's config --------------------------------------------------------

jdaemon = importlib.import_module("s2_verification_tpu.service.daemon")
pdaemon = importlib.import_module("s2_verification_tpu_torch.service.daemon")
JAX_CONFIG_FIELDS = [f.name for f in dataclasses.fields(jdaemon.VerifydConfig)]


@pytest.mark.parametrize("name", JAX_CONFIG_FIELDS)
def test_verifyd_config_has_every_jax_field_with_its_default(name):
    """``VerifydConfig`` has each field of the JAX package's, with the same
    default (``extra``'s factory makes an equal empty dict)."""
    jf = {f.name: f for f in dataclasses.fields(jdaemon.VerifydConfig)}[name]
    pf = {f.name: f for f in dataclasses.fields(pdaemon.VerifydConfig)}[name]
    assert pf.default == jf.default
    assert (pf.default_factory is dataclasses.MISSING) == (jf.default_factory is dataclasses.MISSING)
    if jf.default_factory is not dataclasses.MISSING:
        assert pf.default_factory() == jf.default_factory()


def test_verifyd_config_adds_only_the_torch_device():
    p = {f.name for f in dataclasses.fields(pdaemon.VerifydConfig)}
    assert p - set(JAX_CONFIG_FIELDS) == {"torch_device"}
    assert pdaemon.VerifydConfig(socket_path="s").torch_device is None


def test_serve_and_submit_take_the_jax_flags_and_defaults():
    """Each flag of the JAX ``serve`` and ``submit`` parses to the JAX
    default in the port (``serve`` adds ``--torch-device``)."""
    for argv, added in ((["serve", "-socket", "S"], {"torch_device"}), (["submit", "-file", "F", "-socket", "S"], set())):
        jargs = vars(jcli.build_parser().parse_args(argv))
        pargs = vars(pcli.build_parser().parse_args(argv))
        jargs.pop("fn"), pargs.pop("fn")
        assert set(pargs) - set(jargs) == added
        assert {k: pargs[k] for k in jargs} == jargs


OPERATOR_COMMANDS = {
    "follow": ["follow", "-file", "F", "-socket", "S", "--stream", "s"],
    "trace": ["trace", "-socket", "S"],
    "dash": ["dash", "-socket", "S"],
    "watch": ["watch", "-socket", "S"],
    "soak": ["soak", "S"],
    "lint": ["lint", "--json", "s2_verification_tpu_torch/cli.py"],
}


def test_the_port_has_every_jax_subcommand():
    def commands(mod):
        return set(next(a for a in mod.build_parser()._subparsers._group_actions if a.dest == "cmd").choices)

    assert commands(pcli) == commands(jcli)
    assert len(commands(pcli)) == 15


@pytest.mark.parametrize("command", list(OPERATOR_COMMANDS))
def test_operator_commands_take_the_jax_flags_and_defaults(command):
    """``follow``, ``trace``, ``dash``, ``watch``, ``soak`` and ``lint``
    parse to the JAX package's flags and defaults, each option under the
    JAX names."""
    argv = OPERATOR_COMMANDS[command]
    jargs = vars(jcli.build_parser().parse_args(argv))
    pargs = vars(pcli.build_parser().parse_args(argv))
    assert (jargs.pop("fn").__name__, pargs.pop("fn").__name__) == (f"_cmd_{command}",) * 2
    assert pargs == jargs
    jsub = next(a for a in jcli.build_parser()._subparsers._group_actions if a.dest == "cmd").choices[command]
    psub = next(a for a in pcli.build_parser()._subparsers._group_actions if a.dest == "cmd").choices[command]
    assert sorted(o for a in psub._actions for o in a.option_strings) == sorted(
        o for a in jsub._actions for o in a.option_strings
    )


ROUTE_COMMANDS = {
    "serve": ["route", "serve", "--listen", "R", "--backend", "a=A"],
    "drain": ["route", "drain", "a", "-socket", "R"],
    "undrain": ["route", "undrain", "a", "-socket", "R"],
    "fleet": ["route", "fleet", "-socket", "R"],
}


def _route_sub(cli, name):
    route = next(a for a in cli.build_parser()._subparsers._group_actions if a.dest == "cmd").choices["route"]
    return next(a for a in route._subparsers._group_actions if a.dest == "route_cmd").choices[name]


@pytest.mark.parametrize("command", list(ROUTE_COMMANDS))
def test_route_commands_take_the_jax_flags_and_defaults(command):
    """``route serve|drain|undrain|fleet`` parse to the JAX package's flags
    and defaults, each option under the JAX names."""
    argv = ROUTE_COMMANDS[command]
    jargs = vars(jcli.build_parser().parse_args(argv))
    pargs = vars(pcli.build_parser().parse_args(argv))
    assert (jargs.pop("fn").__name__, pargs.pop("fn").__name__) == (f"_cmd_route_{command}",) * 2
    assert pargs == jargs
    assert sorted(o for a in _route_sub(pcli, command)._actions for o in a.option_strings) == sorted(
        o for a in _route_sub(jcli, command)._actions for o in a.option_strings
    )


FLEET_CONFIGS = {
    "RouterConfig": "service.router",
    "BackendSpec": "service.router",
    "DistSearchConfig": "service.distsearch",
    "SoakConfig": "service.soak",
}


@pytest.mark.parametrize("cls", list(FLEET_CONFIGS))
def test_fleet_configs_have_the_jax_fields_with_their_defaults(cls):
    jf = dataclasses.fields(getattr(importlib.import_module(f"s2_verification_tpu.{FLEET_CONFIGS[cls]}"), cls))
    pf = dataclasses.fields(getattr(importlib.import_module(f"s2_verification_tpu_torch.{FLEET_CONFIGS[cls]}"), cls))
    assert [f.name for f in pf] == [f.name for f in jf]
    for j, p in zip(jf, pf):
        assert (p.default, p.type) == (j.default, j.type), p.name
        assert (p.default_factory is dataclasses.MISSING) == (j.default_factory is dataclasses.MISSING), p.name
        if j.default_factory is not dataclasses.MISSING:
            assert p.default_factory() == j.default_factory(), p.name
