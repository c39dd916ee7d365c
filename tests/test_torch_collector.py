"""Port parity: the collector writes the JAX collector's histories, byte for byte.

The same ``CollectConfig`` goes through ``s2_verification_tpu.collector``
and ``s2_verification_tpu_torch.collector``; the JSONL of the two event
lists (each package's own ``write_history``) must be equal strings:

- each workflow at three seeds, under chaos without latency;
- the ``chaos`` default stream, whose latency interleaves the clients;
- match-seq-num 5×200 with the benchmark's fault plan (``bench.py:395-400``);
- a stream that starts non-empty (the rectifying append);
- ``collect_to_file`` against the buffered bytes.

Also: a read hashes only the records appended since the run's last read
(each record body hashed once by the reader), the reader's prefix cache
against a fold from the head on grown, stale and rewritten reads, and the
``collect`` CLI's exit codes, printed path and its history through ``check
-backend=device -device cpu`` against the JAX engine's verdict and
statistics.
"""

import importlib
import io
import json
import os
import random

import pytest

from s2_verification_tpu.checker.entries import prepare as jax_prepare
from s2_verification_tpu.collector import collect as jcollect
from s2_verification_tpu.collector import fake_s2 as jfake
from s2_verification_tpu.utils import events as jev
from s2_verification_tpu_torch import cli
from s2_verification_tpu_torch.checker.oracle import CheckOutcome, check_events
from s2_verification_tpu_torch.collector import collect as pcollect
from s2_verification_tpu_torch.collector import fake_s2 as pfake
from s2_verification_tpu_torch.collector import workloads as pworkloads
from s2_verification_tpu_torch.utils import events as pev
from s2_verification_tpu_torch.utils.hashing import stream_hash_of_bodies

jdev = importlib.import_module("s2_verification_tpu.checker.device")


def bench_faults(fake, clients: int, ops: int):
    """The fault plan of ``bench.py:395-400``, from ``fake``'s package."""
    return fake.FaultPlan(
        p_append_definite=0.05,
        p_append_indefinite=12.0 / max(clients * ops, 1),
        p_read_fail=0.02,
        p_check_tail_fail=0.02,
    )


def configs(**kw):
    """One config in each package: ``faults`` is a function of the package's
    fake_s2 module (or absent, for the chaos default)."""
    faults = kw.pop("faults", None)
    return tuple(
        mod.CollectConfig(**kw, faults=None if faults is None else faults(fake))
        for mod, fake in ((jcollect, jfake), (pcollect, pfake))
    )


def jsonl(events, codec) -> str:
    buf = io.StringIO()
    codec.write_history(events, buf)
    return buf.getvalue()


def both_bytes(jcfg, pcfg, jstream=None, pstream=None) -> tuple[str, str]:
    return (
        jsonl(jcollect.collect_history(jcfg, jstream), jev),
        jsonl(pcollect.collect_history(pcfg, pstream), pev),
    )


def _chaos(fake):
    return fake.FaultPlan.chaos(intensity=0.25, max_latency=0.0)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("workflow", ["regular", "match-seq-num", "fencing"])
def test_collected_bytes_equal_jax(workflow, seed):
    jcfg, pcfg = configs(
        num_concurrent_clients=3,
        num_ops_per_client=20,
        workflow=workflow,
        seed=seed,
        indefinite_failure_backoff_s=0.0,
        faults=_chaos,
    )
    want, got = both_bytes(jcfg, pcfg)
    assert want.count("\n") > 40
    assert got == want


def test_chaos_default_bytes_equal_jax():
    # No fault plan: default_stream's FaultPlan.chaos(), 2 ms of latency on
    # every call and the 1 ms rotation backoff, so the clients interleave.
    jcfg, pcfg = configs(num_concurrent_clients=4, num_ops_per_client=30, seed=7)
    want, got = both_bytes(jcfg, pcfg)
    assert got == want
    clients_in_order = [json.loads(ln)["client_id"] for ln in got.splitlines()]
    switches = sum(a != b for a, b in zip(clients_in_order, clients_in_order[1:]))
    assert switches > len(clients_in_order) // 4


def test_bench_match_seq_num_5x200_equal_jax():
    jcfg, pcfg = configs(
        num_concurrent_clients=5,
        num_ops_per_client=200,
        workflow="match-seq-num",
        seed=4242,
        faults=lambda fake: bench_faults(fake, 5, 200),
    )
    want, got = both_bytes(jcfg, pcfg)
    assert got == want
    assert check_events(list(pev.iter_history(io.StringIO(got)))).outcome == CheckOutcome.OK


def test_rectifying_append_equal_jax():
    jcfg, pcfg = configs(
        num_concurrent_clients=3, num_ops_per_client=15, seed=2, faults=_chaos,
        indefinite_failure_backoff_s=0.0,
    )
    pre = [b"pre1", b"pre2", bytes(300)]
    jstream = jfake.FakeS2Stream(rng=random.Random(1))
    jstream.records.extend(jfake._Record(b) for b in pre)
    pstream = pfake.FakeS2Stream(rng=random.Random(1))
    pstream.records.extend(pfake._Record(b) for b in pre)
    want, got = both_bytes(jcfg, pcfg, jstream, pstream)
    assert got == want
    first = json.loads(got.splitlines()[0])
    assert first["client_id"] == 0 and first["event"]["Start"]["Append"]["num_records"] == 3


def test_collect_to_file_matches_buffered_bytes(tmp_path):
    jcfg, pcfg = configs(num_concurrent_clients=3, num_ops_per_client=25, seed=4,
                         workflow="fencing")
    path = pcollect.collect_to_file(pcfg, out_dir=str(tmp_path))
    assert os.path.basename(path).startswith("records.") and path.endswith(".jsonl")
    with open(path, encoding="utf-8") as f:
        streamed = f.read()
    assert streamed == jsonl(pcollect.collect_history(pcfg), pev)
    assert streamed == jsonl(jcollect.collect_history(jcfg), jev)


def test_read_folds_only_new_records(monkeypatch):
    # The reader hashes and chains each record body once, however many reads
    # return it; a fold from the head on every read would chain far more.
    chained = []
    real_chain = pworkloads.chain_hash
    monkeypatch.setattr(
        pworkloads, "chain_hash", lambda s, r: chained.append(r) or real_chain(s, r)
    )
    stream = pcollect.default_stream(
        pcfg := pcollect.CollectConfig(5, 200, "match-seq-num", seed=4242,
                                       faults=bench_faults(pfake, 5, 200))
    )
    events = pcollect.collect_history(pcfg, stream)
    reads = [e.event for e in events if isinstance(e.event, pev.ReadSuccess)]
    assert len(reads) > 100
    assert 0 < len(chained) <= stream.tail
    assert sum(r.tail for r in reads) > 20 * stream.tail  # a refold would chain this many
    bodies = stream.snapshot_bodies()
    assert all(r.stream_hash == stream_hash_of_bodies(bodies[: r.tail]) for r in reads)


def test_read_hashes_match_a_fold_from_the_head():
    # Grown, equal, stale (a prefix) and rewritten (a swap inside the kept
    # bodies) reads, in one sequence, each against the plain fold.
    rng = random.Random(3)
    stream = [rng.randbytes(rng.randint(0, 300)) for _ in range(40)]
    swapped = stream[:30] + [stream[31], stream[30]] + stream[32:]
    cache = pworkloads.ReadHashes()
    for bodies in ([], stream[:10], stream[:25], stream[:25], stream[:5], stream,
                   stream[:0], swapped, swapped[:31], stream[:33], stream):
        assert cache.of(bodies) == stream_hash_of_bodies(bodies)
    assert cache.bodies == stream and len(cache.prefix) == len(stream) + 1


def _collect_cli(tmp_path, capsys, *extra) -> tuple[int, str]:
    rc = cli.main(["collect", "basin", "stream", "--out-dir", str(tmp_path), *extra])
    return rc, capsys.readouterr().out.strip()


def test_collect_cli_writes_and_prints_the_history(tmp_path, capsys):
    rc, out = _collect_cli(
        tmp_path, capsys, "--num-concurrent-clients", "3", "--num-ops-per-client", "20",
        "--workflow", "match-seq-num", "--seed", "3",
    )
    assert rc == 0
    assert os.path.dirname(out) == str(tmp_path) and os.path.exists(out)
    jcfg = jcollect.CollectConfig(3, 20, "match-seq-num", seed=3,
                                  faults=jfake.FaultPlan.chaos(0.2))
    with open(out, encoding="utf-8") as f:
        assert f.read() == jsonl(jcollect.collect_history(jcfg), jev)
    rc, out = _collect_cli(tmp_path, capsys, "--num-ops-per-client", "5", "--chaos", "0")
    with open(out, encoding="utf-8") as f:
        text = f.read()
    assert rc == 0 and "Failure" not in text  # --chaos 0: no faults
    rc, out = _collect_cli(tmp_path, capsys, "--list-campaigns")
    assert rc == 0 and len(out.splitlines()) == 9


def test_collect_cli_usage_errors_exit_64(tmp_path, capsys):
    assert _collect_cli(tmp_path, capsys, "--campaign", "no-such")[0] == 64
    assert _collect_cli(tmp_path, capsys, "--campaign", "steady", "--socket", "x")[0] == 64
    with pytest.raises(SystemExit) as e:
        cli.main(["collect", "--workflow", "nope"])
    assert e.value.code == 64
    assert not list(tmp_path.iterdir())


def test_collect_then_check_on_cpu_matches_jax_engine(tmp_path, capsys):
    rc, path = _collect_cli(
        tmp_path, capsys, "--num-concurrent-clients", "4", "--num-ops-per-client", "30",
        "--workflow", "match-seq-num", "--seed", "11",
    )
    assert rc == 0
    rc = cli.main(["check", f"-file={path}", "-backend=device", "-no-viz", "-device", "cpu", "-stats"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rj = jdev.check_device_auto(jax_prepare(jev.read_history(path)), collect_stats=True)
    assert rc == 0 and line["outcome"] == rj.outcome.value == "ok"
    assert line["witness"]
    for key, field in (("layers", "layers"), ("max_frontier", "max_frontier"),
                       ("expanded", "expanded"), ("auto_closed", "auto_closed")):
        assert line[key] == getattr(rj.stats, field), key
