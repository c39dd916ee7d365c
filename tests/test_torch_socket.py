"""Port parity: the loopback-socket transport.

The port's ``S2SocketServer`` / ``S2SocketTransport`` speak the JAX
package's wire format; the reader hashes the bodies it received.  Held
against the JAX package:

- one client over the socket writes the same bytes as the JAX collector
  over its socket and in process (with one client the interleaving is the
  op order, whatever the socket's timing);
- several clients with faults on give a history the port's oracle and the
  JAX oracle both find linearizable;
- every read's stream hash, in a run of several clients, equals the fold
  of the bodies the server held up to its tail;
- the rectifying append goes through the blocking snapshot path.
"""

from __future__ import annotations

import asyncio
import io
import random

from s2_verification_tpu.checker.oracle import check_events as jax_check_events
from s2_verification_tpu.collector import collect as jcollect
from s2_verification_tpu.collector import socket_s2 as jsocket
from s2_verification_tpu.utils import events as jev
from s2_verification_tpu_torch.checker.oracle import CheckOutcome, check_events
from s2_verification_tpu_torch.collector import collect as pcollect
from s2_verification_tpu_torch.collector import socket_s2 as psocket
from s2_verification_tpu_torch.collector.fake_s2 import FakeS2Stream, FaultPlan
from s2_verification_tpu_torch.collector.transport import S2StreamTransport
from s2_verification_tpu_torch.utils import events as pev
from s2_verification_tpu_torch.utils.hashing import stream_hash_of_bodies


def _jsonl(events, codec) -> str:
    buf = io.StringIO()
    codec.write_history(events, buf)
    return buf.getvalue()


def _over_socket(collect, socket_mod, cfg, path):
    with socket_mod.S2SocketServer(collect.default_stream(cfg), path):
        return collect.collect_history(cfg, socket_mod.S2SocketTransport(path))


def test_one_client_over_socket_equals_jax(tmp_path):
    kw = dict(num_concurrent_clients=1, num_ops_per_client=40, workflow="match-seq-num", seed=6)
    jcfg, pcfg = jcollect.CollectConfig(**kw), pcollect.CollectConfig(**kw)
    events = _over_socket(pcollect, psocket, pcfg, str(tmp_path / "p.sock"))
    got = _jsonl(events, pev)
    assert got == _jsonl(_over_socket(jcollect, jsocket, jcfg, str(tmp_path / "j.sock")), jev)
    assert got == _jsonl(jcollect.collect_history(jcfg), jev)
    assert any(isinstance(e.event, pev.ReadSuccess) and e.event.tail > 0 for e in events)


def test_collect_over_socket_is_linearizable(tmp_path):
    cfg = pcollect.CollectConfig(
        num_concurrent_clients=3,
        num_ops_per_client=15,
        workflow="match-seq-num",
        seed=5,
        indefinite_failure_backoff_s=0.0,
        faults=FaultPlan(
            p_append_definite=0.05, p_append_indefinite=0.05,
            p_read_fail=0.05, p_check_tail_fail=0.05,
        ),
    )
    events = _over_socket(pcollect, psocket, cfg, str(tmp_path / "s2.sock"))
    assert check_events(events).outcome == CheckOutcome.OK
    text = _jsonl(events, pev)
    assert jax_check_events(list(jev.iter_history(io.StringIO(text)))).ok


def test_read_hashes_over_socket_fold_the_delivered_bodies(tmp_path):
    path = str(tmp_path / "s2.sock")
    # Small enough that a read stays inside the wire's 64 KiB line limit.
    cfg = pcollect.CollectConfig(3, 20, "regular", seed=8, indefinite_failure_backoff_s=0.0)
    fake = pcollect.default_stream(cfg)
    with psocket.S2SocketServer(fake, path):
        client = psocket.S2SocketTransport(path)
        assert isinstance(client, S2StreamTransport)
        assert asyncio.run(client.read_all()) == []
        events = pcollect.collect_history(cfg, client)
    reads = [e.event for e in events if isinstance(e.event, pev.ReadSuccess)]
    assert len({r.tail for r in reads}) > 5
    bodies = fake.snapshot_bodies()
    assert all(r.stream_hash == stream_hash_of_bodies(bodies[: r.tail]) for r in reads)
    assert stream_hash_of_bodies([b"foo", b"bar", b"baz"]) == 0x732EE99ABC5002FF


def test_rectifying_append_over_socket(tmp_path):
    path = str(tmp_path / "s2.sock")
    fake = FakeS2Stream(rng=random.Random(2))
    with psocket.S2SocketServer(fake, path):
        client = psocket.S2SocketTransport(path)
        asyncio.run(client.append([b"seed-record"]))
        events = pcollect.collect_history(
            pcollect.CollectConfig(2, 5, "regular", seed=9, indefinite_failure_backoff_s=0.0),
            stream=client,
        )
    first = events[0]
    assert isinstance(first.event, pev.AppendStart) and first.client_id == 0
    assert first.event.num_records == 1
    assert check_events(events).outcome == CheckOutcome.OK
