"""The benchmark's frozen generators give the port's histories, byte for
byte, at small sizes, for each generator a cell uses."""

from __future__ import annotations

import json

import pytest

from gpubench.gen import adversarial, collect
from gpubench.gen import events as frozen_ev
from gpubench.reference import history, search, witness
from s2_verification_tpu_torch.collector.adversarial import adversarial_events
from s2_verification_tpu_torch.collector.collect import CollectConfig, collect_history
from s2_verification_tpu_torch.collector.fake_s2 import FaultPlan
from s2_verification_tpu_torch.utils import events as ev


def _jsonl(events) -> str:
    return "".join(ev.encode_event(le) + "\n" for le in events)


@pytest.mark.parametrize("k,applied,unsat,seed", [(4, None, True, 0), (5, 2, False, 2**40 + 3), (9, None, True, 7), (10, 5, False, 2**33)])
def test_adversarial_is_the_ports(k, applied, unsat, seed):
    params = {"k": k, "batch": 100, "applied": applied, "unsatisfiable": unsat, "max_client_ids": 20}
    want = _jsonl(adversarial_events(k, batch=100, applied=applied, seed=seed, unsatisfiable=unsat))
    assert adversarial.make(params, seed) == want


@pytest.mark.parametrize("seed,ops", [(1, 20), (2**34 + 5, 30), (4242, 60)])
def test_collect_is_the_ports(seed, ops):
    faults = {"p_append_definite": 0.05, "p_append_indefinite": 0.012, "p_read_fail": 0.02, "p_check_tail_fail": 0.02}
    cfg = CollectConfig(num_concurrent_clients=5, num_ops_per_client=ops, workflow="match-seq-num", seed=seed,
                        faults=FaultPlan(**faults), max_client_ids=20)
    mine = collect.CollectConfig(num_concurrent_clients=5, num_ops_per_client=ops, workflow="match-seq-num",
                                 seed=seed, faults=collect.FaultPlan(**faults), max_client_ids=20)
    frozen = "".join(frozen_ev.encode_event(le) + "\n" for le in collect.collect_history(mine))
    assert frozen == _jsonl(collect_history(cfg))


def _shape(text: str) -> list:
    """A history with its hashes left out."""
    out = []
    for line in text.splitlines():
        rec = json.loads(line)
        body = rec["event"].get("Start") or rec["event"].get("Finish")
        if isinstance(body, dict):
            (name, fields), = body.items()
            body = {name: {k: v for k, v in fields.items() if k not in ("record_hashes", "stream_hash")}}
        out.append((body, rec["client_id"], rec["op_id"]))
    return out


def test_structured_collection_keeps_the_work_and_draws_new_hashes():
    params = {"workflow": "match-seq-num", "num_concurrent_clients": 5, "num_ops_per_client": 30, "max_client_ids": 20,
              "faults": {"p_append_definite": 0.05, "p_append_indefinite": 0.05, "p_read_fail": 0.02,
                         "p_check_tail_fail": 0.02}, "structure_seed": 7}
    a, b, other = collect.make(params, 1, 3), collect.make(params, 2, 3), collect.make(params, 1, 4)
    assert a != b and _shape(a) == _shape(b) and _shape(a) != _shape(other)
    assert collect.make(params, 1, 3) == a
    for text in (a, b):
        ops = history.parse(text)
        order = search.decide(ops)
        assert order is not None and witness.replay(ops, order) == (True, "")
