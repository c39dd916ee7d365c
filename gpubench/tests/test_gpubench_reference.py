"""The plain reference: its hash is XXH3-64's chain, its search agrees with
the port's host oracle, and its replay accepts the port's witnesses and
refuses altered ones."""

from __future__ import annotations

import random

import numpy as np
import pytest

from gpubench.gen import adversarial, collect
from gpubench.reference import history, search, witness, xxh3
from s2_verification_tpu_torch.checker.device import check_device_auto
from s2_verification_tpu_torch.checker.entries import prepare
from s2_verification_tpu_torch.checker.oracle import check
from s2_verification_tpu_torch.utils import events as ev
from s2_verification_tpu_torch.utils.hashing import chain_hash

FAULTS = {"p_append_definite": 0.05, "p_append_indefinite": 0.12, "p_read_fail": 0.02, "p_check_tail_fail": 0.02}


def _adv(k, seed, unsat=False, applied=None):
    return adversarial.make({"k": k, "batch": 20, "applied": applied, "unsatisfiable": unsat}, seed)


def _msn(seed, ops=12, clients=3):
    return collect.make({"workflow": "match-seq-num", "num_concurrent_clients": clients, "num_ops_per_client": ops,
                         "max_client_ids": 20, "faults": FAULTS, "structure_seed": seed}, seed, 0)


def _port(text):
    hist = prepare(list(ev.iter_history(text)), elide_trivial=True)
    res = check_device_auto(hist, device="cpu")
    order = None if res.linearization is None else [hist.ops[i].op_id for i in res.linearization]
    return hist, res, order


def test_chain_is_xxh3():
    rng = random.Random(5)
    pairs = [(rng.getrandbits(64), rng.getrandbits(64)) for _ in range(500)] + [(0, 0), (2**64 - 1, 2**64 - 1)]
    assert [xxh3.chain(a, b) for a, b in pairs] == [chain_hash(a, b) for a, b in pairs]
    seeds = np.array([a for a, _ in pairs], dtype=np.uint64)
    assert [int(x) for x in xxh3.chain_np(seeds, 77)] == [chain_hash(a, 77) for a, _ in pairs]


@pytest.mark.parametrize("text", [_adv(4, 1), _adv(4, 2, unsat=True), _adv(5, 3, applied=3), _msn(1), _msn(2), _msn(3, ops=20)],
                         ids=["adv4", "adv4-unsat", "adv5", "msn1", "msn2", "msn3"])
def test_search_agrees_with_the_oracle(text):
    ops = history.parse(text)
    order = search.decide(ops)
    truth = check(prepare(list(ev.iter_history(text)))).ok
    assert (order is not None) == truth
    if order is not None:
        assert witness.replay(ops, order) == (True, "")


@pytest.mark.parametrize("text", [_adv(5, 4), _msn(4), _msn(5, ops=20)], ids=["adv5", "msn4", "msn5"])
def test_replay_accepts_the_ports_witness(text):
    _, res, order = _port(text)
    assert res.ok
    assert witness.replay(history.parse(text), order) == (True, "")


def _rt_pair(ops, order):
    """Two neighbours of ``order`` whose swap breaks real time: the first
    returned before the second was called."""
    by_id = {op.op_id: op for op in ops}
    for i in range(len(order) - 1):
        if by_id[order[i]].ret < by_id[order[i + 1]].call:
            return i
    return None


@pytest.mark.parametrize("text", [_msn(6), _msn(7, ops=20)], ids=["msn6", "msn7"])
def test_replay_refuses_a_real_time_swap(text):
    _, _, order = _port(text)
    ops = history.parse(text)
    i = _rt_pair(ops, order)
    assert i is not None
    swapped = order[:i] + [order[i + 1], order[i]] + order[i + 2:]
    ok, why = witness.replay(ops, swapped)
    assert not ok and "returned before its call" in why


def test_replay_refuses_a_left_out_op_and_a_changed_hash():
    text = _adv(5, 8, applied=2)
    _, _, order = _port(text)
    ops = history.parse(text)
    assert not witness.replay(ops, order[:-1])[0]
    corrupt = text.replace('"stream_hash":', '"stream_hash":1', 1)
    assert not witness.replay(history.parse(corrupt), order)[0]


def test_parse_completes_pending_calls():
    text = _adv(3, 9)
    lines = [ln for ln in text.splitlines() if "AppendIndefiniteFailure" not in ln]
    ops = history.parse("\n".join(lines))
    appends = [op for op in ops if op.kind == history.APPEND]
    assert len(appends) == 3 and all(op.failure and not op.definite and op.ret >= len(lines) for op in appends)
