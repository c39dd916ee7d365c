"""Fencing histories, the token half of the stream model, on the CPU.

The benchmark's fencing cell (``fencing.8x500``: upstream's ``fencing``
workflow, 8 clients) is cut to 120 ops a client, so that each client fences
at its ops 0 and 100.  Its histories come from the benchmark's own
generator, and the port's verdicts are held to the benchmark's plain
reference (``gpubench/reference/``) and to the port's host oracle.  Beside
them: a witness whose token-guarded append lands after another client's
fence is refused, a fenced-out writer's accepted append is ILLEGAL, and the
auto-close's two counters (``CLOSE_SWEEPS``, ``TOKEN_CLOSES``) move on a
fencing history and keep tokenless histories' layer loop as it was.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

from gpubench.harness.spec import load_cell
from gpubench.reference import history as ref_history
from gpubench.reference import model, search, witness
from s2_verification_tpu_torch.checker import device as dev_mod
from s2_verification_tpu_torch.checker.entries import prepare
from s2_verification_tpu_torch.checker.oracle import check
from s2_verification_tpu_torch.collector.adversarial import adversarial_events
from s2_verification_tpu_torch.collector.campaign import collect_labeled, get_campaign
from s2_verification_tpu_torch.models.encode import encode_history
from s2_verification_tpu_torch.obs.trace import Tracer
from s2_verification_tpu_torch.utils import events as ev

CELL = load_cell("fencing.8x500")
PARAMS = CELL.params(num_ops_per_client=120)
#: pool indices whose histories reach the device search; 0 also has an
#: indefinite append whose token no op sets, which the token arm passes
STRUCTURES = (0, 7, 9)
SEEDS = (11, 2**31 + 5)

#: arguments of the layer head's fetch in ``run_search`` without the token
#: arm's count
HEAD_ARGS = 10


@functools.lru_cache(maxsize=None)
def _text(structure: int, seed: int) -> str:
    return CELL.make(PARAMS, seed, structure)


def _decide(text: str):
    hist = prepare(list(ev.iter_history(text)), elide_trivial=True)
    res = dev_mod.check_device_auto(hist, device="cpu", collect_stats=True)
    order = None if res.linearization is None else [hist.ops[i].op_id for i in res.linearization]
    return hist, res, order


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("structure", STRUCTURES)
def test_the_port_decides_ok_and_the_reference_replays_the_witness(structure, seed):
    text = _text(structure, seed)
    hist, res, order = _decide(text)
    assert res.ok and res.stats.layers > 0
    ops = ref_history.parse(text)
    assert any(op.set_token for op in ops) and any(op.batch_token for op in ops)
    assert witness.replay(ops, order) == (True, "")
    assert check(prepare(list(ev.iter_history(text)))).ok


def test_a_token_guarded_append_after_another_clients_fence_is_refused():
    text = _text(0, SEEDS[0])
    _, _, order = _decide(text)
    ops = ref_history.parse(text)
    by_id = {op.op_id: op for op in ops}
    fence_at = [i for i, oid in enumerate(order) if by_id[oid].set_token and not by_id[oid].failure]
    # The last successful append guarded by the first fence's token, and the
    # next fence of another client.
    first = by_id[order[fence_at[0]]]
    nxt = next(i for i in fence_at if by_id[order[i]].set_token != first.set_token)
    i = max(k for k in range(nxt) if by_id[order[k]].batch_token == first.set_token and not by_id[order[k]].failure)
    a, fence = by_id[order[i]], by_id[order[nxt]]
    moved = order[:i] + order[i + 1:nxt + 1] + [a.op_id] + order[nxt + 1:]
    assert witness.replay(ops, moved)[0] is False
    # The token guard refuses it by itself: at the tail it reported, the
    # append steps from a state carrying its own token, and from none
    # carrying the fence's.
    ids = model.token_ids(ops)
    before = np.array([(a.tail - a.num_records) & model.M32], np.int64)
    for tok, want in ((a.batch_token, 1), (fence.set_token, 0)):
        src, *_ = model.step(a, before, np.zeros(1, np.uint64), np.array([ids[tok]], np.int64), ids)
        assert len(src) == want, tok


def test_a_fenced_out_writers_accepted_append_is_illegal():
    events, label = collect_labeled(get_campaign("fence-resurrect"), seed=11)
    assert label["fired"] and label["expect"] == "illegal"
    text = "".join(ev.encode_event(le) + "\n" for le in events)
    hist = prepare(list(ev.iter_history(text)), elide_trivial=True)
    assert dev_mod.check_device_auto(hist, device="cpu").outcome.value == "illegal"
    assert search.decide(ref_history.parse(text)) is None


def _counted(monkeypatch, text: str):
    """Decide ``text`` with spans on; the counters' deltas, the spans, and
    the most arguments any ``_fetch`` took."""
    ring = Tracer(4096)
    monkeypatch.setattr(dev_mod, "SEARCH_TRACER", ring)
    widest = [0]
    fetch = dev_mod._fetch

    def counting(*xs):
        widest[0] = max(widest[0], len(xs))
        return fetch(*xs)

    monkeypatch.setattr(dev_mod, "_fetch", counting)
    sweeps0, tok0 = dev_mod.CLOSE_SWEEPS[0], dev_mod.TOKEN_CLOSES[0]
    hist = prepare(list(ev.iter_history(text)), elide_trivial=True)
    res = dev_mod.check_device_auto(hist, device="cpu", collect_stats=True)
    spans = [e for e in ring.export()["traceEvents"] if e["ph"] == "X"]
    return res, dev_mod.CLOSE_SWEEPS[0] - sweeps0, dev_mod.TOKEN_CLOSES[0] - tok0, spans, widest[0]


def test_the_counters_move_on_a_fencing_history(monkeypatch):
    res, sweeps, token_closes, spans, widest = _counted(monkeypatch, _text(0, SEEDS[0]))
    assert res.ok
    segments = [e["args"] for e in spans if e["name"] == "check.segment"]
    assert segments and sum(s["sweeps"] for s in segments) == sweeps >= res.stats.layers
    assert sum(s["token_closes"] for s in segments) == token_closes > 0
    # Each sweep is one counted synchronisation.
    assert sweeps <= res.stats.host_syncs
    # The tokens interned by the encoding, which leaves the forced prefix out.
    (encode,) = [e["args"] for e in spans if e["name"] == "check.encode"]
    hist = prepare(list(ev.iter_history(_text(0, SEEDS[0]))), elide_trivial=True)
    assert encode["tokens"] == len(encode_history(hist).token_of_id) - 1 > 0
    assert widest == HEAD_ARGS + 1


def _msn_text() -> str:
    """A history of the match-seq-num cell at its warm-up's size."""
    msn = load_cell("msn.5x200")
    return msn.make(msn.params(**msn.traffic["warmup"]), 3, 0)


@pytest.mark.parametrize("case", ["match-seq-num", "adversarial-k5"])
def test_tokenless_histories_count_no_token_closes_and_fetch_no_more(monkeypatch, case):
    if case == "match-seq-num":
        text = _msn_text()
    else:
        text = "".join(ev.encode_event(le) + "\n" for le in adversarial_events(5, batch=10, seed=3))
    res, sweeps, token_closes, spans, widest = _counted(monkeypatch, text)
    assert res.ok and res.stats.layers > 0
    assert token_closes == 0 and widest == HEAD_ARGS
    segments = [e["args"] for e in spans if e["name"] == "check.segment"]
    assert sum(s["sweeps"] for s in segments) == sweeps
    assert all(s["token_closes"] == 0 for s in segments)
    (encode,) = [e["args"] for e in spans if e["name"] == "check.encode"]
    assert encode["tokens"] == 0
