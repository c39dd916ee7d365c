"""Port parity: the host-RAM spill against the JAX device engine.

Held integer-exact (tolerance 0), the JAX side on the CPU with its default
scan fold, the port with ``device="cpu"`` (the plain PyTorch fold), on the
inputs of the JAX package's spill tests (``tests/test_device.py``):

- ``_dedup_rows``: identical arrays in identical order on random matrices,
  with collisions forced through ``_key_bits``;
- ``check_device(spill=True)``: verdict, search statistics, final states
  (the two-state accept set included, equal to the in-core run's), witness,
  deepest prefix and refusal reports; the host cap's UNKNOWN; random and
  collected histories against the oracle; the chunked tier's hand-off; sort
  dedup with the spill;
- the spill snapshot's host matrix, written by both engines under the same
  host cap: byte for byte one frontier, row for row;
- a slab that runs the device out of memory: the fill halves and the result
  is unchanged; at a fill of one row the error is re-raised.
"""

import random

import numpy as np
import pytest
import torch

from s2_verification_tpu.collector.collect import CollectConfig, collect_history
from s2_verification_tpu.collector.fake_s2 import FaultPlan
from s2_verification_tpu.utils import events as jax_ev
from s2_verification_tpu_torch.checker import device as pdev
from s2_verification_tpu_torch.checker.oracle import CheckOutcome, check

from test_oracle_bruteforce import random_history
from test_torch_chunked import STAT_FIELDS
from test_torch_device import assert_replays, assert_results_equal, both, jax_adversarial, jdev

SPILL = dict(beam=False, spill=True, collect_stats=True)


def assert_spill_equal(rj, rp, hp):
    assert_results_equal(rj, rp, hp)
    for f in STAT_FIELDS:
        assert getattr(rp.stats, f) == getattr(rj.stats, f), f


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("bits", [64, 8, 2, 1])
def test_dedup_rows_matches_jax_row_for_row(seed, bits):
    rng = np.random.default_rng(seed)
    for _ in range(10):
        n = int(rng.integers(1, 400))
        c = int(rng.integers(2, 8))
        # Low-cardinality values plant plenty of duplicate rows; the wide
        # column puts u32 words with the top bit set through the hashes.
        mat = rng.integers(-3, 3, (n, c)).astype(np.int32)
        mat[:, -1] = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32) * (mat[:, 0] > 0)
        want = jdev._dedup_rows(mat.copy(), _key_bits=bits)
        got = pdev._dedup_rows(mat.copy(), _key_bits=bits)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(np.unique(got, axis=0), np.unique(mat, axis=0))


def _two_state_accept_history():
    """The JAX package's test_spill_final_states_match_incore history: the
    adversarial k=6 with two returned ambiguous appends and a check-tail
    that pins only the tail, so that the accept set holds two states."""
    k, batch, applied = 6, 4, 3
    base = jax_adversarial(k, batch=batch, seed=1, applied=applied)
    deferred, events = base[-k:], base[:-k]
    for j, h in enumerate((0xDEADBEEF, 0xCAFEF00D)):
        events.append(jax_ev.LabeledEvent(jax_ev.AppendStart(num_records=1, record_hashes=(h,)), k + 2 + j, k + 1 + j))
        events.append(jax_ev.LabeledEvent(jax_ev.AppendIndefiniteFailure(), k + 2 + j, k + 1 + j))
    events.append(jax_ev.LabeledEvent(jax_ev.CheckTailStart(), k + 4, k + 3))
    events.append(jax_ev.LabeledEvent(jax_ev.CheckTailSuccess(tail=applied * batch + 1), k + 4, k + 3))
    return events + deferred


@pytest.mark.parametrize("name", ["adversarial-k6", "two-state-accept-set"])
def test_spill_ok_matches_jax_and_incore(name):
    events = jax_adversarial(6, batch=4, seed=1) if name == "adversarial-k6" else _two_state_accept_history()
    hj, hp = both(events)
    kw = dict(max_frontier=32, start_frontier=32, **SPILL)
    rj = jdev.check_device(hj, **kw)
    rp = pdev.check_device(hp, device="cpu", **kw)
    assert rp.outcome == CheckOutcome.OK and rp.stats.max_frontier > 32  # out of core
    assert_spill_equal(rj, rp, hp)
    assert_replays(hp, rp.linearization)
    incore = pdev.check_device(hp, max_frontier=1 << 13, start_frontier=1 << 13, beam=False, device="cpu")
    assert rp.final_states == incore.final_states
    if name != "adversarial-k6":
        assert len(rp.final_states) == 2


def test_spill_illegal_deepest_and_refusals_match_jax():
    hj, hp = both(jax_adversarial(5, batch=4, seed=2, unsatisfiable=True))
    kw = dict(max_frontier=32, start_frontier=32, **SPILL)
    rj = jdev.check_device(hj, **kw)
    rp = pdev.check_device(hp, device="cpu", **kw)
    assert rp.outcome == CheckOutcome.ILLEGAL and rp.deepest and rp.refusals
    assert_spill_equal(rj, rp, hp)
    read_idx = {i for i, o in enumerate(hp.ops) if o.inp.input_type == 1}
    assert any(read_idx & set(refused) for _, refused in rp.refusals)


def test_spill_host_cap_gives_unknown_like_jax():
    hj, hp = both(jax_adversarial(7, batch=4, seed=3))
    kw = dict(max_frontier=16, start_frontier=16, spill_host_cap=64, **SPILL)
    rj = jdev.check_device(hj, **kw)
    rp = pdev.check_device(hp, device="cpu", **kw)
    assert rp.outcome == CheckOutcome.UNKNOWN and rp.stats.pruned
    assert_spill_equal(rj, rp, hp)


def test_spill_random_and_collected_histories_match_oracle():
    rng = random.Random(0x5B1)
    for trial in range(30):
        _, hp = both(random_history(rng).events)
        got = pdev.check_device(hp, max_frontier=4, start_frontier=4, beam=False, spill=True, device="cpu")
        assert got.outcome == check(hp).outcome, trial
    events = collect_history(
        CollectConfig(
            num_concurrent_clients=4, num_ops_per_client=12, workflow="match-seq-num", seed=31,
            faults=FaultPlan.chaos(0.3),
        )
    )
    hj, hp = both(events)
    kw = dict(max_frontier=8, start_frontier=8, **SPILL)
    rj = jdev.check_device(hj, **kw)
    rp = pdev.check_device(hp, device="cpu", **kw)
    assert rp.outcome == check(hp).outcome
    assert_spill_equal(rj, rp, hp)


class _Spy:
    def __init__(self, monkeypatch, name):
        self.calls = 0
        real = getattr(pdev, name)

        def spy(*a, **kw):
            self.calls += 1
            return real(*a, **kw)

        monkeypatch.setattr(pdev, name, spy)


@pytest.mark.parametrize("sort_dedup", [False, True])
def test_tier_hands_off_to_the_spill_like_jax(monkeypatch, sort_dedup):
    chunked, spilled = _Spy(monkeypatch, "_expand_layer_chunked"), _Spy(monkeypatch, "_spill_search")
    hj, hp = both(jax_adversarial(5, batch=4, seed=1))
    kw = dict(max_frontier=16, start_frontier=16, device_rows_cap=64, sort_dedup=sort_dedup, **SPILL)
    rj = jdev.check_device(hj, **kw)
    rp = pdev.check_device(hp, device="cpu", **kw)
    assert rp.outcome == CheckOutcome.OK
    assert_spill_equal(rj, rp, hp)
    assert chunked.calls > 0 and spilled.calls == 1


def test_spill_snapshot_host_matrix_is_byte_equal(tmp_path):
    hj, hp = both(jax_adversarial(6, batch=4, seed=1))
    kw = dict(max_frontier=32, start_frontier=32, spill_host_cap=64, beam=False, spill=True)
    hosts = {}
    for who, run in (("jax", lambda ck: jdev.check_device(hj, checkpoint_path=ck, **kw)),
                     ("port", lambda ck: pdev.check_device(hp, checkpoint_path=ck, device="cpu", **kw))):
        ck = str(tmp_path / f"{who}.ck")
        assert run(ck).outcome.value == "unknown"
        with np.load(ck + ".spill.npz") as z:
            hosts[who] = {k: z[k] for k in ("fingerprint", "host", "layers", "deep")}
    j, p = hosts["jax"], hosts["port"]
    assert p["host"].dtype == j["host"].dtype == np.int32 and len(p["host"]) > 0
    assert p["host"].tobytes() == j["host"].tobytes()
    for k in ("fingerprint", "layers", "deep"):
        np.testing.assert_array_equal(p[k], j[k])
        assert p[k].dtype == j[k].dtype, k


def test_slab_out_of_memory_halves_the_fill(monkeypatch, caplog):
    hj, hp = both(jax_adversarial(5, batch=4, seed=2, unsatisfiable=True))
    kw = dict(max_frontier=32, start_frontier=32, **SPILL)
    want = pdev.check_device(hp, device="cpu", **kw)
    real = pdev.run_search
    state = {"ooms": 0, "slab_rows": []}

    def oom_once(tables, fr, max_layers, **k):
        if max_layers == 1:
            rows = int(fr.valid.sum())
            if state["ooms"] == 0 and rows > 1:
                state["ooms"] += 1
                raise torch.OutOfMemoryError("simulated")
            state["slab_rows"].append(rows)
        return real(tables, fr, max_layers, **k)

    monkeypatch.setattr(pdev, "run_search", oom_once)
    got = pdev.check_device(hp, device="cpu", **kw)
    # The fill of 8 rows halved for the rest of that layer (it resets each layer).
    assert state["ooms"] == 1 and state["slab_rows"][0] <= 4
    assert any("halving fill" in r.getMessage() for r in caplog.records)
    assert_results_equal(want, got, hp)
    assert_spill_equal(jdev.check_device(hj, **kw), got, hp)

    def always_oom(tables, fr, max_layers, **k):
        if max_layers == 1:
            state["slab_rows"].append(int(fr.valid.sum()))
            raise torch.OutOfMemoryError("simulated")
        return real(tables, fr, max_layers, **k)

    state["slab_rows"] = []
    monkeypatch.setattr(pdev, "run_search", always_oom)
    with pytest.raises(torch.OutOfMemoryError, match="one-row spill slab"):
        pdev.check_device(hp, device="cpu", **kw)
    assert state["slab_rows"][-1] == 1
