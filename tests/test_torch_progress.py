"""Port parity: search progress heartbeats (``checker/progress.py``).

The port's ``ProgressSink`` and the JAX package's are driven through the
same offers under the same injected clock (the sink cases of the JAX
package's ``tests/test_progress.py``), and must return the same answers
and emit the same records; each case also asserts the cadence contract
itself.  Then ``check_device`` offers one update per search segment: the
port's heartbeats on the CPU equal the JAX engine's on the same history.
"""

import importlib

import pytest

from s2_verification_tpu.checker.progress import ProgressSink as JaxSink
from s2_verification_tpu_torch.checker import device as pdev
from s2_verification_tpu_torch.checker.progress import ProgressSink as PortSink

from test_torch_device import TABLE_CASES, both

jdev = importlib.import_module("s2_verification_tpu.checker.device")


class Clock:
    """Injectable monotonic clock."""

    def __init__(self, t: float = 0.0, step: float = 0.0) -> None:
        self.t = t
        self.step = step

    def __call__(self) -> float:
        t = self.t
        self.t += self.step
        return t

    def tick(self, dt: float) -> None:
        self.t += dt


def _first_update_is_baseline_only(sink_cls):
    clock, out = Clock(), []
    sink = sink_cls(out.append, min_interval_s=0.5, time_fn=clock)
    got = [sink.update(ops_committed=0, total_ops=100)]
    assert got == [False] and out == [] and sink.emitted == 0
    return got, out


def _cadence_is_time_gated(sink_cls):
    clock, out = Clock(), []
    sink = sink_cls(out.append, min_interval_s=0.5, time_fn=clock)
    got = []
    for i in range(100):
        got.append(sink.update(ops_committed=i, total_ops=100, layer=i))
        clock.tick(0.01)
    assert 1 <= len(out) <= 2 and all(r["engine"] == "other" for r in out)
    return got, out


def _trivial_job_emits_nothing(sink_cls):
    clock, out = Clock(), []
    sink = sink_cls(out.append, min_interval_s=0.5, time_fn=clock)
    got = [sink.update(ops_committed=0, total_ops=4)]
    clock.tick(0.1)
    got.append(sink.update(ops_committed=2, total_ops=4))
    clock.tick(0.1)
    got.append(sink.update(ops_committed=4, total_ops=4, final=True))
    assert got == [False, False, False] and out == []
    return got, out


def _final_emits_once_past_one_interval(sink_cls):
    clock, out = Clock(), []
    sink = sink_cls(out.append, min_interval_s=0.5, time_fn=clock)
    got = [sink.update(ops_committed=0, total_ops=4)]
    clock.tick(0.6)
    got.append(sink.update(ops_committed=4, total_ops=4, final=True))
    assert got == [False, True] and len(out) == 1 and out[0]["final"] is True
    return got, out


def _layer_rate_and_lane(sink_cls):
    clock, out = Clock(), []
    sink = sink_cls(out.append, min_interval_s=0.5, time_fn=clock, engine="device", lane=3)
    got = [sink.update(ops_committed=0, total_ops=10, layer=0)]
    clock.tick(1.0)
    got.append(sink.update(ops_committed=5, total_ops=10, layer=5))
    assert len(out) == 1 and out[0]["layer_rate"] == pytest.approx(5.0)
    assert out[0]["engine"] == "device" and out[0]["lane"] == 3
    return got, out


def _multi_layer_launch_rate(sink_cls):
    """A K-layer dive advances ``layer`` by K in one update: the rate
    credits the whole delta, and a layer-less offer carries the layer
    baseline forward."""
    clock, out = Clock(), []
    sink = sink_cls(out.append, min_interval_s=0.5, time_fn=clock)
    got = [sink.update(ops_committed=0, total_ops=40, layer=0)]
    clock.tick(2.0)
    got.append(sink.update(ops_committed=4, total_ops=40, layer=4))
    assert out[-1]["layer_rate"] == pytest.approx(2.0)
    clock.tick(1.0)
    got.append(sink.update(ops_committed=6, total_ops=40))
    assert "layer" not in out[-1] and out[-1]["layer_rate"] == pytest.approx(2.0)
    clock.tick(1.0)
    got.append(sink.update(ops_committed=8, total_ops=40, layer=8))
    assert out[-1]["layer"] == 8 and out[-1]["layer_rate"] == pytest.approx(4.0)
    clock.tick(0.5)
    got.append(sink.update(ops_committed=20, total_ops=40, layer=20))
    assert out[-1]["layer_rate"] == pytest.approx((20 - 8) / 0.5)
    return got, out


SINK_CASES = [
    _first_update_is_baseline_only,
    _cadence_is_time_gated,
    _trivial_job_emits_nothing,
    _final_emits_once_past_one_interval,
    _layer_rate_and_lane,
    _multi_layer_launch_rate,
]


@pytest.mark.parametrize("case", SINK_CASES, ids=[c.__name__.strip("_") for c in SINK_CASES])
def test_sink_matches_jax(case):
    assert case(PortSink) == case(JaxSink)


# (history, speculate_depth, heartbeats: one per search segment after the first)
BEAT_CASES = [("adv-k6-unsat", 3, 3), ("collected-match-seq-num", 2, 1)]


@pytest.mark.parametrize("name,depth,n_beats", BEAT_CASES, ids=[c[0] for c in BEAT_CASES])
def test_check_device_heartbeats_match_jax(name, depth, n_beats):
    hj, hp = both(TABLE_CASES[name])
    kw = dict(max_frontier=4096, beam=False, prune=True, speculate_depth=depth)
    beats = {}
    for who, sink_cls, run in (
        ("jax", JaxSink, lambda sink: jdev.check_device(hj, progress=sink, **kw)),
        ("port", PortSink, lambda sink: pdev.check_device(hp, device="cpu", progress=sink, **kw)),
    ):
        out = []
        # A clock one interval apart at every read: each offer after the
        # baseline leaves a heartbeat.
        sink = sink_cls(out.append, min_interval_s=0.5, time_fn=Clock(step=1.0))
        beats[who] = (run(sink).outcome.value, out)
    assert beats["port"] == beats["jax"]
    assert len(beats["port"][1]) == n_beats
    assert all(r["engine"] == "device" and r["total_ops"] == len(hp.ops) for r in beats["port"][1])
