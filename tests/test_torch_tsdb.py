"""The durable telemetry store (obs/tsdb.py) beside the JAX package's.

- Every case of ``tests/test_tsdb.py``, run over both packages: the series
  key codec, keyframe + delta encoding, last-sample-per-bucket
  downsampling, byte-bounded retention, torn-tail and mid-file recovery
  with cold-read agreement, range queries and the ``tsq`` op's checks,
  and the sampler thread.
- Side by side, exact: the same registry samples under one injected clock
  give the same segment bytes in each package's rings, and each package's
  cold readers (``query``, ``last_values``, ``telemetry_info``,
  ``tsq_request``) answer the same on the rings of either.
- Through the daemons: a port daemon's telemetry answers the ``tsq`` op
  live and the same query cold, and a JAX daemon's rings answer the
  port's ``tsq`` CLI cold, and the other way round.
"""

import importlib
import io
import json
import os
import struct
import threading
import time
import zlib
from types import SimpleNamespace

import pytest

PACKAGES = ("s2_verification_tpu", "s2_verification_tpu_torch")

#: the names the cases use, from the package under test (filled per case)
P = SimpleNamespace()
_NAMES = {
    'MetricsRegistry': ('obs.metrics', 'MetricsRegistry'),
    'TelemetryStore': ('obs.tsdb', 'TelemetryStore'),
    'default_dir': ('obs.tsdb', 'default_dir'),
    'flatten_snapshot': ('obs.tsdb', 'flatten_snapshot'),
    'last_values': ('obs.tsdb', 'last_values'),
    'parse_series_key': ('obs.tsdb', 'parse_series_key'),
    'query': ('obs.tsdb', 'query'),
    'telemetry_info': ('obs.tsdb', 'telemetry_info'),
    'tsq_request': ('obs.tsdb', 'tsq_request'),
    'SegmentLog': ('utils.seglog', 'SegmentLog'),
}


@pytest.fixture(autouse=True, params=PACKAGES)
def package(request):
    """The package under test's name; fills :data:`P` with its names."""
    for name, (mod, attr) in _NAMES.items():
        m = importlib.import_module(f"{request.param}.{mod}" if mod else request.param)
        setattr(P, name, getattr(m, attr) if attr else m)
    yield request.param


@pytest.fixture(autouse=True)
def _time_limit():
    """Each case fails after 60 s instead of hanging the run."""
    from test_torch_service import time_limit

    with time_limit(60):
        yield


def _registry():
    reg = P.MetricsRegistry()
    jobs = reg.counter("t_jobs_total", "jobs", labelnames=("kind",))
    depth = reg.gauge("t_queue_depth", "depth")
    return reg, jobs, depth


def _raw_records(telemetry_dir, res="raw"):
    """Decode the ring's on-disk records verbatim (kind + body)."""
    log = P.SegmentLog(os.path.join(telemetry_dir, res))
    try:
        return [json.loads(p.decode("utf-8")) for p in log.replay()]
    finally:
        log.close()


# -- key codec ---------------------------------------------------------------


def test_flatten_and_parse_round_trip():
    reg, jobs, depth = _registry()
    jobs.inc(3, kind="ok")
    jobs.inc(1, kind='we"ird')
    depth.set(7.5)
    h = reg.histogram("t_wall_seconds", "wall", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    flat = P.flatten_snapshot(reg.snapshot())
    assert flat['t_jobs_total{kind="ok"}'] == 3.0
    assert flat["t_queue_depth"] == 7.5
    # histograms flatten to the two scrape-visible scalars
    assert flat["t_wall_seconds_count"] == 2.0
    assert flat["t_wall_seconds_sum"] == pytest.approx(0.55)
    for key in flat:
        name, labels = P.parse_series_key(key)
        assert name and "{" not in name
        assert all('"' not in v or v == 'we"ird' for v in labels.values())
    # escaped label values survive the round trip
    weird = [k for k in flat if "ird" in k]
    assert weird and P.parse_series_key(weird[0])[1]["kind"] == 'we"ird'


def test_default_dir_convention(tmp_path):
    assert P.default_dir(str(tmp_path)) == str(tmp_path / "telemetry")


# -- encoding ----------------------------------------------------------------


def test_keyframe_then_deltas_with_absolute_values(tmp_path):
    reg, jobs, depth = _registry()
    clock = [1000.0]
    store = P.TelemetryStore(
        str(tmp_path / "tel"),
        reg,
        keyframe_every=64,
        time_fn=lambda: clock[0],
    )
    depth.set(5.0)  # constant after the first sample
    for _ in range(6):
        jobs.inc(kind="ok")
        store.sample_once()
        clock[0] += 10.0
    store.close()  # adds one final sample

    recs = _raw_records(str(tmp_path / "tel"))
    assert recs[0]["k"] == "b"  # boot keyframe carries every series
    assert recs[0]["v"]["t_queue_depth"] == 5.0
    deltas = [r for r in recs[1:] if r["k"] == "d"]
    assert deltas
    for r in deltas:
        # deltas carry only changed keys — the constant gauge is absent,
        # the moving counter is present with its ABSOLUTE value
        assert "t_queue_depth" not in r["v"]
    counters = [
        r["v"]['t_jobs_total{kind="ok"}']
        for r in recs
        if 't_jobs_total{kind="ok"}' in r["v"]
    ]
    assert counters == sorted(counters)  # absolute, monotone — not deltas
    assert counters[0] == 1.0 and counters[-1] == 6.0

    # the cold reader folds deltas back into dense per-sample series
    out = P.query(str(tmp_path / "tel"), metric="t_jobs_total")
    (key,) = out["series"]
    vals = [v for _t, v in out["series"][key]]
    assert vals == [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 6.0]  # close() resamples


def test_periodic_keyframes_recur(tmp_path):
    reg, jobs, _depth = _registry()
    clock = [0.0]
    store = P.TelemetryStore(
        str(tmp_path / "tel"),
        reg,
        keyframe_every=4,
        time_fn=lambda: clock[0],
    )
    for _ in range(10):
        jobs.inc(kind="ok")
        store.sample_once()
        clock[0] += 1.0
    store.close()
    kinds = [r["k"] for r in _raw_records(str(tmp_path / "tel"))]
    assert kinds[0] == "b"
    assert kinds.count("b") >= 2  # keyframes recur every keyframe_every


# -- downsampling ------------------------------------------------------------


def test_coarse_ring_keeps_last_sample_per_bucket(tmp_path):
    reg, _jobs, depth = _registry()
    clock = [0.0]
    store = P.TelemetryStore(
        str(tmp_path / "tel"), reg, time_fn=lambda: clock[0]
    )
    # sample every 10s for 300s: gauge value i at t = 10*i
    for i in range(30):
        clock[0] = 10.0 * i
        depth.set(float(i))
        store.sample_once()
    store.close()

    out = P.query(str(tmp_path / "tel"), res="1m", metric="t_queue_depth")
    (key,) = out["series"]
    points = out["series"][key]
    # 60s buckets over t=0..290: bucket k's last sample is i = 6k+5
    # (value 6k+5 at t = (6k+5)*10); the final bucket flushes at close.
    assert [v for _t, v in points[:4]] == [5.0, 11.0, 17.0, 23.0]
    assert points[0][0] == 50.0
    assert points[-1][1] == 29.0  # held bucket flushed by close()
    # the 15m ring is coarser still: one bucket transition + close flush
    info = P.telemetry_info(str(tmp_path / "tel"))
    assert info["resolutions"]["raw"]["records"] == 31  # 30 + close sample
    assert info["resolutions"]["1m"]["records"] == 5
    assert 1 <= info["resolutions"]["15m"]["records"] <= 2


# -- retention ---------------------------------------------------------------


def test_retention_evicts_head_but_tail_stays_readable(tmp_path):
    reg, jobs, _depth = _registry()
    clock = [0.0]
    store = P.TelemetryStore(
        str(tmp_path / "tel"),
        reg,
        keyframe_every=8,
        max_segment_bytes=2048,
        max_segments=2,
        time_fn=lambda: clock[0],
    )
    for _ in range(300):
        jobs.inc(kind="ok")
        store.sample_once()
        clock[0] += 1.0
    store.close()

    raw_dir = tmp_path / "tel" / "raw"
    # byte-bounded: at most max_segments files survive rotation
    assert len(os.listdir(raw_dir)) <= 2
    out = P.query(str(tmp_path / "tel"), metric="t_jobs_total")
    assert out["recovery"]["records"] < 301  # the head really was evicted
    (key,) = out["series"]
    # recurring keyframes mean the surviving tail still reads correctly:
    # the last point is the true final counter value
    assert out["series"][key][-1][1] == 300.0  # all 300 incs survive
    assert out["series"][key][-1][1] == P.last_values(str(tmp_path / "tel"))[1][key]


# -- crash recovery ----------------------------------------------------------


def test_torn_tail_recovery_and_cold_agreement(tmp_path):
    reg, jobs, depth = _registry()
    clock = [500.0]
    store = P.TelemetryStore(
        str(tmp_path / "tel"), reg, time_fn=lambda: clock[0]
    )
    for i in range(8):
        jobs.inc(kind="ok")
        depth.set(float(i))
        store.sample_once()
        clock[0] += 2.0
    store.close()
    _t, finals = P.last_values(str(tmp_path / "tel"))

    # simulate a crash mid-append: a record header that claims more
    # bytes than exist (the classic torn tail)
    raw_dir = tmp_path / "tel" / "raw"
    tail = sorted(raw_dir.iterdir())[-1]
    with open(tail, "ab") as f:
        f.write(struct.pack("<II", 1000, zlib.crc32(b"")) + b"xx")

    # cold read: the torn bytes are dropped, everything before survives
    out = P.query(str(tmp_path / "tel"), metric="t_jobs_total")
    assert out["recovery"]["torn_tail_bytes"] == 10
    assert out["recovery"]["bad_segments"] == 0
    _t2, after = P.last_values(str(tmp_path / "tel"))
    assert after == finals

    # a new store over the same dir reports the tear and seeds the same
    # boot values — this is what the telemetry_loaded event surfaces
    reg2 = P.MetricsRegistry()
    store2 = P.TelemetryStore(str(tmp_path / "tel"), reg2)
    assert store2.recovery_summary()["raw"]["torn_tail_bytes"] == 10
    boot_t, boot_vals = store2.boot_values()
    assert boot_t == _t and boot_vals == finals
    store2.close()


def test_mid_file_corruption_is_a_bad_segment(tmp_path):
    reg, jobs, _depth = _registry()
    clock = [0.0]
    store = P.TelemetryStore(
        str(tmp_path / "tel"),
        reg,
        max_segment_bytes=512,
        time_fn=lambda: clock[0],
    )
    for _ in range(40):
        jobs.inc(kind="ok")
        store.sample_once()
        clock[0] += 1.0
    store.close()
    segs = sorted((tmp_path / "tel" / "raw").iterdir())
    assert len(segs) >= 2
    # flip bytes in the MIDDLE segment: CRC fails, segment marked bad,
    # but the reader keeps going and the P.query still answers
    middle = segs[len(segs) // 2 - 1] if len(segs) > 2 else segs[0]
    blob = bytearray(middle.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    middle.write_bytes(bytes(blob))
    out = P.query(str(tmp_path / "tel"), metric="t_jobs_total")
    assert out["recovery"]["bad_segments"] >= 1
    assert out["points"] > 0


# -- range queries and the shared op ----------------------------------------


def test_query_filters_and_limits(tmp_path):
    reg, jobs, depth = _registry()
    clock = [100.0]
    store = P.TelemetryStore(
        str(tmp_path / "tel"), reg, time_fn=lambda: clock[0]
    )
    for i in range(20):
        jobs.inc(kind="ok")
        jobs.inc(kind="bad")
        depth.set(float(i))
        store.sample_once()
        clock[0] += 1.0
    store.close()

    # label filter narrows to one series of the family
    out = P.query(
        str(tmp_path / "tel"), metric="t_jobs_total", labels={"kind": "bad"}
    )
    assert list(out["series"]) == ['t_jobs_total{kind="bad"}']
    # a range that starts mid-log still enters with correct cumulative
    # values even when the window opens on a delta record
    out = P.query(
        str(tmp_path / "tel"),
        metric="t_jobs_total",
        labels={"kind": "ok"},
        since=110.0,
        until=114.0,
    )
    (key,) = out["series"]
    assert [v for _t, v in out["series"][key]] == [11.0, 12.0, 13.0, 14.0, 15.0]
    # limit keeps the LAST n points
    out = P.query(str(tmp_path / "tel"), metric="t_queue_depth", limit=3)
    (key,) = out["series"]
    assert [v for _t, v in out["series"][key]] == [18.0, 19.0, 19.0]

    # P.tsq_request: the validated op facade over the same reader
    payload, err = P.tsq_request(str(tmp_path / "tel"), {"info": True})
    assert err is None and payload["resolutions"]["raw"]["records"] == 21
    payload, err = P.tsq_request(
        str(tmp_path / "tel"),
        {"metric": "t_queue_depth", "since": "110", "limit": "2"},
    )
    assert err is None and payload["points"] == 2
    for bad in (
        {"res": "2h"},
        {"labels": ["kind"]},
        {"since": "yesterday"},
        {"limit": "many"},
    ):
        payload, err = P.tsq_request(str(tmp_path / "tel"), bad)
        assert payload is None and err


def test_query_empty_dir_is_a_clean_zero(tmp_path):
    out = P.query(str(tmp_path / "nope"))
    assert out["series"] == {} and out["points"] == 0
    assert P.last_values(str(tmp_path / "nope")) == (None, {})
    info = P.telemetry_info(str(tmp_path / "nope"))
    assert info["resolutions"]["raw"]["records"] == 0


# -- sampler thread ----------------------------------------------------------


def test_background_sampler_appends_records(tmp_path):
    reg, jobs, _depth = _registry()
    store = P.TelemetryStore(str(tmp_path / "tel"), reg, sample_s=0.05)
    store.start()
    deadline = time.time() + 5.0
    try:
        while time.time() < deadline:
            jobs.inc(kind="ok")
            if store.registry.get("verifyd_telemetry_points_total").value(
                res="raw"
            ) >= 3:
                break
            time.sleep(0.02)
    finally:
        store.close()
    info = P.telemetry_info(str(tmp_path / "tel"))
    assert info["resolutions"]["raw"]["records"] >= 3
    # the store's own meter agrees with what landed on disk
    assert reg.get("verifyd_telemetry_bytes_total").value() > 0


def test_sample_once_is_thread_safe(tmp_path):
    reg, jobs, _depth = _registry()
    store = P.TelemetryStore(str(tmp_path / "tel"), reg)
    def spin():
        for _ in range(50):
            jobs.inc(kind="ok")
            store.sample_once()
    threads = [threading.Thread(target=spin) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    store.close()
    out = P.query(str(tmp_path / "tel"), metric="t_jobs_total", limit=100000)
    (key,) = out["series"]
    vals = [v for _t, v in out["series"][key]]
    assert vals == sorted(vals)  # interleaved samples never regress
    assert vals[-1] == 200.0


# -- side by side and across packages -----------------------------------------


def other(package: str) -> str:
    return PACKAGES[1 - PACKAGES.index(package)]


def _mod(package: str, path: str):
    return importlib.import_module(f"{package}.{path}")


def _record(package: str, directory, *, steps: int = 40) -> None:
    """One seeded sampling run of ``package``'s store on an injected clock:
    two counters and a gauge moving at different rates, 1m buckets
    crossed, a periodic keyframe, a close."""
    metrics, tsdb = _mod(package, "obs.metrics"), _mod(package, "obs.tsdb")
    reg = metrics.MetricsRegistry()
    jobs = reg.counter("t_jobs_total", "jobs", labelnames=("kind",))
    depth = reg.gauge("t_queue_depth", "depth")
    clock = [1000.0]
    store = tsdb.TelemetryStore(str(directory), reg, keyframe_every=16, time_fn=lambda: clock[0])
    for i in range(steps):
        jobs.inc(kind="ok")
        if i % 3 == 0:
            jobs.inc(kind="bad")
        depth.set(float((i * 7) % 11))
        store.sample_once()
        clock[0] += 7.0
    store.close()


def _ring_bytes(directory) -> dict:
    return {
        f"{res}/{name}": (directory / res / name).read_bytes()
        for res in ("raw", "1m", "15m")
        for name in sorted(os.listdir(directory / res))
    }


def test_the_same_samples_give_the_same_segment_bytes(tmp_path, package):
    _record(package, tmp_path / "a")
    _record(other(package), tmp_path / "b")
    mine, theirs = _ring_bytes(tmp_path / "a"), _ring_bytes(tmp_path / "b")
    assert mine and mine == theirs


def test_cold_readers_answer_the_same_on_either_packages_rings(tmp_path, package):
    _record(package, tmp_path / "tel")
    d = str(tmp_path / "tel")
    a, b = _mod(package, "obs.tsdb"), _mod(other(package), "obs.tsdb")
    for kw in ({}, {"res": "1m"}, {"metric": "t_jobs_total", "labels": {"kind": "bad"}},
               {"since": 1070.0, "until": 1140.0}, {"limit": 3}):
        assert a.query(d, **kw) == b.query(d, **kw), kw
    assert a.last_values(d) == b.last_values(d)
    assert a.telemetry_info(d) == b.telemetry_info(d)
    for req in ({"info": True}, {"metric": "t_queue_depth", "since": "1100", "limit": "2"}, {"res": "2h"}):
        assert a.tsq_request(d, req) == b.tsq_request(d, req), req


def test_a_daemons_tsq_answers_live_and_the_other_packages_cli_reads_it_cold(tmp_path, package, capsys):
    """The ``tsq`` op of ``package``'s daemon returns the jobs series; after
    it stops, the other package's ``tsq --telemetry-dir --json`` and this
    package's cold ``query`` give one answer."""
    from helpers import H, fold

    h = H()
    h.append_ok(1, [111], tail=1)
    h.read_ok(2, tail=1, stream_hash=fold([111]))
    buf = io.StringIO()
    _mod("s2_verification_tpu", "utils.events").write_history(h.events, buf)
    daemon, client = _mod(package, "service.daemon"), _mod(package, "service.client")
    tel = tmp_path / "tel"
    cfg = daemon.VerifydConfig(
        socket_path=str(tmp_path / "v.sock"), device="off", no_viz=True, stats_log=None,
        telemetry_dir=str(tel), telemetry_sample_s=0.05,
    )
    with daemon.Verifyd(cfg) as d:
        c = client.VerifydClient(cfg.socket_path, timeout=30)
        assert c.submit(buf.getvalue())["verdict"] == 0
        deadline = time.monotonic() + 20
        while True:
            live = c.tsq(metric="verifyd_jobs_completed_total")
            if live["points"] >= 2:
                break
            assert time.monotonic() < deadline, live
            time.sleep(0.05)
        assert list(live["series"]) == ['verifyd_jobs_completed_total{verdict="ok"}']
        assert c.stats()["telemetry"]["dir"] == str(tel)
    capsys.readouterr()
    cold_cli = _mod(other(package), "cli").main(
        ["tsq", "--telemetry-dir", str(tel), "--metric", "verifyd_jobs_completed_total", "--json"]
    )
    assert cold_cli == 0
    said = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert said == _mod(package, "obs.tsdb").query(str(tel), metric="verifyd_jobs_completed_total")
    assert said["series"]['verifyd_jobs_completed_total{verdict="ok"}'][-1][1] == 1.0
