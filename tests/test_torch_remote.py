"""The authenticated TCP transport, frame bounds and the client's retry
policy in the port: the 17 cases of ``tests/test_remote.py``, each run
over both packages (HMAC frame auth rejected before admission, the
per-frame size bound, and the client's split of exit 69 "nothing answered"
from 76 "reached but refused").
"""

import random
import socket as _socket

import pytest

from helpers import H, fold

from test_torch_service import _h_text as _text
from test_torch_service import pkg, time_limit  # noqa: F401  (fixture)


@pytest.fixture(autouse=True)
def _time_limit():
    with time_limit(60):
        yield


SECRET = b"test-shared-secret"


def good_history() -> str:
    h = H()
    h.append_ok(1, [111], tail=1)
    h.read_ok(2, tail=1, stream_hash=fold([111]))
    return _text(h)


def bad_history() -> str:
    h = H()
    h.append_ok(1, [111], tail=1)
    h.read_ok(2, tail=1, stream_hash=12345)
    return _text(h)


def _tcp_cfg(pkg, tmp_path, **overrides):
    kw = dict(
        socket_path=str(tmp_path / "verifyd.sock"),
        workers=1,
        device="off",
        no_viz=True,
        out_dir=str(tmp_path / "viz"),
        tcp="127.0.0.1:0",
        secret=SECRET,
    )
    kw.update(overrides)
    return pkg.daemon.VerifydConfig(**kw)


# -- protocol units -----------------------------------------------------------


def test_sign_verify_round_trip_and_tamper(pkg):
    frame = {"op": "submit", "history": "x", "client": "c"}
    signed = pkg.protocol.sign_frame(frame, SECRET)
    assert pkg.protocol.verify_frame(signed, SECRET)
    assert not pkg.protocol.verify_frame(signed, b"other-secret")
    tampered = dict(signed, history="y")
    assert not pkg.protocol.verify_frame(tampered, SECRET)
    assert not pkg.protocol.verify_frame(frame, SECRET)  # unsigned


def test_sign_is_order_independent(pkg):
    a = pkg.protocol.sign_frame({"op": "ping", "z": 1, "a": 2}, SECRET)
    b = pkg.protocol.sign_frame({"a": 2, "z": 1, "op": "ping"}, SECRET)
    assert a["auth"] == b["auth"]


def test_parse_hostport(pkg):
    assert pkg.protocol.parse_hostport("127.0.0.1:7070") == ("127.0.0.1", 7070)
    assert pkg.protocol.parse_hostport(":7070") == ("0.0.0.0", 7070)
    with pytest.raises(ValueError):
        pkg.protocol.parse_hostport("no-port")
    with pytest.raises(ValueError):
        pkg.protocol.parse_hostport("host:notanumber")


def test_tcp_listener_requires_secret(tmp_path, pkg):
    with pytest.raises(ValueError, match="secret"):
        pkg.daemon.Verifyd(_tcp_cfg(pkg, tmp_path, secret=None))


def test_client_tcp_address_requires_secret(pkg):
    with pytest.raises(ValueError, match="secret"):
        pkg.client.VerifydClient("127.0.0.1:7070")


# -- TCP round trip -----------------------------------------------------------


def test_tcp_round_trip_parity_with_unix(tmp_path, pkg):
    cfg = _tcp_cfg(pkg, tmp_path)
    with pkg.daemon.Verifyd(cfg) as daemon:
        assert daemon.tcp_port  # ephemeral port was bound and published
        tcp = pkg.client.VerifydClient(
            f"127.0.0.1:{daemon.tcp_port}", timeout=120, secret=SECRET
        )
        unix = pkg.client.VerifydClient(cfg.socket_path, timeout=120)

        assert tcp.ping()["server"] == "verifyd"
        # same verdicts through both transports; the unix path is
        # untouched by the TCP feature (no auth field needed)
        assert tcp.submit(good_history(), client="t")["verdict"] == 0
        assert tcp.submit(bad_history(), client="t")["verdict"] == 1
        reply = unix.submit(good_history(), client="u")
        assert reply["verdict"] == 0 and reply["cached"] is True


def test_wrong_secret_rejected_before_admission(tmp_path, pkg):
    cfg = _tcp_cfg(pkg, tmp_path)
    with pkg.daemon.Verifyd(cfg) as daemon:
        before = daemon.stats.snapshot()["submitted"]
        bad = pkg.client.VerifydClient(
            f"127.0.0.1:{daemon.tcp_port}", timeout=10, secret=b"wrong"
        )
        with pytest.raises(pkg.client.VerifydRefused) as ei:
            bad.submit(good_history(), client="intruder")
        assert ei.value.cls == "AuthError"
        assert ei.value.transient is False  # retrying cannot fix a bad secret
        snap = daemon.stats.snapshot()
        assert snap["submitted"] == before  # nothing reached admission
        assert snap["auth_rejects"] >= 1


def test_unsigned_frame_rejected(tmp_path, pkg):
    cfg = _tcp_cfg(pkg, tmp_path)
    with pkg.daemon.Verifyd(cfg) as daemon:
        with _socket.create_connection(
            ("127.0.0.1", daemon.tcp_port), timeout=10
        ) as s:
            s.sendall(pkg.protocol.encode_frame({"op": "ping"}))
            resp = pkg.protocol.decode_frame(s.makefile("rb").readline())
        assert resp["err"]["class"] == "AuthError"


def test_tcp_replies_are_signed(tmp_path, pkg):
    cfg = _tcp_cfg(pkg, tmp_path)
    with pkg.daemon.Verifyd(cfg) as daemon:
        with _socket.create_connection(
            ("127.0.0.1", daemon.tcp_port), timeout=10
        ) as s:
            s.sendall(pkg.protocol.encode_frame(pkg.protocol.sign_frame({"op": "ping"}, SECRET)))
            resp = pkg.protocol.decode_frame(s.makefile("rb").readline())
        assert pkg.protocol.verify_frame(resp, SECRET)


# -- frame bounds (satellite: protocol.py size bound on read) -----------------


def test_oversized_frame_gets_definite_protocol_error(tmp_path, pkg):
    cfg = _tcp_cfg(pkg, tmp_path, tcp=None, secret=None, frame_max_bytes=4096)
    with pkg.daemon.Verifyd(cfg):
        client = pkg.client.VerifydClient(cfg.socket_path, timeout=10)
        with pytest.raises(pkg.client.VerifydRefused) as ei:
            client.submit("x" * 8192, client="big")
        assert ei.value.cls == "FrameTooLarge"


def test_large_history_within_bound_is_accepted(tmp_path, pkg):
    # Regression: the old implicit bound was asyncio's 64 KiB stream
    # default, which rejected legal large histories outright.
    h = H()
    hashes = [10**15 + i for i in range(5000)]  # one fat append line
    h.append_ok(1, hashes, tail=5000)
    h.read_ok(2, tail=5000, stream_hash=fold(hashes))
    text = _text(h)
    assert len(text.encode()) > 64 << 10
    cfg = _tcp_cfg(pkg, tmp_path, tcp=None, secret=None)
    with pkg.daemon.Verifyd(cfg):
        client = pkg.client.VerifydClient(cfg.socket_path, timeout=120)
        assert client.submit(text, client="fat")["verdict"] == 0


def test_malformed_frame_is_frame_error_not_decode_error(tmp_path, pkg):
    # FrameError (transport noise, retryable) vs DecodeError (bad
    # history, the client's bug): distinct classes, distinct handling.
    cfg = _tcp_cfg(pkg, tmp_path, tcp=None, secret=None)
    with pkg.daemon.Verifyd(cfg):
        with _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM) as s:
            s.connect(cfg.socket_path)
            s.sendall(b"\xff not json\n")
            resp = pkg.protocol.decode_frame(s.makefile("rb").readline())
        assert resp["err"]["class"] == "FrameError"


# -- client retry policy ------------------------------------------------------


def test_unavailable_after_retries(tmp_path, monkeypatch, pkg):
    sleeps: list[float] = []
    monkeypatch.setattr("time.sleep", sleeps.append)
    client = pkg.client.VerifydClient(str(tmp_path / "nothing.sock"), timeout=1)
    with pytest.raises(pkg.client.VerifydUnavailable):
        client.submit_with_retry(
            "x", retries=3, backoff_s=0.5, rng=random.Random(0)
        )
    # exponential envelope with jitter: attempt n sleeps in [0, 0.5 * 2^n]
    assert len(sleeps) == 3
    for n, s in enumerate(sleeps):
        assert 0 <= s <= 0.5 * (2**n)


def test_auth_refusal_is_not_retried(tmp_path, monkeypatch, pkg):
    cfg = _tcp_cfg(pkg, tmp_path)
    sleeps: list[float] = []
    monkeypatch.setattr("time.sleep", sleeps.append)
    with pkg.daemon.Verifyd(cfg) as daemon:
        bad = pkg.client.VerifydClient(
            f"127.0.0.1:{daemon.tcp_port}", timeout=10, secret=b"wrong"
        )
        with pytest.raises(pkg.client.VerifydRefused):
            bad.submit_with_retry(good_history(), retries=5, backoff_s=0.01)
        assert sleeps == []  # definite refusal: zero retry sleeps
        assert daemon.stats.snapshot()["auth_rejects"] == 1


def test_busy_retry_honors_daemon_hint(tmp_path, monkeypatch, pkg):
    # workers=0 + depth=1: the first job parks, the second is rejected
    # with the daemon's retry-after hint, which the client must sleep.
    cfg = _tcp_cfg(pkg, tmp_path, tcp=None, secret=None, workers=0, queue_depth=1
    )
    sleeps: list[float] = []
    monkeypatch.setattr("time.sleep", sleeps.append)
    with pkg.daemon.Verifyd(cfg) as daemon:
        with _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM) as parked:
            parked.connect(cfg.socket_path)
            parked.sendall(
                pkg.protocol.encode_frame(
                    {"op": "submit", "history": good_history(), "client": "hog"}
                )
            )
            import time as _time

            deadline = _time.monotonic() + 10
            while len(daemon.queue) < 1:  # busy-wait: sleep is patched
                assert _time.monotonic() < deadline, "first job never admitted"
            client = pkg.client.VerifydClient(cfg.socket_path, timeout=10)
            with pytest.raises(pkg.client.VerifydBusy):
                client.submit_with_retry(bad_history(), retries=2)
        hint = daemon.stats.retry_after_hint(1)
        assert sleeps and all(s == hint for s in sleeps)
        daemon.scheduler.start(1)  # drain the parked job: its handler ends


# -- CLI exit codes -----------------------------------------------------------


def test_cli_submit_tcp_round_trip_and_exit_76(tmp_path, pkg):
    cfg = _tcp_cfg(pkg, tmp_path)
    good = tmp_path / "good.jsonl"
    good.write_text(good_history(), encoding="utf-8")
    right = tmp_path / "secret.txt"
    right.write_text(SECRET.decode() + "\n", encoding="utf-8")
    wrong = tmp_path / "wrong.txt"
    wrong.write_text("not-the-secret\n", encoding="utf-8")
    with pkg.daemon.Verifyd(cfg) as daemon:
        addr = f"127.0.0.1:{daemon.tcp_port}"
        assert (
            pkg.cli.main(
                ["submit", "-file", str(good), "-socket", addr,
                 "--secret-file", str(right)]
            )
            == 0
        )
        # reached the daemon, refused: 76 (EX_PROTOCOL), not 69
        assert (
            pkg.cli.main(
                ["submit", "-file", str(good), "-socket", addr,
                 "--secret-file", str(wrong)]
            )
            == 76
        )


def test_cli_submit_tcp_without_secret_is_usage_error(tmp_path, pkg):
    good = tmp_path / "good.jsonl"
    good.write_text(good_history(), encoding="utf-8")
    assert (
        pkg.cli.main(["submit", "-file", str(good), "-socket", "127.0.0.1:1"]) == 64
    )
