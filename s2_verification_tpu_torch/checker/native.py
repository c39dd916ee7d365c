"""ctypes bridge to the native C++ Wing–Gong checker (``csrc/s2check.cpp``).

The port's copy of the JAX package's ``checker/native.py``: the same
engine, the same verdicts as :func:`.oracle.check`, the same
``EncodedHistory`` arrays in, and a linearization mapped back to
``History.ops`` indices behind the forced prefix.

The library is built at first use, with the flags of the JAX package's
``native/Makefile`` (``g++ -O2 -std=c++17 -fPIC -shared``), from the port's
own copy of the source, ``csrc/s2check.cpp`` (byte for byte the JAX
package's ``native/s2check.cpp``), into
``_build/libs2check-<sha1 of the source>.so``.  The compiler writes a
temporary file that is renamed into place, so processes that build at
the same time each finish with a whole library.  Without a compiler, or
when the build fails, :class:`NativeUnavailable` is raised (the CLI's
``auto`` ladder then runs the Python oracle, as the JAX package does).
"""

from __future__ import annotations

import ctypes as ct
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time as _time
from pathlib import Path

import numpy as np

from ..models.encode import EncodedHistory, encode_history, intern_state
from ..models.stream import StreamState
from ..obs.introspect import record_build
from .entries import History
from .oracle import CheckOutcome, CheckResult

__all__ = ["native_available", "check_native", "NativeUnavailable", "SOURCE", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent.parent
#: the engine's source, the port's own copy
SOURCE = _PKG / "csrc" / "s2check.cpp"
#: where the library is built (gitignored)
BUILD_DIR = _PKG / "_build"
#: the JAX package's native/Makefile flags
CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]
#: rows of the final-state buffer handed to C (re-run with the exact size
#: on overflow)
_STATES_CAP = 4096

_lock = threading.Lock()
_lib: ct.CDLL | None = None
_build_error: str | None = None
#: the library's path and build seconds once loaded (0.0 when it was
#: already built)
BUILD: dict = {}


class NativeUnavailable(RuntimeError):
    pass


def _u8(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.uint8)


def _compile() -> tuple[Path, float]:
    """Build the library from :data:`SOURCE` unless one built from the same
    bytes exists; returns ``(path, seconds compiling)``.  A build that ran
    the compiler is recorded in ``obs.introspect.INTROSPECTOR``."""
    tag = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    so = BUILD_DIR / f"libs2check-{tag}.so"
    if so.exists():
        return so, 0.0
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise NativeUnavailable("no C++ compiler (g++) to build csrc/s2check.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = _time.monotonic()
    proc = subprocess.run([cxx, *CXXFLAGS, "-o", tmp, str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise NativeUnavailable(f"native build failed:\n{proc.stderr[-2000:]}")
    os.replace(tmp, so)
    seconds = _time.monotonic() - t0
    record_build(f"g++:{SOURCE.name}", tag, seconds)
    return so, seconds


def _load() -> ct.CDLL:
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise NativeUnavailable(_build_error)
        try:
            so, seconds = _compile()
            lib = ct.CDLL(str(so))
        except NativeUnavailable as e:
            _build_error = str(e)
            raise
        except OSError as e:
            _build_error = f"cannot build or load the native engine: {e}"
            raise NativeUnavailable(_build_error) from e
        i32p, u32p, u64p, u8p = (ct.POINTER(t) for t in (ct.c_int32, ct.c_uint32, ct.c_uint64, ct.c_uint8))
        i64p = ct.POINTER(ct.c_int64)
        lib.s2_check.argtypes = [
            ct.c_int32, i32p, u8p, i32p, u8p, i32p, u8p, u32p, u32p, i32p, i32p, ct.c_int32,
            u32p, u32p, u8p, u8p, u32p, u8p, u64p, i32p, i32p, i32p, u8p, ct.c_int32,
            u32p, u64p, i32p, ct.c_double, i32p, i32p, u32p, u64p, i32p, ct.c_int32, i32p,
            i64p, i64p,
        ]
        lib.s2_check.restype = ct.c_int32
        BUILD.update(path=str(so), seconds=seconds)
        _lib = lib
        return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(ct.POINTER(typ))


def check_native(
    history: History,
    time_budget_s: float | None = None,
    profile: bool = False,
    prune: bool = False,
    enc: EncodedHistory | None = None,
    progress=None,
) -> CheckResult:
    """Decide linearizability with the native engine (the JAX package's
    ``check_native``; its ``_states_cap`` test hook is not ported).

    Verdict semantics match :func:`.oracle.check`, including the
    ``deepest`` linearized set on ILLEGAL/UNKNOWN; ``time_budget_s``
    expiry is UNKNOWN.  ``profile=True`` attaches ``res.profile =
    {"encode_s", "search_s", "steps", "cache_hits"}``.  ``prune=True`` hands the DFS the verdict-exact precedence tables of
    :mod:`.prune` (the append rank order and the inert mask); verdicts are
    unchanged.

    ``enc`` lets a caller that already encoded ``history`` (the batched
    lane runner encodes a whole launch group up front, padded by
    :func:`..models.encode.encode_batch`) skip the second encode; it must
    be ``encode_history(history)``, padded or not.  ``encode_s`` is then 0.

    ``progress`` is an optional :class:`.progress.ProgressSink`.  The C
    search blocks, so it hears of the run only at its start and end (the
    daemon's ``watch`` rows for a native job show it).
    """
    lib = _load()
    t_enc0 = _time.monotonic() if profile else 0.0
    if enc is None:
        enc = encode_history(history)
        encode_s = (_time.monotonic() - t_enc0) if profile else 0.0
    else:
        encode_s = 0.0

    def _attach(res: CheckResult, search_s: float) -> CheckResult:
        if profile:
            res.profile = {  # type: ignore[attr-defined]
                "encode_s": round(encode_s, 6),
                "search_s": round(search_s, 6),
                "steps": res.steps,
                "cache_hits": res.cache_hits,
            }
        return res

    if enc.total_remaining == 0 and enc.num_ops == 0:
        return _attach(
            CheckResult(
                CheckOutcome.OK,
                linearization=list(enc.forced_prefix),
                final_states=sorted(enc.init_states),
            ),
            0.0,
        )
    n = enc.num_ops

    init = sorted(intern_state(enc, s) for s in enc.init_states)
    init_tail = np.asarray([t for t, _, _, _ in init], np.uint32)
    init_hash = np.asarray([(hi << 32) | lo for _, hi, lo, _ in init], np.uint64)
    init_tok = np.asarray([k for _, _, _, k in init], np.int32)

    out_hash = (enc.out_hash_hi.astype(np.uint64) << np.uint64(32)) | enc.out_hash_lo.astype(np.uint64)
    if prune:
        from .prune import RANK_INF, analyze_encoded

        pt = analyze_encoded(enc)
        app_rank = np.ascontiguousarray(np.where(pt.app_rank == RANK_INF, np.int32(-1), pt.app_rank), np.int32)
        inert = _u8(pt.inert)
    else:
        app_rank = np.full(max(1, n), -1, np.int32)
        inert = np.zeros(max(1, n), np.uint8)
    order = np.zeros(max(1, n), np.int32)
    order_len = ct.c_int32(0)
    states_cap = _STATES_CAP
    st_tail = np.zeros(states_cap, np.uint32)
    st_hash = np.zeros(states_cap, np.uint64)
    st_tok = np.zeros(states_cap, np.int32)
    states_len = ct.c_int32(0)
    steps = ct.c_int64(0)
    hits = ct.c_int64(0)

    i32, u32, u64, u8 = ct.c_int32, ct.c_uint32, ct.c_uint64, ct.c_uint8
    # Every array handed to C stays referenced here for the call.
    cols = dict(
        op_type=np.ascontiguousarray(enc.op_type, np.int32),
        has_set_token=_u8(enc.has_set_token),
        set_token=np.ascontiguousarray(enc.set_token, np.int32),
        has_batch_token=_u8(enc.has_batch_token),
        batch_token=np.ascontiguousarray(enc.batch_token, np.int32),
        has_match=_u8(enc.has_match),
        match_seq=np.ascontiguousarray(enc.match_seq, np.uint32),
        num_records=np.ascontiguousarray(enc.num_records, np.uint32),
        rh_row=np.ascontiguousarray(enc.rh_row, np.int32),
        rh_len=np.ascontiguousarray(enc.rh_len, np.int32),
        rh_hi=np.ascontiguousarray(enc.rh_hi, np.uint32),
        rh_lo=np.ascontiguousarray(enc.rh_lo, np.uint32),
        out_failure=_u8(enc.out_failure),
        out_definite=_u8(enc.out_definite),
        out_tail=np.ascontiguousarray(enc.out_tail, np.uint32),
        out_has_hash=_u8(enc.out_has_hash),
        out_hash=np.ascontiguousarray(out_hash, np.uint64),
        call=np.ascontiguousarray(enc.call, np.int32),
        ret=np.ascontiguousarray(enc.ret, np.int32),
    )

    def invoke(budget_s):
        return lib.s2_check(
            ct.c_int32(n),
            _ptr(cols["op_type"], i32),
            _ptr(cols["has_set_token"], u8),
            _ptr(cols["set_token"], i32),
            _ptr(cols["has_batch_token"], u8),
            _ptr(cols["batch_token"], i32),
            _ptr(cols["has_match"], u8),
            _ptr(cols["match_seq"], u32),
            _ptr(cols["num_records"], u32),
            _ptr(cols["rh_row"], i32),
            _ptr(cols["rh_len"], i32),
            ct.c_int32(enc.rh_hi.shape[1]),
            _ptr(cols["rh_hi"], u32),
            _ptr(cols["rh_lo"], u32),
            _ptr(cols["out_failure"], u8),
            _ptr(cols["out_definite"], u8),
            _ptr(cols["out_tail"], u32),
            _ptr(cols["out_has_hash"], u8),
            _ptr(cols["out_hash"], u64),
            _ptr(cols["call"], i32),
            _ptr(cols["ret"], i32),
            _ptr(app_rank, i32),
            _ptr(inert, u8),
            ct.c_int32(len(init)),
            _ptr(init_tail, u32),
            _ptr(init_hash, u64),
            _ptr(init_tok, i32),
            ct.c_double(budget_s),
            _ptr(order, i32),
            ct.byref(order_len),
            _ptr(st_tail, u32),
            _ptr(st_hash, u64),
            _ptr(st_tok, i32),
            ct.c_int32(states_cap),
            ct.byref(states_len),
            ct.byref(steps),
            ct.byref(hits),
        )

    if progress is not None:
        # Rate baseline only (the sink never emits on first offer).
        progress.update(ops_committed=0, total_ops=n, engine="native")
    t_search0 = _time.monotonic() if profile else 0.0
    rc = invoke(-1.0 if time_budget_s is None else time_budget_s)
    if rc == 0 and states_len.value > states_cap:
        # The final state set overflowed the buffer: re-run, unbudgeted (OK
        # is proven and the re-derivation is deterministic), with room for
        # all of it.
        states_cap = int(states_len.value)
        st_tail = np.zeros(states_cap, np.uint32)
        st_hash = np.zeros(states_cap, np.uint64)
        st_tok = np.zeros(states_cap, np.int32)
        rc = invoke(-1.0)
        if rc != 0 or states_len.value > states_cap:
            raise RuntimeError(f"native engine re-run returned {rc} with {states_len.value} states")
    search_s = (_time.monotonic() - t_search0) if profile else 0.0
    if progress is not None:
        progress.update(
            ops_committed=n if rc == 0 else int(order_len.value),
            total_ops=n,
            states_expanded=int(steps.value),
            engine="native",
            final=True,
        )

    # Encoded op index → History.ops index (forced-prefix ops were peeled
    # off before encoding).
    keep_index = enc.keep_index()

    if rc != 0:
        outcome = CheckOutcome.UNKNOWN if rc == 2 else CheckOutcome.ILLEGAL
        deepest = list(enc.forced_prefix) + [keep_index[j] for j in order[: order_len.value]]
        return _attach(
            CheckResult(outcome, deepest=deepest, steps=int(steps.value), cache_hits=int(hits.value)),
            search_s,
        )

    lin = list(enc.forced_prefix) + [keep_index[j] for j in order[: order_len.value]]
    final = [
        StreamState(
            tail=int(st_tail[i]),
            stream_hash=int(st_hash[i]),
            fencing_token=enc.token_of_id[int(st_tok[i])],
        )
        for i in range(states_len.value)
    ]
    return _attach(
        CheckResult(
            CheckOutcome.OK,
            linearization=lin,
            deepest=lin,
            final_states=final,
            steps=int(steps.value),
            cache_hits=int(hits.value),
        ),
        search_s,
    )
