"""Chained xxh3 stream-hash protocol, host side, on Python ints.

The cumulative hash over a stream is the left fold of :func:`chain_hash` over
the xxh3-64 of every record body, in sequence order, starting from 0 for the
empty stream (reference: rust/s2-verification/src/history.rs:43-45,
golang/s2-porcupine/main.go:232-244).

This module carries its own XXH3-64 instead of depending on the ``xxhash``
package, in two parts:

- :func:`record_hash`, XXH3-64 with no seed over a body of any length (the
  collector hashes every record body it appends): each length class of the
  reference (0; 1–3, 4–8, 9–16; 17–128, 129–240; and over 240 bytes, the
  64-byte stripes accumulated in numpy, scrambled at every 1,024-byte block
  of the default secret, then the last stripe and the merge);
- :func:`xxh3_8byte_seeded`, the 8-byte seeded path that every chain step
  takes (the little-endian encoding of the previous record hash, seeded by
  the running stream hash):

      seed' = seed XOR (byteswap32(lo32(seed)) << 32)
      input64 = (lo32(data) << 32) | hi32(data)
      keyed = input64 XOR ((secret[8..16] ^ secret[16..24]) - seed')
      result = rrmxmx(keyed, len=8)

The device twin of the chain step (one int64 word per u64) is
:mod:`..ops.xxh3`; the CUDA kernel is ``csrc/fold_lanes.cu``.

:func:`fold_record_hashes`, the host's fold over a batch (every append the
model steps), runs in native code, ``csrc/chain_fold.cpp``, built with
``g++`` at first use (``checker/native.py::build_library``) into
``_build/libchain_fold-<sha1 of the source>.so``; where it cannot be built,
the Python loop below folds, with the same result.
"""

from __future__ import annotations

import ctypes as ct
import struct
import threading
from array import array
from collections.abc import Iterable
from pathlib import Path

import numpy as np

__all__ = [
    "record_hash",
    "xxh3_8byte_seeded",
    "chain_hash",
    "fold_record_hashes",
    "stream_hash_of_bodies",
    "NATIVE_FOLDS",
    "PYTHON_FOLDS",
]

_PKG = Path(__file__).resolve().parent.parent
#: the native fold's source and where it is built (gitignored)
FOLD_SOURCE = _PKG / "csrc" / "chain_fold.cpp"
FOLD_BUILD_DIR = _PKG / "_build"
#: batches folded by :func:`fold_record_hashes` in native code, and in Python
NATIVE_FOLDS = [0]
PYTHON_FOLDS = [0]

_fold_lock = threading.Lock()
#: the native fold once loaded; False once it could not be built or loaded
_native_fold = None

_M32 = (1 << 32) - 1
_M64 = (1 << 64) - 1
PRIME32_1 = 0x9E3779B1
PRIME32_2 = 0x85EBCA77
PRIME32_3 = 0xC2B2AE3D
PRIME64_1 = 0x9E3779B185EBCA87
PRIME64_2 = 0xC2B2AE3D27D4EB4F
PRIME64_3 = 0x165667B19E3779F9
PRIME64_4 = 0x85EBCA77C2B2AE63
PRIME64_5 = 0x27D4EB2F165667C5
PRIME_MX1 = 0x165667919E3779F9
PRIME_MX2 = 0x9FB21C651E98DF25

#: The default 192-byte XXH3 secret (kSecret of the reference xxhash.h).
SECRET = bytes.fromhex(
    "b8fe6c3923a44bbe7c01812cf721ad1cded46de9839097db7240a4a4b7b3671f"
    "cb79e64eccc0e578825ad07dccff7221b8084674f743248ee03590e6813a264c"
    "3c2852bb91c300cb88d0658b1b532ea371644897a20df94e3819ef46a9deacd8"
    "a8fa763fe39c343ff9dcbbc7c70b4f1d8a51e04bcdb45931c89f7ec9d9787364"
    "eac5ac8334d3ebc3c581a0fffa1363eb170ddd51b7f0da49d316552629d4689e"
    "2b16be587d47a1fc8ff8b8d17ad031ce45cb3a8f95160428afd7fbcabb4b407e"
)
_SW = struct.unpack_from("<24Q", SECRET)  # the secret as 8-byte-aligned words
#: le_u64(secret[8..16]) ^ le_u64(secret[16..24]): the 4–8 byte bitflip
BITFLIP_BASE = _SW[1] ^ _SW[2]

_STRIPE = 64
_STRIPES_PER_BLOCK = (len(SECRET) - _STRIPE) // 8  # 16
_BLOCK = _STRIPE * _STRIPES_PER_BLOCK  # 1,024 bytes
#: secret word n + i for stripe n, lane i of a block
_BLOCK_KEYS = np.array(
    [[_SW[n + i] for i in range(8)] for n in range(_STRIPES_PER_BLOCK)], np.uint64
)
_SCRAMBLE_KEYS = np.array(_SW[(len(SECRET) - _STRIPE) // 8 :], np.uint64)
_LAST_STRIPE_KEYS = struct.unpack_from("<8Q", SECRET, len(SECRET) - _STRIPE - 7)
_MERGE_KEYS = struct.unpack_from("<8Q", SECRET, 11)
_ACC_INIT = (PRIME32_3, PRIME64_1, PRIME64_2, PRIME64_3, PRIME64_4, PRIME32_2, PRIME64_5, PRIME32_1)
_U32_LO = np.uint64(_M32)
_SHIFT32 = np.uint64(32)
_SHIFT47 = np.uint64(47)
_P32_1 = np.uint64(PRIME32_1)


def _rotl(h: int, k: int) -> int:
    return ((h << k) | (h >> (64 - k))) & _M64


def _byteswap32(x: int) -> int:
    return int.from_bytes((x & _M32).to_bytes(4, "little"), "big")


def _mul128_fold64(a: int, b: int) -> int:
    p = a * b
    return (p & _M64) ^ (p >> 64)


def _xxh64_avalanche(h: int) -> int:
    h ^= h >> 33
    h = (h * PRIME64_2) & _M64
    h ^= h >> 29
    h = (h * PRIME64_3) & _M64
    return h ^ (h >> 32)


def _avalanche(h: int) -> int:
    h ^= h >> 37
    h = (h * PRIME_MX1) & _M64
    return h ^ (h >> 32)


def _rrmxmx(h: int, length: int = 8) -> int:
    h ^= _rotl(h, 49) ^ _rotl(h, 24)
    h = (h * PRIME_MX2) & _M64
    h ^= (h >> 35) + length
    h = (h * PRIME_MX2) & _M64
    return h ^ (h >> 28)


def _mix16(data: bytes, at: int, s: int) -> int:
    """mix16B with no seed: 16 input bytes at ``at`` against secret bytes
    at ``s``."""
    lo, hi = struct.unpack_from("<2Q", data, at)
    k0, k1 = struct.unpack_from("<2Q", SECRET, s)
    return _mul128_fold64(lo ^ k0, hi ^ k1)


def _hash_long(data: bytes) -> int:
    """Over 240 bytes: stripes of 64 bytes into eight accumulators, the
    scramble after every whole block, then the last stripe and the merge."""
    n = len(data)
    acc = np.array(_ACC_INIT, np.uint64)
    nb_blocks = (n - 1) // _BLOCK
    tail_stripes = ((n - 1) - _BLOCK * nb_blocks) // _STRIPE
    words = np.frombuffer(data, "<u8", count=(nb_blocks * _BLOCK + tail_stripes * _STRIPE) // 8)
    words = words.astype(np.uint64).reshape(-1, 8)
    for b in range(nb_blocks + 1):
        stripes = words[b * _STRIPES_PER_BLOCK : (b + 1) * _STRIPES_PER_BLOCK]
        if len(stripes):
            keyed = stripes ^ _BLOCK_KEYS[: len(stripes)]
            acc += ((keyed & _U32_LO) * (keyed >> _SHIFT32)).sum(axis=0, dtype=np.uint64)
            acc += stripes.sum(axis=0, dtype=np.uint64).reshape(4, 2)[:, ::-1].reshape(8)
        if b < nb_blocks:
            acc ^= acc >> _SHIFT47
            acc ^= _SCRAMBLE_KEYS
            acc *= _P32_1
    a = [int(x) for x in acc]
    last = struct.unpack_from("<8Q", data, n - _STRIPE)
    for i in range(8):
        dv = last[i]
        dk = dv ^ _LAST_STRIPE_KEYS[i]
        a[i ^ 1] += dv
        a[i] += (dk & _M32) * (dk >> 32)
    a = [x & _M64 for x in a]
    result = (n * PRIME64_1) & _M64
    for i in range(4):
        result += _mul128_fold64(a[2 * i] ^ _MERGE_KEYS[2 * i], a[2 * i + 1] ^ _MERGE_KEYS[2 * i + 1])
    return _avalanche(result & _M64)


def record_hash(body: bytes) -> int:
    """xxh3-64 (no seed) of one record body."""
    n = len(body)
    if n <= 16:
        if n > 8:
            lo = struct.unpack_from("<Q", body)[0] ^ (_SW[3] ^ _SW[4])
            hi = struct.unpack_from("<Q", body, n - 8)[0] ^ (_SW[5] ^ _SW[6])
            swapped = int.from_bytes(lo.to_bytes(8, "little"), "big")
            return _avalanche((n + swapped + hi + _mul128_fold64(lo, hi)) & _M64)
        if n >= 4:
            in1 = struct.unpack_from("<I", body)[0]
            in2 = struct.unpack_from("<I", body, n - 4)[0]
            return _rrmxmx((in2 + (in1 << 32)) ^ BITFLIP_BASE, n)
        if n:
            combined = (body[0] << 16) | (body[n >> 1] << 24) | body[n - 1] | (n << 8)
            bitflip = (struct.unpack_from("<I", SECRET)[0] ^ struct.unpack_from("<I", SECRET, 4)[0])
            return _xxh64_avalanche(combined ^ bitflip)
        return _xxh64_avalanche(_SW[7] ^ _SW[8])
    if n <= 128:
        acc = n * PRIME64_1
        if n > 32:
            if n > 64:
                if n > 96:
                    acc += _mix16(body, 48, 96) + _mix16(body, n - 64, 112)
                acc += _mix16(body, 32, 64) + _mix16(body, n - 48, 80)
            acc += _mix16(body, 16, 32) + _mix16(body, n - 32, 48)
        acc += _mix16(body, 0, 0) + _mix16(body, n - 16, 16)
        return _avalanche(acc & _M64)
    if n <= 240:
        acc = n * PRIME64_1
        for i in range(8):
            acc += _mix16(body, 16 * i, 16 * i)
        acc = _avalanche(acc & _M64)
        # the last 16 bytes against secret[136 - 17:], then rounds 8.. at
        # secret offset 3
        acc_end = _mix16(body, n - 16, 136 - 17)
        for i in range(8, n // 16):
            acc_end += _mix16(body, 16 * i, 16 * (i - 8) + 3)
        return _avalanche((acc + acc_end) & _M64)
    return _hash_long(body)


def xxh3_8byte_seeded(value: int, seed: int) -> int:
    """XXH3-64(le_bytes(value), seed) — the len == 8 specialization."""
    value &= _M64
    seed &= _M64
    seed ^= _byteswap32(seed) << 32
    input64 = _rotl(value, 32)
    keyed = input64 ^ ((BITFLIP_BASE - seed) & _M64)
    return _rrmxmx(keyed)


def chain_hash(stream_hash: int, rec_hash: int) -> int:
    """Fold one record-body hash into a cumulative stream hash:
    ``xxh3_64(le_bytes(rec_hash), seed=stream_hash)``."""
    return xxh3_8byte_seeded(rec_hash, stream_hash)


def _load_native_fold():
    """The native fold's ctypes function, built at first use, or None where
    no compiler builds it or the library does not load."""
    global _native_fold
    with _fold_lock:
        if _native_fold is None:
            # imported here: checker.native imports models, which import this module
            from ..checker.native import NativeUnavailable, build_library

            try:
                so, _ = build_library(FOLD_SOURCE, FOLD_BUILD_DIR)
                fold = ct.CDLL(str(so)).s2_chain_fold
            except (NativeUnavailable, OSError):
                _native_fold = False
            else:
                fold.argtypes = [ct.c_uint64, ct.c_void_p, ct.c_int64]
                fold.restype = ct.c_uint64
                _native_fold = fold
        return _native_fold or None


def fold_record_hashes(stream_hash: int, rec_hashes: Iterable[int]) -> int:
    """Left-fold :func:`chain_hash` over a batch of record hashes (each a
    u64): in native code where the library builds, else in Python (counted
    in :data:`NATIVE_FOLDS` / :data:`PYTHON_FOLDS`)."""
    fold = _native_fold if _native_fold is not None else _load_native_fold()
    if fold:
        buf = array("Q", rec_hashes)
        NATIVE_FOLDS[0] += 1
        return fold(stream_hash & _M64, buf.buffer_info()[0], len(buf)) if buf else stream_hash
    PYTHON_FOLDS[0] += 1
    acc = stream_hash
    for rh in rec_hashes:
        acc = chain_hash(acc, rh)
    return acc


def stream_hash_of_bodies(bodies: Iterable[bytes]) -> int:
    """Cumulative hash of an entire stream given every record body in order."""
    return fold_record_hashes(0, (record_hash(b) for b in bodies))
