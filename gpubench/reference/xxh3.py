"""The S2 chain hash, written out from the XXH3-64 specification.

A stream's hash is the left fold of ``chain(stream_hash, record_hash)``
over its records, from 0 for the empty stream, where ``chain`` is XXH3-64
of the 8 little-endian bytes of the record hash, seeded by the running
stream hash.  For an input of 4 to 8 bytes XXH3-64 is
(``xxhash.h``, ``XXH3_len_4to8_64b``):

    seed'   = seed ^ (bswap32(lo32(seed)) << 32)
    input64 = lo32(data) << 32 | hi32(data)      # rotl(data, 32) for 8 bytes
    keyed   = input64 ^ ((secret[8:16] ^ secret[16:24]) - seed')
    rrmxmx:   h  = keyed ^ rotl(keyed, 49) ^ rotl(keyed, 24)
              h *= 0x9FB21C651E98DF25
              h ^= (h >> 35) + len
              h *= 0x9FB21C651E98DF25
              h ^= h >> 28

``chain`` takes Python ints; ``chain_np`` folds one record hash into an
array of stream hashes at once, ``fold_np`` a batch of them.  All
arithmetic is modulo 2^64.
"""

from __future__ import annotations

import numpy as np

__all__ = ["M64", "chain", "chain_np", "fold_np"]

M64 = (1 << 64) - 1
_M32 = (1 << 32) - 1
#: bytes 0..24 of XXH3's default 192-byte secret (kSecret)
_SECRET_HEAD = bytes.fromhex("b8fe6c3923a44bbe7c01812cf721ad1cded46de9839097db")
_BITFLIP = int.from_bytes(_SECRET_HEAD[8:16], "little") ^ int.from_bytes(_SECRET_HEAD[16:24], "little")
_PRIME_MX2 = 0x9FB21C651E98DF25


def _rotl(x: int, k: int) -> int:
    return ((x << k) | (x >> (64 - k))) & M64


def chain(stream_hash: int, record_hash: int) -> int:
    seed = stream_hash & M64
    lo = seed & _M32
    seed ^= int.from_bytes(lo.to_bytes(4, "little"), "big") << 32
    keyed = _rotl(record_hash & M64, 32) ^ ((_BITFLIP - seed) & M64)
    h = keyed ^ _rotl(keyed, 49) ^ _rotl(keyed, 24)
    h = (h * _PRIME_MX2) & M64
    h ^= (h >> 35) + 8
    h = (h * _PRIME_MX2) & M64
    return h ^ (h >> 28)


_U = np.uint64


def _rotl_np(x: np.ndarray, k: int) -> np.ndarray:
    return (x << _U(k)) | (x >> _U(64 - k))


def chain_np(stream_hashes: np.ndarray, record_hash: int) -> np.ndarray:
    """``chain`` of every element of a uint64 array with one record hash."""
    s = stream_hashes
    lo = s & _U(_M32)
    swapped = ((lo & _U(0xFF)) << _U(24)) | (((lo >> _U(8)) & _U(0xFF)) << _U(16)) \
        | (((lo >> _U(16)) & _U(0xFF)) << _U(8)) | (lo >> _U(24))
    s = s ^ (swapped << _U(32))
    keyed = _U(_rotl(record_hash & M64, 32)) ^ (_U(_BITFLIP) - s)
    h = keyed ^ _rotl_np(keyed, 49) ^ _rotl_np(keyed, 24)
    h = h * _U(_PRIME_MX2)
    h = h ^ ((h >> _U(35)) + _U(8))
    h = h * _U(_PRIME_MX2)
    return h ^ (h >> _U(28))


def fold_np(stream_hashes: np.ndarray, record_hashes) -> np.ndarray:
    out = np.asarray(stream_hashes, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for rh in record_hashes:
            out = chain_np(out, rh)
    return out
