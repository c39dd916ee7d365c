"""Port parity: the port's own XXH3-64 of record bodies against ``xxhash``.

``s2_verification_tpu_torch.utils.hashing.record_hash`` is XXH3-64 with no
seed, written on Python ints and numpy so that the port needs no
``xxhash``.  It is held equal (tolerance 0) to ``xxhash.xxh3_64_intdigest``
at every length from 0 to 1,100 bytes and at 2,048, 4,096 and 5,000: each
short class, the 17–128 and 129–240 classes, and over 240 bytes the
stripes, the scramble at each 1,024-byte block, the last stripe and the
merge.  Bodies come from a numpy seed.
"""

import numpy as np
import pytest
import xxhash

from s2_verification_tpu.utils import hashing as jax_hashing
from s2_verification_tpu_torch.utils import hashing

LENGTHS = {
    "0-16": range(0, 17),
    "17-128": range(17, 129),
    "129-240": range(129, 241),
    "241-1100": range(241, 1101),
    "blocks": (1023, 1024, 1025, 2047, 2048, 2049, 4096, 5000),
}


@pytest.mark.parametrize("lengths", sorted(LENGTHS))
def test_record_hash_equals_xxhash_at_every_length(lengths):
    rng = np.random.default_rng(sum(map(ord, lengths)))
    for n in LENGTHS[lengths]:
        for body in (
            rng.integers(0, 256, n, dtype=np.uint8).tobytes(),
            b"\xff" * n,
            bytes(n),
        ):
            assert hashing.record_hash(body) == xxhash.xxh3_64_intdigest(body), n


def test_record_hash_random_bodies():
    # The collector's body sizes: 1 to 1,016 bytes (workloads.py:120-132).
    rng = np.random.default_rng(20260729)
    sizes = rng.integers(1, 1017, 500)
    for n in sizes:
        body = rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
        assert hashing.record_hash(body) == xxhash.xxh3_64_intdigest(body)


def test_pinned_chain_vector():
    # foo, bar, baz fold to 0x732EE99ABC5002FF (history.rs:687-696,
    # main_test.go:15-32), with the record hashes the port computes itself.
    assert hashing.stream_hash_of_bodies([b"foo", b"bar", b"baz"]) == 0x732EE99ABC5002FF
    assert hashing.stream_hash_of_bodies([]) == 0
    bodies = [bytes([i % 256]) * i for i in range(300)]
    assert hashing.stream_hash_of_bodies(bodies) == jax_hashing.stream_hash_of_bodies(bodies)
