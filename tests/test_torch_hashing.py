"""Port parity: the host chain hash and the fold (plain torch, CUDA kernel).

The port's host XXH3 (utils/hashing.py) against the ``xxhash`` C library and
the JAX package's utils/hashing.py; the port's plain torch fold against the
JAX scan fold and the Pallas kernel (interpret mode, as the JAX package's
own tests run it).  Every comparison is integer-exact (tolerance 0).
"""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import xxhash

from s2_verification_tpu.ops.fold_pallas import fold_lanes_pallas
from s2_verification_tpu.ops.u64 import U64
from s2_verification_tpu.ops.xxh3 import fold_record_hashes_indexed as jax_fold
from s2_verification_tpu.utils import hashing as jax_hashing
from s2_verification_tpu_torch.ops import fold_cuda, xxh3
from s2_verification_tpu_torch.ops.step_kernel import join_u64
from s2_verification_tpu_torch.utils import hashing


def _xx(seed: int, value: int) -> int:
    return xxhash.xxh3_64_intdigest(struct.pack("<Q", value), seed=seed)


def test_chain_hash_pinned_vectors():
    # Cross-language vectors (history.rs:687-696, main_test.go:15-32); the
    # record hashes of the bodies come from xxhash (record_hash is the
    # collector's, not the checker's).
    foo, bar, baz = (xxhash.xxh3_64_intdigest(b) for b in (b"foo", b"bar", b"baz"))
    h1 = hashing.chain_hash(0, foo)
    h2 = hashing.chain_hash(h1, bar)
    h3 = hashing.chain_hash(h2, baz)
    assert (h1, h2, h3) == (0x4D2B003EE417C3A5, 0x132E5D5DD7936EDD, 0x732EE99ABC5002FF)
    assert hashing.fold_record_hashes(0, [foo, bar, baz]) == 0x732EE99ABC5002FF
    assert hashing.fold_record_hashes(0, []) == 0
    assert hashing.fold_record_hashes(0, [11, 22, 33, 44]) == jax_hashing.fold_record_hashes(
        0, [11, 22, 33, 44]
    )


@pytest.mark.parametrize("seed", [0, 1, 0xC0FFEE])
def test_host_chain_hash_random(seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << 64, (500, 2), dtype=np.uint64)
    vals[:100, 0] |= np.uint64(1 << 63)  # seeds with the top bit set
    for s, v in vals.tolist():
        want = _xx(s, v)
        assert hashing.chain_hash(s, v) == want == jax_hashing.chain_hash(s, v)


def test_torch_chain_hash_random():
    rng = np.random.default_rng(11)
    vals = rng.integers(0, 1 << 64, (4000, 2), dtype=np.uint64)
    vals[:1000, 0] |= np.uint64(1 << 63)
    got = xxh3.chain_hash(
        torch.as_tensor(vals[:, 0].view(np.int64)),
        torch.as_tensor(vals[:, 1].view(np.int64)),
    ).numpy().view(np.uint64)
    want = np.array([_xx(s, v) for s, v in vals.tolist()], np.uint64)
    np.testing.assert_array_equal(got, want)


def _fold_batches(case: str) -> list[tuple[int, list[int]]]:
    """(seed, record hashes) batches of one case of the native fold test."""
    if case == "pinned":
        foo, bar, baz = (xxhash.xxh3_64_intdigest(b) for b in (b"foo", b"bar", b"baz"))
        return [(0, [foo, bar, baz]), (0, []), (0, [11, 22, 33, 44])]
    n = 100 if case == "no compiler" else int(case.removeprefix("len"))
    rng = np.random.default_rng(n + 17)
    out = []
    for top in (False, True):
        seed, hs = rng.integers(0, 1 << 64, dtype=np.uint64), rng.integers(0, 1 << 64, n, dtype=np.uint64)
        if top:  # a seed and record hashes with the top bit set
            seed |= np.uint64(1 << 63)
            hs |= np.uint64(1 << 63)
        out.append((int(seed), hs.tolist()))
    return out


@pytest.mark.parametrize("case", ["pinned", "len0", "len1", "len100", "len1000", "no compiler"])
def test_native_fold_equals_the_python_fold(case, monkeypatch, tmp_path):
    batches = _fold_batches(case)
    monkeypatch.setattr(hashing, "_native_fold", False)
    py0 = hashing.PYTHON_FOLDS[0]
    want = [hashing.fold_record_hashes(s, hs) for s, hs in batches]
    assert hashing.PYTHON_FOLDS[0] - py0 == len(batches)
    if case == "pinned":
        assert want == [0x732EE99ABC5002FF, 0, jax_hashing.fold_record_hashes(0, [11, 22, 33, 44])]
    else:
        assert want == [jax_hashing.fold_record_hashes(s, hs) for s, hs in batches]
    monkeypatch.setattr(hashing, "_native_fold", None)
    if case == "no compiler":
        # No compiler runs: the first fold tries the build once, in a fresh
        # build directory, and every fold runs the Python loop.
        monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
        monkeypatch.setattr(hashing, "FOLD_BUILD_DIR", tmp_path / "_build")
    native0, py0 = hashing.NATIVE_FOLDS[0], hashing.PYTHON_FOLDS[0]
    assert [hashing.fold_record_hashes(s, tuple(hs)) for s, hs in batches] == want
    folds = (hashing.NATIVE_FOLDS[0] - native0, hashing.PYTHON_FOLDS[0] - py0)
    if case == "no compiler":
        assert folds == (0, len(batches)) and hashing._native_fold is False
        assert list((tmp_path / "_build").iterdir()) == []
    else:
        assert folds == (len(batches), 0)


def _fold_case(seed, r_ops, l_max, n):
    rng = np.random.default_rng(seed)
    rh_hi = rng.integers(0, 1 << 32, (r_ops, l_max), dtype=np.uint32)
    rh_lo = rng.integers(0, 1 << 32, (r_ops, l_max), dtype=np.uint32)
    seed_hi = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    seed_lo = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    row = rng.integers(0, r_ops, n, dtype=np.int32)
    length = rng.integers(0, l_max + 1, n, dtype=np.int32)
    length[:2] = (0, l_max)  # both ends of the range
    return rh_hi, rh_lo, seed_hi, seed_lo, row, length


def _port_fold(rh_hi, rh_lo, seed_hi, seed_lo, row, length):
    out = fold_cuda.fold_lanes(
        torch.as_tensor(join_u64(seed_hi, seed_lo)),
        torch.as_tensor(row.astype(np.int64)),
        torch.as_tensor(length.astype(np.int64)),
        torch.as_tensor(join_u64(rh_hi, rh_lo)),
    )
    return out.numpy()


def test_plain_fold_matches_jax_scan_and_pallas():
    # Shapes of the JAX package's test_fold_pallas.py:24-43.
    rh_hi, rh_lo, seed_hi, seed_lo, row, length = _fold_case(7, 13, 100, 5000)
    ref = jax.vmap(
        lambda sh, sl, r, ln: jax_fold(U64(sh, sl), r, ln, jnp.asarray(rh_hi), jnp.asarray(rh_lo))
    )(jnp.asarray(seed_hi), jnp.asarray(seed_lo), jnp.asarray(row), jnp.asarray(length))
    p_hi, p_lo = fold_lanes_pallas(
        jnp.asarray(seed_hi), jnp.asarray(seed_lo), jnp.asarray(row),
        jnp.asarray(length), jnp.asarray(rh_hi), jnp.asarray(rh_lo), interpret=True,
    )
    launches = fold_cuda.LAUNCHES["fold_lanes"]
    got = _port_fold(rh_hi, rh_lo, seed_hi, seed_lo, row, length)
    assert fold_cuda.LAUNCHES["fold_lanes"] == launches  # CPU: plain fold, no launch
    np.testing.assert_array_equal(got, join_u64(np.asarray(ref.hi), np.asarray(ref.lo)))
    np.testing.assert_array_equal(got, join_u64(np.asarray(p_hi), np.asarray(p_lo)))


def test_plain_fold_matches_host_fold():
    rh_hi, rh_lo, seed_hi, seed_lo, row, length = _fold_case(3, 5, 17, 64)
    got = _port_fold(rh_hi, rh_lo, seed_hi, seed_lo, row, length).view(np.uint64)
    rh = join_u64(rh_hi, rh_lo).view(np.uint64)
    seeds = join_u64(seed_hi, seed_lo).view(np.uint64)
    for i in range(64):
        want = hashing.fold_record_hashes(
            int(seeds[i]), [int(x) for x in rh[row[i], : length[i]]]
        )
        assert int(got[i]) == want


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(13, 100), (4096, 128)], ids=["shared", "global"])
def test_fold_kernel_matches_plain_on_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA fold kernel has no CPU mode")
    rh_hi, rh_lo, seed_hi, seed_lo, row, length = _fold_case(5, *shape, 1 << 16)
    args = [
        torch.as_tensor(join_u64(seed_hi, seed_lo)),
        torch.as_tensor(row.astype(np.int64)),
        torch.as_tensor(length.astype(np.int64)),
        torch.as_tensor(join_u64(rh_hi, rh_lo)),
    ]
    want = xxh3.fold_record_hashes_indexed(*[a.cuda() for a in args])
    got = fold_cuda.fold_lanes(*[a.cuda() for a in args])
    torch.cuda.synchronize()
    assert torch.equal(got, want)
