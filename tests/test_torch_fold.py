"""Port parity: the fold on the inputs that stress the kernel's lane scheduling.

The cases are ``foldbench.edge_cases()``: sparse active lanes clustered at
the front (10% active, as in the main path's wide calls), no lane active,
one lane, 33 lanes (not a whole warp), lengths above L and below 0
(clamped), and a table too large for shared memory (R=4096, L=128).  The
port's plain fold is held against the JAX package's scan fold, and on a
card the CUDA kernel against the plain fold.  Every comparison is
integer-exact (tolerance 0).

Also the measuring helpers that need no card: the lane statistics of a
call, the bound, and the reading of the step loop from SASS and of
registers from the ptxas log.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2_verification_tpu.ops.u64 import U64
from s2_verification_tpu.ops.xxh3 import fold_record_hashes_indexed as jax_fold
from s2_verification_tpu_torch.foldbench import (
    STEP_INSTRUCTIONS,
    call_stats,
    edge_cases,
    fold_bound_ms,
    ptxas_lines,
    step_counts,
)
from s2_verification_tpu_torch.ops import fold_cuda, xxh3
from s2_verification_tpu_torch.ops.step_kernel import join_u64

CASES = ["sparse_front", "all_zero", "one_lane", "n33", "clamped", "big_table"]


def _split(words: np.ndarray):
    u = words.view(np.uint64)
    return jnp.asarray((u >> np.uint64(32)).astype(np.uint32)), jnp.asarray(u.astype(np.uint32))


def test_cases_are_the_edge_cases():
    assert sorted(CASES) == sorted(edge_cases())


@pytest.mark.parametrize("case", CASES)
def test_plain_fold_matches_jax_scan(case):
    seed, row, length, rh = edge_cases()[case]
    rh_hi, rh_lo = _split(rh)
    seed_hi, seed_lo = _split(seed)
    ref = jax.vmap(lambda sh, sl, r, ln: jax_fold(U64(sh, sl), r, ln, rh_hi, rh_lo))(
        seed_hi, seed_lo, jnp.asarray(row.astype(np.int32)), jnp.asarray(length.astype(np.int32))
    )
    launches = fold_cuda.LAUNCHES["fold_lanes"]
    got = fold_cuda.fold_lanes(*(torch.from_numpy(a) for a in (seed, row, length, rh))).numpy()
    assert fold_cuda.LAUNCHES["fold_lanes"] == launches  # CPU: plain fold, no launch
    np.testing.assert_array_equal(got, join_u64(np.asarray(ref.hi), np.asarray(ref.lo)))
    if case == "all_zero":
        np.testing.assert_array_equal(got, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_fold_kernel_matches_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA fold kernel has no CPU mode")
    args = [torch.from_numpy(a).cuda() for a in edge_cases()[case]]
    want = xxh3.fold_record_hashes_indexed(*args)
    launches = fold_cuda.LAUNCHES["fold_lanes"]
    got = fold_cuda.fold_lanes(*args)
    torch.cuda.synchronize()
    assert fold_cuda.LAUNCHES["fold_lanes"] == launches + 1
    assert torch.equal(got, want)


def test_call_stats_counts_the_one_thread_per_lane_warps():
    # Three 32-lane groups: one lane of 10 steps (the group runs 10 steps);
    # 31 lanes of 4 and one of 7 (it runs 7); two lanes of 0 and -3 (none).
    length = torch.zeros(66, dtype=torch.int64)
    length[0] = 10
    length[32:64] = 4
    length[40] = 7
    length[65] = -3
    st = call_stats(length, 10)
    assert st["lanes"] == 66 and st["active"] == 33
    assert st["steps"] == 10 + 31 * 4 + 7
    assert st["warp_efficiency"] == st["steps"] / (32 * (10 + 7 + 0))
    assert call_stats(torch.zeros(5, dtype=torch.int64), 3)["warp_efficiency"] is None


def test_bound_counts_fixed_step_costs_wherever_the_table_lies():
    # Steps 5 + 100 (clamped) + 0 + 0 on a slow clock, so operations set it;
    # the ALU pipe (18.50 of 64 per clock) is the busiest.
    length = torch.tensor([5, 200, -1, 0])
    clocks = 1e6
    want = 105 * STEP_INSTRUCTIONS["alu"] / 64 / clocks * 1e3
    for r in (16, 4096):  # a table that fits shared memory and one that does not
        ms, by = fold_bound_ms(length, r, 100, clocks)
        assert by == "operations" and ms == pytest.approx(want, rel=1e-12)
    # On a fast clock the bytes set it: 32 per lane and the table once.
    ms, by = fold_bound_ms(length, 4096, 100, 1e15)
    assert by == "bytes" and ms == pytest.approx((4 * 32 + 4096 * 100 * 8) / 3.35e12 * 1e3)


def test_ptxas_lines_name_each_kernel():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111fold_kernelILb0EEEvPKyPKxS4_S2_iiiPyPiS5_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111fold_kernelILb0EEEvPKyPKxS4_S2_iiiPyPiS5_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 41088 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111scan_kernelEPKxiiPiS2_' for 'sm_90a'
ptxas info    : Used 32 registers, used 1 barriers, 256 bytes smem
"""
    assert ptxas_lines(log) == [
        "fold/global: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "fold/global: Used 48 registers, used 1 barriers, 41088 bytes smem",
        "scan: Used 32 registers, used 1 barriers, 256 bytes smem",
    ]


_SASS = """
        Function : _ZN12_GLOBAL__N_111scan_kernelEPKxiiPiS2_
        /*0010*/                   LDG.E.64 R2, desc[UR4][R2.64] ;
        /*0020*/              @P0  BRA 0x10 ;
        Function : _ZN12_GLOBAL__N_111fold_kernelILb1EEEvPKyPKxS4_S2_iiiPyPiS5_
        /*0010*/                   PRMT R1, R2, 0x123, RZ ;
        /*0020*/                   IMAD R1, R2, R3, RZ ;
        /*0030*/              @P0  BRA 0x10 ;
        /*0040*/                   PRMT R1, R2, 0x123, RZ ;
        /*0050*/                   LOP3.LUT R1, R2, R3, RZ, 0x96, !PT ;
        /*0060*/                   PRMT R1, R2, 0x123, RZ ;
        /*0070*/                   NOP ;
        /*0080*/              @!P1 BRA 0x40 ;
        /*0090*/              @P2  BRA 0x10 ;
        Function : _ZN12_GLOBAL__N_111fold_kernelILb0EEEvPKyPKxS4_S2_iiiPyPiS5_
        /*0010*/                   PRMT R1, R2, 0x123, RZ ;
        /*0020*/                   IADD3 R1, R2, R3, RZ ;
        /*0030*/              @P0  BRA 0x10 ;
"""


def test_step_counts_reads_the_innermost_loop_with_most_steps():
    got = step_counts(_SASS)
    # shared: the loop 0x40..0x80 (two permutes) beats 0x10..0x30 (one);
    # 0x10..0x90 holds both and is not innermost; NOP is not counted.
    assert got["shared"] == {"unroll": 2, "alu": 1.5, "fma": 0.0, "issue": 2.0}
    assert got["global"] == {"unroll": 1, "alu": 2.0, "fma": 0.0, "issue": 3.0}
    with pytest.raises(RuntimeError, match="no XXH3 step loop"):
        step_counts(_SASS.replace("PRMT", "LOP3"))
    with pytest.raises(RuntimeError, match="want both variants"):
        step_counts(_SASS.split("Function : _ZN12_GLOBAL__N_111fold_kernelILb0")[0])
