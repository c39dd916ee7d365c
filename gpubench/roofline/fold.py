"""The least time the card can take for a call of the chain-hash fold.

The fold (``fold_lanes(seed, row, length, rh)``) hashes, for each lane
``i``, the record hashes ``rh[row[i], :length[i]]`` into the lane's seed,
one XXH3-64 chain step per record hash.  Its work is counted from what
the call asks for, not from any kernel that does it:

- steps: each lane's ``length`` clamped to ``[0, rh.shape[1]]``, summed;
- bytes: 32 a lane (its seed, row and length read and its result written,
  8 bytes each) plus the table ``rh`` read once.

One step, XXH3-64 of the 8 little-endian bytes of a record hash seeded by
the running hash (``reference/xxh3.py``), written as the 32-bit integer
operations that carry its 64-bit arithmetic on the card (a u64 is a pair
of 32-bit words):

1. ``seed' = seed ^ (bswap32(lo32(seed)) << 32)``: a byte permute of the
   low word, and an xor into the high word; the shift only places it.
   2 logic.
2. ``input64 = rotl(rh, 32)``: swaps the words; nothing to compute.
3. ``keyed = input64 ^ (BITFLIP - seed')``: a 64-bit subtract from a
   constant (low word, then high word with the borrow), and an xor of each
   word.  2 add, 2 logic.
4. ``h = keyed ^ rotl(keyed, 49) ^ rotl(keyed, 24)``: a rotate by other
   than 32 is a funnel shift for each result word (4), and a three-input
   xor is one logic operation a word (2).  6 logic.
5. ``h *= PRIME_MX2`` (mod 2^64): the low words' 64-bit product, and the
   two cross products added into the high word.  3 multiply.
6. ``h ^= (h >> 35) + 8``: ``h >> 35`` is the high word shifted by 3, with
   a high word of 0; adding 8 cannot carry out of the low word; the xor
   touches the low word only.  2 logic, 1 add.
7. ``h *= PRIME_MX2``: 3 multiply.
8. ``h ^= h >> 28``: a funnel shift and a shift, and an xor a word.
   4 logic.

In all 16 logic, 3 add and 6 multiply operations.  On Hopper an SM runs,
each clock, 64 lanes of logic, shift and permute operations on its integer
pipe and 64 lanes of integer multiplies on its FMA pipe; an add may run on
either; its four schedulers dispatch 128 lane-instructions.  So a step needs
at least ``max(logic, multiply, (logic + add + multiply) / 2) / 64`` SM
clocks, here 16 / 64 = 0.25.  Loading the record hash and the loop's own
index arithmetic are the kernel's, not the hash's, and are not counted.

The bound of a call is the larger of the operations' time (steps times
clocks a step, over the SMs at their highest clock) and the bytes' time
(at the HBM's rate), and ``bound_by`` says which.
"""

from __future__ import annotations

import json
from pathlib import Path

__all__ = ["STEP_OPS", "PEAKS", "clocks_per_step", "call_steps", "call_bytes", "call_bound_s"]

#: 32-bit integer operations a fold step needs, by kind (derivation above)
STEP_OPS = {"logic": 16, "add": 3, "multiply": 6}
#: the card's peaks, by the name ``torch.cuda.get_device_name`` gives
PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def clocks_per_step(peak: dict) -> float:
    """SM clocks a lane's step needs at least, with the step's operations
    spread over the integer and FMA pipes as they allow."""
    logic, add, mul = STEP_OPS["logic"], STEP_OPS["add"], STEP_OPS["multiply"]
    return max(
        logic / peak["int_logic_lanes_per_sm_clock"],
        mul / peak["int_multiply_lanes_per_sm_clock"],
        (logic + add + mul) / (peak["int_logic_lanes_per_sm_clock"] + peak["int_multiply_lanes_per_sm_clock"]),
        (logic + add + mul) / peak["dispatch_lanes_per_sm_clock"],
    )


def call_steps(length, width: int, out=None):
    """A call's steps, as a 0-d tensor on ``length``'s device: its lanes'
    lengths clamped to ``[0, width]`` and summed (into ``out`` if given)."""
    import torch

    return torch.sum(length.reshape(-1).clamp(0, width), dim=0, out=out)


def call_bytes(lanes: int, table_rows: int, width: int) -> int:
    return 32 * lanes + 8 * table_rows * width


def call_bound_s(steps: int, lanes: int, table_rows: int, width: int, peak: dict) -> tuple[float, str]:
    """The least seconds one call on these inputs can take on the card of
    ``peak`` at its highest SM clock, and what sets it: ``operations`` or
    ``bytes``."""
    ops_s = steps * clocks_per_step(peak) / (peak["sms"] * peak["max_sm_mhz"] * 1e6)
    bytes_s = call_bytes(lanes, table_rows, width) / peak["hbm_bytes_per_s"]
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")
