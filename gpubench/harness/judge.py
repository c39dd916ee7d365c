"""Whether the window's verdicts are right, by the plain reference.

Once the window has closed, its verdicts are judged from each history's
JSONL alone: every OK, and the ILLEGALs, or a sample of them drawn from
the seed where the traffic mix's ``judge.illegal_sample`` is a count
smaller than theirs (an ILLEGAL takes the reference's exhaustive search,
an OK only the replay of its witness):

- an OK must come with a witness that ``reference/witness.py`` replays:
  every operation once, in an order real time allows, through the stream
  model with the 64-bit chain hash;
- an ILLEGAL must be one that ``reference/search.py`` finds no
  linearization for.

A verdict the reference refuses is ``wrong``; an UNKNOWN or a request that
raised is ``failed``.  Each is compared with its limit, 0.
"""

from __future__ import annotations

import random

from ..reference import history, search, witness
from .window import request_seed

__all__ = ["judge", "LIMITS"]

#: the numbers compared, and the most each may read in a correct run
LIMITS = {"wrong": 0, "failed": 0}


def sample(n: int, k, seed: int) -> list[int]:
    if k == "all" or k >= n:
        return list(range(n))
    return sorted(random.Random(request_seed(seed, "judge")).sample(range(n), k))


def judge_one(text: str, outcome: str, order) -> str:
    """``""`` where the reference agrees with the verdict, else why not."""
    ops = history.parse(text)
    if outcome == "ok":
        ok, why = witness.replay(ops, order)
        return "" if ok else f"OK, but the witness does not replay: {why}"
    found = search.decide(ops)
    return "" if found is None else "ILLEGAL, but the reference finds a linearization"


def judge(requests, pool: list[str], illegal_sample, seed: int) -> tuple[dict, int, list[str]]:
    """The numbers compared, how many verdicts were judged, and why each
    refused verdict was refused."""
    failed = [r for r in requests if not r.decided]
    oks = [r for r in requests if r.decided and r.outcome == "ok"]
    illegal = [r for r in requests if r.decided and r.outcome != "ok"]
    picked = oks + [illegal[i] for i in sample(len(illegal), illegal_sample, seed)]
    wrong = []
    for r in picked:
        why = judge_one(pool[r.pool_index], r.outcome, r.witness)
        if why:
            wrong.append(f"request {requests.index(r)}: {why}")
    return {"wrong": len(wrong), "failed": len(failed)}, len(picked), wrong
