"""Port parity: the per-layer witness log (``witness_max_frontier > 0``).

Held integer-exact against the JAX engine on the CPU:

- ``run_search(log=True)`` from JAX-built tables: the log of every
  committed layer (rows, parent rows, ``op*2 + branch``) equals the JAX
  engine's ``[log_layers, F]`` columns, sparsified as its host loop does;
- ``check_device`` and ``check_device_auto`` with the log on: the
  linearization, final states and statistics equal the JAX engine's on the
  collector workflows at ``start_frontier=2`` (escalations mid-log), on
  adversarial histories with the log kept and dropped past its cap, with
  ``prune``, with ``speculate_depth`` (the dive stands down), through the
  chunked tier, at a checkpoint cadence and across a checkpoint resume.
"""

import contextlib
import os

import numpy as np
import pytest

from s2_verification_tpu.collector.collect import CollectConfig, collect_history
from s2_verification_tpu.collector.fake_s2 import FaultPlan
from s2_verification_tpu.models.encode import encode_history as jax_encode
from s2_verification_tpu_torch.checker import device as pdev
from s2_verification_tpu_torch.checker.oracle import CheckOutcome, check
from s2_verification_tpu_torch.models.encode import encode_history

from test_torch_chunked import STAT_FIELDS
from test_torch_device import assert_results_equal, both, jax_adversarial, jax_tables_dict, jdev


def _collected(workflow):
    """The history of the JAX package's own witness-log test."""
    return collect_history(
        CollectConfig(
            num_concurrent_clients=4, num_ops_per_client=15, workflow=workflow, seed=23,
            faults=FaultPlan.chaos(0.25),
        )
    )


def assert_same(rj, rp, hp):
    assert_results_equal(rj, rp, hp)
    for f in STAT_FIELDS:
        assert getattr(rp.stats, f) == getattr(rj.stats, f), f


def _jax_log(out, n_rows):
    wp, wo = np.asarray(out.wparent[:n_rows]), np.asarray(out.wop[:n_rows])
    out = []
    for layer in range(n_rows):
        rows = np.flatnonzero(wo[layer] >= 0)
        out.append((rows, wp[layer][rows], wo[layer][rows]))
    return out


@pytest.mark.parametrize(
    "name,f,n",
    [("fencing", 4, 9), ("adv-k5", 64, 6)],
)
def test_run_search_log_equals_jax(name, f, n):
    events = _collected("fencing") if name == "fencing" else jax_adversarial(5, batch=4, seed=1)
    hj, hp = both(events)
    ej, ep = jax_encode(hj), encode_history(hp)
    tj = jdev.build_tables(ej)
    tp = pdev.tables_from_arrays(jax_tables_dict(tj), "cpu")
    kw = dict(allow_prune=False, exact_pack=True)
    oj = jdev.run_search(tj, jdev.init_frontier(ej, f), np.int32(n), log_layers=16, **kw)
    op = pdev.run_search(tp, pdev.init_frontier(ep, f, "cpu"), n, log=True, **kw)
    assert op.stop_code == int(oj.stop_code) and op.layers == int(oj.layers)
    n_rows = op.layers - (1 if op.stop_code == pdev.STOP_ACCEPT else 0)
    want = _jax_log(oj, n_rows)
    assert len(op.wlog) == n_rows > 0
    for (rj, pj, oj_), (rp, pp, op_) in zip(want, op.wlog):
        np.testing.assert_array_equal(rp, rj)
        np.testing.assert_array_equal(pp, pj)
        np.testing.assert_array_equal(op_, oj_)
    assert pdev.run_search(tp, pdev.init_frontier(ep, f, "cpu"), n, allow_prune=False).wlog is None
    with pytest.raises(ValueError, match="witness log"):
        pdev.run_search(tp, pdev.init_frontier(ep, f, "cpu"), n, allow_prune=False, spec_depth=2,
                        spec_width=4, log=True)


#: (history, check_device options): each with the witness log on
CASES = {
    "regular-start2": ("regular", dict(max_frontier=4096, start_frontier=2, beam=False,
                                       witness_max_frontier=4096)),
    "match-seq-num-start2": ("match-seq-num", dict(max_frontier=4096, start_frontier=2, beam=False,
                                                   witness_max_frontier=4096)),
    "fencing-start2": ("fencing", dict(max_frontier=4096, start_frontier=2, beam=False,
                                       witness_max_frontier=4096)),
    "adv-k5-cap4096": ("adv-k5", dict(max_frontier=4096, beam=False, witness_max_frontier=4096)),
    "adv-k5-cap16-dropped": ("adv-k5", dict(max_frontier=4096, beam=False, witness_max_frontier=16)),
    "fencing-prune": ("fencing", dict(max_frontier=4096, start_frontier=2, beam=False, prune=True,
                                      witness_max_frontier=4096)),
    "adv-k5-prune": ("adv-k5", dict(max_frontier=4096, beam=False, prune=True, witness_max_frontier=4096)),
    "adv-k5-speculate": ("adv-k5", dict(max_frontier=4096, beam=False, speculate_depth=2,
                                        witness_max_frontier=4096)),
    "adv-k5-unsat": ("adv-k5-unsat", dict(max_frontier=4096, beam=False, witness_max_frontier=4096)),
    # 16-row chunks under a 4096-row device-resident cap, the log on
    "adv-k5-chunked": ("adv-k5", dict(max_frontier=16, start_frontier=16, beam=False, device_rows_cap=4096,
                                      witness_max_frontier=4096)),
    # 3-layer segments that snapshot, the log carried across them
    "fencing-checkpoint-cadence": ("fencing", dict(max_frontier=4096, start_frontier=2, beam=False,
                                                   checkpoint_every=3, witness_max_frontier=4096)),
}


def _events(name):
    if name == "adv-k5":
        return jax_adversarial(5, batch=4, seed=1)
    if name == "adv-k5-unsat":
        return jax_adversarial(5, batch=4, seed=1, unsatisfiable=True)
    return _collected(name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_check_device_with_the_log_equals_jax(case, tmp_path):
    name, kw = CASES[case]
    hj, hp = both(_events(name))
    kw = dict(kw, collect_stats=True)
    if "checkpoint_every" in kw:
        kw_j = dict(kw, checkpoint_path=str(tmp_path / "j.ck"))
        kw_p = dict(kw, checkpoint_path=str(tmp_path / "p.ck"))
    else:
        kw_j = kw_p = kw
    rj = jdev.check_device(hj, **kw_j)
    rp = pdev.check_device(hp, device="cpu", **kw_p)
    assert rp.outcome == check(hp).outcome
    assert_same(rj, rp, hp)
    if rp.outcome == CheckOutcome.OK:
        assert rp.linearization is not None
    if "speculate_depth" in kw:
        assert rp.stats.spec_launches == 0  # the dive stood down


@pytest.mark.parametrize("name", ["match-seq-num", "adv-k5"])
def test_check_device_auto_with_the_log_equals_jax(name):
    hj, hp = both(_events(name))
    kw = dict(beam_width=16, exhaustive_cap=4096, witness_max_frontier=4096, collect_stats=True, spill=False)
    assert_same(jdev.check_device_auto(hj, **kw), pdev.check_device_auto(hp, device="cpu", **kw), hp)


@contextlib.contextmanager
def _preempting(mod, n):
    real = mod.run_search
    calls = {"n": 0}

    def interrupting(*a, **kw):
        out = real(*a, **kw)
        calls["n"] += 1
        if calls["n"] == n:
            raise KeyboardInterrupt
        return out

    mod.run_search = interrupting
    try:
        yield
    finally:
        mod.run_search = real


def test_resume_drops_the_log_as_jax_does(tmp_path):
    # The port leaves a snapshot mid-search; each engine resumes its copy
    # with the log asked for, which a resumed run drops (the layers before
    # the snapshot are not in it): both re-search the witness alike.
    hj, hp = both(_collected("fencing"))
    kw = dict(beam=False, max_frontier=4096, start_frontier=2, checkpoint_every=3, witness_max_frontier=4096)
    src = str(tmp_path / "src.ck")
    with _preempting(pdev, 4), pytest.raises(KeyboardInterrupt):
        pdev.check_device(hp, checkpoint_path=src, device="cpu", **kw)
    out = {}
    for who, mod, hist, dkw in (("jax", jdev, hj, {}), ("port", pdev, hp, {"device": "cpu"})):
        ck = str(tmp_path / f"{who}.ck")
        with open(src, "rb") as s, open(ck, "wb") as d:
            d.write(s.read())
        out[who] = mod.check_device(hist, checkpoint_path=ck, collect_stats=True, **dkw, **kw)
        assert not os.path.exists(ck)
    assert out["port"].outcome == CheckOutcome.OK
    assert_same(out["jax"], out["port"], hp)
