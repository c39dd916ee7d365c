"""Port parity: the native C++ engine (``csrc/s2check.cpp`` through
``checker/native.py``).

- the port's source is byte for byte the JAX package's ``native/s2check.cpp``,
  and the library is built from it alone, into ``_build/`` under a name
  that carries the source's hash; builds that race each other all finish
  with a loadable library;
- ``check_native`` against the JAX package's, integer-exact (outcome,
  linearization, ``deepest``, final states, DFS steps and memo hits), with
  and without ``prune``, on random histories, the campaign matrix and small
  adversarial histories (k <= 7, satisfiable and not); a budget that
  expires is UNKNOWN in both; the ``profile`` phases and the final-state
  buffer's re-run.
"""

import hashlib
import importlib
import random
import threading
from pathlib import Path

import pytest

from s2_verification_tpu.collector.campaign import builtin_campaigns, collect_labeled
from s2_verification_tpu_torch.checker import native as pna
from s2_verification_tpu_torch.checker.oracle import check

from helpers import H
from test_oracle_bruteforce import random_history
from test_torch_device import both, jax_adversarial

jna = importlib.import_module("s2_verification_tpu.checker.native")
ROOT = Path(__file__).resolve().parent.parent


def assert_same(rj, rp):
    assert rp.outcome.value == rj.outcome.value
    assert rp.linearization == rj.linearization
    assert rp.deepest == rj.deepest
    assert [tuple(s) for s in rp.final_states] == [tuple(s) for s in rj.final_states]
    assert (rp.steps, rp.cache_hits) == (rj.steps, rj.cache_hits)


def test_source_is_the_jax_packages_byte_for_byte():
    assert pna.SOURCE == ROOT / "s2_verification_tpu_torch" / "csrc" / "s2check.cpp"
    assert pna.SOURCE.read_bytes() == (ROOT / "native" / "s2check.cpp").read_bytes()


def test_builds_from_its_own_source_into_build(monkeypatch, tmp_path):
    assert pna.native_available()
    tag = hashlib.sha1(pna.SOURCE.read_bytes()).hexdigest()[:12]
    assert Path(pna.BUILD["path"]) == pna.BUILD_DIR / f"libs2check-{tag}.so"
    assert pna.BUILD_DIR == ROOT / "s2_verification_tpu_torch" / "_build"
    # The compiler is handed the port's source and nothing of the JAX
    # package's; racing builds (as under parallel test workers) each end
    # with a whole library.
    seen = []
    real_run = pna.subprocess.run

    def spy(cmd, **kw):
        seen.append(cmd)
        return real_run(cmd, **kw)

    monkeypatch.setattr(pna, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(pna.subprocess, "run", spy)
    out, errors = [], []

    def build():
        try:
            out.append(pna._compile()[0])
        except Exception as e:  # noqa: BLE001 - collected for the assert below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(set(out)) == 1 and out[0].parent == tmp_path / "_build"
    assert pna.ct.CDLL(str(out[0])).s2_check
    for cmd in seen:
        srcs = [a for a in cmd if a.endswith(".cpp")]
        assert srcs == [str(pna.SOURCE)]
        assert "s2_verification_tpu/" not in " ".join(cmd).replace("s2_verification_tpu_torch/", "")
    assert sorted(p.name for p in (tmp_path / "_build").iterdir()) == [out[0].name]


@pytest.mark.parametrize("prune", [False, True], ids=["plain", "prune"])
def test_random_histories_equal_jax(prune):
    rng = random.Random(0x5EED + prune)
    for _ in range(150):
        hj, hp = both(random_history(rng).events)
        rp = pna.check_native(hp, prune=prune)
        assert_same(jna.check_native(hj, prune=prune), rp)
        assert rp.outcome == check(hp).outcome


@pytest.mark.parametrize("prune", [False, True], ids=["plain", "prune"])
def test_campaign_matrix_equals_jax(prune):
    for name, camp in sorted(builtin_campaigns().items()):
        hj, hp = both(collect_labeled(camp, seed=11)[0])
        rp = pna.check_native(hp, prune=prune)
        assert_same(jna.check_native(hj, prune=prune), rp)
        assert rp.outcome == check(hp).outcome, name


ADVERSARIAL = [(k, unsat) for k in (3, 5, 7) for unsat in (False, True)]


@pytest.mark.parametrize("k,unsat", ADVERSARIAL, ids=[f"k{k}-{'unsat' if u else 'sat'}" for k, u in ADVERSARIAL])
@pytest.mark.parametrize("prune", [False, True], ids=["plain", "prune"])
def test_adversarial_equals_jax(k, unsat, prune):
    hj, hp = both(jax_adversarial(k, batch=3, seed=k, unsatisfiable=unsat))
    rp = pna.check_native(hp, prune=prune)
    assert_same(jna.check_native(hj, prune=prune), rp)
    assert rp.outcome.value == ("illegal" if unsat else "ok")


def test_expired_budget_is_unknown_in_both():
    # Where the DFS stands when the clock runs out depends on the clock, so
    # only the outcome is compared.
    hj, hp = both(jax_adversarial(10, batch=6, seed=3))
    assert pna.check_native(hp, time_budget_s=0.05).outcome.value == "unknown"
    assert jna.check_native(hj, time_budget_s=0.05).outcome.value == "unknown"


def test_profile_phases_and_states_buffer_rerun():
    # Three independent indefinite appends: 2^3 candidate final states.
    h = H()
    for i in range(3):
        h.append_indefinite_fail(i + 1, [100 + i])
    hj, hp = both(h.events)
    rp = pna.check_native(hp, profile=True, _states_cap=1)
    rj = jna.check_native(hj, profile=True, _states_cap=1)
    assert len(rp.final_states) == 8
    assert_same(rj, rp)
    assert set(rp.profile) == set(rj.profile) == {"encode_s", "search_s", "steps", "cache_hits"}
    assert (rp.profile["steps"], rp.profile["cache_hits"]) == (rp.steps, rp.cache_hits)
