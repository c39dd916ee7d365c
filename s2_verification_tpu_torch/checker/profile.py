"""The search-shape profile of one decided history (the JAX package's
``service/scheduler.py::job_profile``).  The CLI's ``-profile OUT.json``
writes it, and the daemon attaches it to ``done`` events and replies
under ``serve --profile``."""

from __future__ import annotations

from .oracle import CheckResult

__all__ = ["ACCEL_COUNTERS", "accel_counters", "job_profile"]

#: prune and speculation counters, reported only where nonzero
ACCEL_COUNTERS = (
    "prune_commits",
    "prune_dead",
    "prune_ranked",
    "spec_launches",
    "spec_layers",
    "spec_accepts",
    "spec_rollbacks",
)


def accel_counters(stats) -> dict:
    """The prune and speculation counters of ``stats`` that fired."""
    return {f: getattr(stats, f) for f in ACCEL_COUNTERS if getattr(stats, f)}


def job_profile(res: CheckResult) -> dict:
    """Generic result counters, plus the search statistics (and the
    per-layer or per-segment timeline of a ``profile=True`` run) where the
    frontier or device search attached them, and the native engine's phase
    timings (``phases``) where it decided."""
    out: dict = {"steps": res.steps, "cache_hits": res.cache_hits}
    st = getattr(res, "stats", None)
    if st is not None:
        out.update(
            layers=st.layers,
            max_frontier=st.max_frontier,
            max_state_set=st.max_state_set,
            auto_closed=st.auto_closed,
            expanded=st.expanded,
            pruned=st.pruned,
        )
        if st.timeline:
            out["timeline"] = st.timeline
        if st.shards:
            out["shards"] = st.shards
        # Acceleration counters only when the knobs actually fired: a
        # prune-off job's profile stays as it was.
        out.update(accel_counters(st))
    phases = getattr(res, "profile", None)
    if isinstance(phases, dict):
        out["phases"] = phases
    return out
