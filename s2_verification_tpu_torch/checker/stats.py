"""Search statistics shared by the port's engines, the device search and
the host frontier engine (JAX package: ``checker/frontier.py::FrontierStats``,
the class both of its engines share)."""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["FrontierStats"]


@dataclass
class FrontierStats:
    layers: int = 0
    max_frontier: int = 0
    max_state_set: int = 0
    auto_closed: int = 0
    expanded: int = 0
    pruned: bool = False
    #: verdict-exact commutativity-prune counters (``prune=True`` runs; see
    #: checker/prune.py).  ``prune_ranked`` counts the rank-gate drops of
    #: the host frontier engine (checker/frontier.py); the device search
    #: leaves it 0
    prune_commits: int = 0
    prune_dead: int = 0
    prune_ranked: int = 0
    #: speculative-dive counters (``speculate_depth > 0`` runs): segments
    #: that ran a dive, dive layers, dives that accepted, dives discarded
    spec_launches: int = 0
    spec_layers: int = 0
    spec_accepts: int = 0
    spec_rollbacks: int = 0
    #: per-segment profile entries (``profile=True`` runs)
    timeline: list = field(default_factory=list)
    #: per-shard summary (sharded runs over a frontier mesh)
    shards: list = field(default_factory=list)
    #: host<->device synchronisations the GPU search made (each fetch of
    #: a scalar that steers the host loop is one)
    host_syncs: int = 0
