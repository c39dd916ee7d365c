"""verifylint — domain-aware static analysis for the serving + obs stack.

Zero-dependency ``ast``-level passes encoding the repo's invariants:

- ``torch_hygiene``      — the port's counterpart of the JAX package's
                           ``jit_hygiene``: every compiler run is recorded
                           through ``record_build``; no build and no host sync
                           (in the device layer loops) inside a loop body.
- ``event_schema``       — the ServiceStats event registry (name × field set),
                           cross-checked against every consumer: ``stats.py``
                           counters, ``AlertRule`` literals, flight/doctor and
                           archive/sentinel ``observe_event`` branches.
- ``metrics_cardinality``— metric label values must be provably drawn from
                           closed literal sets; naming lint for the
                           ``verifyd_*`` / ``_total`` / ``_seconds`` conventions.
- ``concurrency``        — in thread-spawning classes, attributes reachable
                           from ≥2 thread entry points must be written under a
                           held ``self._lock``-style context.
- ``protocol_compat``    — frame construction and parse sites in
                           ``client.py``/``daemon.py``/``router.py`` must agree
                           with ``protocol.py``'s ``FRAME_FIELDS`` table, and
                           the HMAC must cover everything but ``UNSIGNED_FIELDS``.

The port's copy of the JAX package's ``analysis/``, over the port's own
tree: ``python -m s2_verification_tpu_torch lint`` checks it against its
own records, ``.verifylint-torch-baseline.json``,
``.verifylint-torch-cache.json`` and ``docs/EVENTS_torch.md``.
"""

from .engine import (  # noqa: F401
    ERROR,
    INFO,
    WARNING,
    Finding,
    LintEngine,
    RunResult,
    apply_baseline,
    default_passes,
    load_baseline,
    write_baseline,
)
