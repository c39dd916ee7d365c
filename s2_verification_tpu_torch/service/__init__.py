"""verifyd — the resident verification service.

The one-shot CLI pays process start, history decode, backend selection
and (for the device search) the ``torch`` import, a CUDA context and the
kernels' builds on every ``check``; the daemon amortizes them across
requests.  The port's copy of the JAX package's ``service`` package:

- :mod:`.queue`      — bounded admission queue with per-client priority and
                       explicit backpressure (reject-with-retry-after).
- :mod:`.overload`   — cancel tokens, the admission controller and the
                       degraded-writer / quarantine machinery.
- :mod:`.scheduler`  — drains the queue in *shape groups* and runs the
                       ``auto`` portfolio per job, escalating to the device
                       search in a supervised child or inline.
- :mod:`.cache`      — verdict cache keyed by the canonical chain-hash
                       fingerprint of the prepared history: duplicates are
                       answered in O(1); spilled to segments under
                       ``--state-dir``.
- :mod:`.journal`    — write-ahead journal of accepted jobs over the
                       segment log: a killed daemon's orphans replay.
- :mod:`.fastprep`   — fused single-pass admission, falling back to the
                       layered decoder with identical errors.
- :mod:`.progress`   — the per-job heartbeat table the ``watch`` op reads.
- :mod:`.protocol`   — newline-delimited JSON frames, HMAC frame auth for
                       the TCP transport, bounded frame sizes, and the
                       69/75/76 exit-code contract; byte-identical to the
                       JAX package's, so either package's client talks to
                       either daemon.
- :mod:`.supervise`  — bounded-child/checkpoint-resume wrapper for device
                       jobs (``checker/resilient.py`` +
                       ``checker/checkpoint.py``), and the child's entry
                       point; a wedged or crashed CUDA job degrades to
                       ``None`` instead of taking the daemon down.
- :mod:`.devicepool` — the buddy allocator that leases power-of-two blocks
                       of cards to escalating jobs.
- :mod:`.stats`      — per-job structured events, counters and metric
                       families.

:mod:`.daemon` ties them together behind a unix-domain socket (and an
optional authenticated TCP listener); :mod:`.client` is the submit side.
:mod:`.batcher` runs a shape group as one launch, :mod:`.prefixstore`
resumes a stream from its cached frontier, and the fleet tier rides four
more: :mod:`.router` fronts N daemons behind a single address speaking
the same protocol (consistent-hash routing on the verdict-cache
fingerprint, bounded work-stealing, circuit-broken failover, drain-aware
rolling restarts: the ``route`` CLI subcommand), :mod:`.distsearch`
splits one search's frontier across the fleet under a grant ledger,
:mod:`.chaosproxy` injects frame faults, and :mod:`.soak` runs the
closed-loop campaign soak.  Nothing here imports ``torch`` until an
inline escalation or a vmap launch group runs: a supervised daemon and
the router never touch a card.  As in the JAX package,
:mod:`.supervise` is imported by name (it is also the child's ``-m``
entry point).
"""

from .cache import VerdictCache, history_fingerprint
from .client import (
    VerifydBusy,
    VerifydClient,
    VerifydDeadlineExceeded,
    VerifydError,
)
from .daemon import Verifyd, VerifydConfig
from .devicepool import DeviceLease, DevicePool, lease_size_for
from .queue import AdmissionQueue, Job, QueueFull
from .router import BackendSpec, HashRing, RouterConfig, VerifydRouter
from .scheduler import shape_key
from .stats import ServiceStats

__all__ = [
    "AdmissionQueue",
    "BackendSpec",
    "DeviceLease",
    "DevicePool",
    "HashRing",
    "Job",
    "QueueFull",
    "RouterConfig",
    "ServiceStats",
    "VerdictCache",
    "Verifyd",
    "VerifydBusy",
    "VerifydClient",
    "VerifydConfig",
    "VerifydDeadlineExceeded",
    "VerifydError",
    "VerifydRouter",
    "history_fingerprint",
    "lease_size_for",
    "shape_key",
]
