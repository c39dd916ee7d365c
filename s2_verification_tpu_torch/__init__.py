"""s2_verification_tpu_torch — the linearizability checker on PyTorch and CUDA.

The port of :mod:`s2_verification_tpu` (JAX on a TPU) to one NVIDIA H100.
Module names match the JAX package so each counterpart is easy to find:

- ``utils``     — the JSONL event codec and the host chain hash
- ``models``    — the S2 stream model and its array encoding
- ``checker``   — history preparation, the CPU oracle, the native C++ engine
  (``csrc/s2check.cpp``), the host frontier engine, the GPU frontier search
  with its verdict-exact prunes, speculative dive and witness log, progress
  heartbeats, failure diagnostics and the search-shape profile
- ``ops``       — the chain-hash fold (plain torch + the CUDA kernel), the step
- ``collector`` — the collector, its fault campaigns, the adversarial family
- ``service``   — verifyd, the resident daemon (``serve`` / ``submit``): its
  wire protocol, admission queue and controller, verdict cache, scheduler
  and client, and the supervised device escalation (the search in a
  bounded child process, ``service/supervise.py`` over
  ``checker/resilient.py``), the device-lease pool, the service statistics
  and metric families
- ``obs``       — spans, trace context, metrics, the build tracker, the
  structured logger, SLO health and the perf sentinel
- ``viz``       — the HTML visualization ``check`` writes
- ``cli``       — ``check`` (backends ``oracle|native|frontier|device|auto``),
  ``collect``, ``serve`` and ``submit``

The package imports ``torch`` and ``numpy``, never ``jax`` and nothing of the
JAX package.  Entry points run on ``torch.device("cuda")`` unless the caller
passes ``device="cpu"``.
"""

from .version import __version__

__all__ = ["__version__"]
