"""Multi-device sharding of the frontier search (the JAX package's
``parallel``): the mesh, and the process group of a multi-process run."""

from .distributed import (
    FrontierMesh,
    frontier_mesh,
    init_distributed,
    multiprocess_supported,
    shutdown_distributed,
)

__all__ = [
    "FrontierMesh",
    "init_distributed",
    "frontier_mesh",
    "multiprocess_supported",
    "shutdown_distributed",
]
