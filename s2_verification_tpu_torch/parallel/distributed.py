"""The distributed backend of the port: the frontier mesh and its exchanges.

The JAX package shards the search's frontier axis over a
``jax.sharding.Mesh`` and lets XLA insert every collective.  PyTorch has
no such pass, so here the mesh is a plain description — the axis name and
one device per shard, in shard order — with the two exchanges the sharded
layer loop of ``checker/device.py`` is written against:

- :meth:`FrontierMesh.gather` stacks one small vector per shard into an
  ``[n_shards, k]`` tensor on every process;
- :meth:`FrontierMesh.exchange` delivers per-destination row blocks from
  every shard to every shard.

Between shards of one process both are copies (``.to(device)``, nothing
at all when two shards share a device: a device may repeat, so a mesh of
four shards on one card runs every exchange on that card).  Across the
processes of a group joined by :func:`init_distributed` they are
``torch.distributed`` collectives — NCCL on CUDA, gloo on the CPU — so an
in-process mesh and a process group run one code path.

Multi-process runs follow the JAX package's pattern: every process joins
the group, builds the same mesh with :func:`frontier_mesh`, holds its
``local_device_count`` consecutive shards, and runs ``run_search`` SPMD,
reading only the scalars every process holds.  ``check_device`` stays in
one process (it materializes whole frontiers on the host), as in the JAX
package.
"""

from __future__ import annotations

import atexit
from dataclasses import dataclass

import torch
import torch.distributed as dist

__all__ = ["FrontierMesh", "init_distributed", "frontier_mesh", "multiprocess_supported"]

#: the joined process group's layout, set by :func:`init_distributed`: its
#: ``backend`` and ``local``, the shards a process holds.  Module state
#: because ``torch.distributed``'s default group, which it describes, is
#: module state too; :func:`frontier_mesh` reads it.
_JOINED: dict = {}


@dataclass(frozen=True)
class FrontierMesh:
    """A 1-D mesh of frontier shards.

    ``devices`` holds one device per shard of the whole mesh, in shard
    order (a device may repeat); ``rank`` and ``world`` are this process's
    place in the process group (0 and 1 without one).  A process holds the
    ``local`` consecutive shards from ``first`` on.  A mesh built on the
    joined group (``joined``) runs its collectives on the default process
    group, looked up at each call: it holds no reference to the group, so
    :func:`shutdown_distributed` destroys the group while meshes live on."""

    axis: str
    devices: tuple
    rank: int = 0
    world: int = 1
    joined: bool = False

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local(self) -> int:
        return self.size // self.world

    @property
    def first(self) -> int:
        return self.rank * self.local

    @property
    def local_devices(self) -> tuple:
        return self.devices[self.first : self.first + self.local]

    def gather(self, vecs: list[torch.Tensor]) -> torch.Tensor:
        """``vecs``: one int64 vector of one length per local shard.
        Returns every shard's vector as an ``[n_shards, k]`` tensor on this
        process's first device (an ``all_gather`` across processes)."""
        dev = self.local_devices[0]
        mine = torch.stack([v.to(dev) for v in vecs])
        if not self.joined:
            return mine
        parts = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(parts, mine)
        return torch.cat(parts)

    def exchange(self, pieces: list[list[torch.Tensor]], sizes: list[list[int]]) -> list[list[torch.Tensor]]:
        """Deliver row blocks between shards.

        ``pieces[i][d]`` are the rows local shard ``i`` sends to shard
        ``d`` (one dtype and row shape throughout); ``sizes[s][d]`` is
        every shard's row count to every shard, the same matrix on every
        process.  Returns ``got[j][s]``: the rows local shard ``j`` received
        from shard ``s``, on its device.  Across processes the rows go in
        one ``all_to_all_single`` of the rows concatenated per process."""
        first, n_loc, devs = self.first, self.local, self.local_devices
        got: list[list] = [[None] * self.size for _ in range(n_loc)]
        for i in range(n_loc):
            for j in range(n_loc):
                got[j][first + i] = pieces[i][first + j].to(devs[j])
        if self.world == 1:
            return got
        proto = pieces[0][0]
        mine = range(first, first + n_loc)
        send, in_splits, out_splits = [], [], []
        for q in range(self.world):
            theirs = range(q * n_loc, (q + 1) * n_loc)
            if q == self.rank:
                in_splits.append(0)
                out_splits.append(0)
                continue
            send += [pieces[i][d] for i in range(n_loc) for d in theirs]
            in_splits.append(sum(sizes[first + i][d] for i in range(n_loc) for d in theirs))
            out_splits.append(sum(sizes[s][d] for s in theirs for d in mine))
        comm = devs[0]
        inp = torch.cat([p.to(comm) for p in send])
        recv = torch.empty((sum(out_splits),) + tuple(proto.shape[1:]), dtype=proto.dtype, device=comm)
        dist.all_to_all_single(recv, inp, out_splits, in_splits)
        at = 0
        for q in range(self.world):
            if q == self.rank:
                continue
            for s in range(q * n_loc, (q + 1) * n_loc):
                for j in range(n_loc):
                    m = sizes[s][first + j]
                    got[j][s] = recv[at : at + m].to(devs[j])
                    at += m
        return got


def _process_device(backend: str, rank: int) -> torch.device:
    return torch.device("cuda", rank % torch.cuda.device_count()) if backend == "nccl" else torch.device("cpu")


def init_distributed(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    *,
    local_device_count: int | None = None,
) -> None:
    """Join this process to the process group of a multi-process search.

    ``coordinator_address`` is ``host:port`` of process 0 (a TCP
    rendezvous).  The backend is NCCL when CUDA is available, each process
    on card ``process_id % device_count``, else gloo on the CPU.
    ``local_device_count`` is the number of frontier shards this process
    holds (the JAX package's virtual device count; default 1), the same in
    every process; afterwards :func:`frontier_mesh` spans ``num_processes
    × local_device_count`` shards."""
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dev = _process_device(backend, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes, rank=process_id
    )
    _JOINED.update(backend=backend, local=int(local_device_count or 1))
    atexit.register(shutdown_distributed)


def shutdown_distributed() -> None:
    """Leave the process group :func:`init_distributed` joined, joining its
    backend's threads; a no-op when no group is joined.  ``init_distributed``
    registers it to run at interpreter exit, as ``jax.distributed`` does its
    own shutdown, so a process's teardown never destroys a live group."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _JOINED.clear()


def multiprocess_supported() -> tuple[bool, str]:
    """Probe whether the joined group runs cross-process collectives:
    ``(True, "")`` when it does (or there is no second process),
    ``(False, reason)`` when the backend answers that it does not implement
    them.  The probe broadcasts one scalar from process 0; any other
    failure re-raises — a broken cluster must not pass for an unsupported
    backend."""
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return True, ""
    backend = _JOINED.get("backend", "gloo")
    one = torch.ones((), dtype=torch.int32, device=_process_device(backend, dist.get_rank()))
    try:
        dist.broadcast(one, src=0)
    except Exception as e:  # noqa: BLE001 — classify, re-raise the rest
        msg = str(e)
        probe = msg.lower()
        if "aren't implemented" in probe or "not implemented" in probe or "unimplemented" in probe:
            return False, msg.strip().splitlines()[-1].strip()
        raise
    return True, ""


def frontier_mesh(axis: str = "fr", devices=None) -> FrontierMesh:
    """A 1-D mesh named for the frontier axis.

    ``devices`` is an explicit device list, one entry per shard (a device
    may repeat: ``["cuda:0"] * 4`` puts four shards on one card, ``["cpu"]
    * 8`` eight on the CPU).  Without it the mesh spans the joined process
    group (:func:`init_distributed`), else every visible CUDA device; with
    neither it raises ``DeviceUnavailable`` — a mesh never moves to the CPU
    on its own."""
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("frontier_mesh needs at least one device")
        return FrontierMesh(axis, devs)
    if dist.is_initialized() and _JOINED:
        world, rank = dist.get_world_size(), dist.get_rank()
        devs = tuple(_process_device(_JOINED["backend"], p) for p in range(world) for _ in range(_JOINED["local"]))
        return FrontierMesh(axis, devs, rank=rank, world=world, joined=True)
    if not torch.cuda.is_available():
        from ..checker.device import DeviceUnavailable

        raise DeviceUnavailable("frontier_mesh: no CUDA device is visible; name the devices to shard over")
    return FrontierMesh(axis, tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count())))
