"""The chain-hash fold over frontier lanes: the CUDA kernel's wrapper.

Replaces the JAX package's Pallas kernel ``ops/fold_pallas.py::
fold_lanes_pallas``.  :func:`fold_lanes` folds ``rh[row[i], :length[i]]``
into each lane's seed:

- on a CPU tensor it runs the plain PyTorch fold
  (:func:`.xxh3.fold_record_hashes_indexed`);
- on a CUDA tensor it launches ``csrc/fold_lanes.cu`` and counts the launch
  in :data:`LAUNCHES`.  A failed build or launch raises; nothing falls back
  to the plain fold on the card.

A call runs two kernels: ``scan_kernel`` lists the lanes that fold, and
``fold_kernel``, launched behind it as a programmatic dependent, folds
them on a persistent grid whose warps take only listed lanes, so lanes of
length 0 occupy no warp slot (design notes in csrc/fold_lanes.cu).  The
wrapper launches ``min(grid_cap, ceil(N / 1024))`` fold blocks of 1024
threads, where ``grid_cap`` is the SM count times the blocks the occupancy
API finds resident on one SM (asked once per device and table shape; one
on an H100).  It passes the stream's scratch: the counters (``torch.zeros``
once per device and stream; the fold kernel leaves them at zero) and the
lane list (``torch.empty`` int32, kept and grown to the widest call so far;
calls on one stream run in order, so they can share it).  A failed launch
drops both.  A call of at most
1024 lanes (the one-lane calls of ``_fast_multi``) runs the fold kernel
alone on one block, one thread per lane, and needs neither.
:data:`LAUNCHES` counts one per call, whether it launched two kernels or
one.

Build: at first use, ``nvcc -gencode arch=compute_90a,code=sm_90a`` compiles
the source into a shared library with a plain C interface under
``s2_verification_tpu_torch/_build/`` (named by the source's content hash,
so an edited source never loads a stale library), bound with ``ctypes``.
No PyTorch headers are compiled, so the build takes seconds.
``build(trace=True)`` builds the diagnostic ``-DFOLD_TRACE`` library, whose
fold kernel records a per-warp timeline; ``foldbench`` launches it
through ``fold_lanes_cuda(..., trace=True)``.

What bounds it on the card: integer operations (32 bytes per lane; per
fold step about 31 instructions, 20 of them on the integer ALU pipe), see
csrc/fold_lanes.cu.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

from ..obs.introspect import record_build
from .xxh3 import fold_record_hashes_indexed

__all__ = [
    "LAUNCHES",
    "BUILD",
    "LAST_LAUNCH",
    "build",
    "compile_library",
    "fold_lanes",
    "fold_lanes_cuda",
    "reset_launches",
]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fold_lanes.cu"
BUILD_DIR = _PKG / "_build"

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"fold_lanes": 0}
#: what the build did: library path, seconds spent compiling (0.0 when an
#: existing library was loaded), and the compiler's output
BUILD: dict = {}
#: the last launch: ``shared`` (1 when the table was staged in shared
#: memory), fold ``blocks`` launched, ``grid_cap`` (the persistent grid),
#: ``block_lanes`` (threads per fold block)
LAST_LAUNCH: dict = {}

_libs: dict[bool, ctypes.CDLL] = {}
_plans: dict[tuple, tuple[int, int, int, int]] = {}
_scratch: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "fold_lanes: nvcc not found (set CUDA_HOME); the CUDA kernel "
            "cannot be built"
        )
    return found


def compile_library(source: Path, trace: bool = False) -> tuple[Path, float, str]:
    """``nvcc`` ``source`` (with ``-DFOLD_TRACE`` if ``trace``) into a shared
    library under :data:`BUILD_DIR`, unless one built from the same bytes
    exists.  Returns ``(path, seconds compiling, compiler output)``; raises
    if nvcc fails.  Safe to call from several threads at once.  A build
    that ran nvcc is recorded in ``obs.introspect.INTROSPECTOR``."""
    tag = hashlib.sha1(source.read_bytes()).hexdigest()[:12]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"lib{source.stem}-{tag}{'-trace' if trace else ''}.so"
    if so.exists():
        return so, 0.0, ""
    t0 = time.monotonic()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [
        nvcc_path(),
        "-gencode",
        "arch=compute_90a,code=sm_90a",
        "-std=c++17",
        "-O3",
        "-Xptxas",
        "-v",
        "-shared",
        "-Xcompiler",
        "-fPIC",
        *(["-DFOLD_TRACE"] if trace else []),
        "-o",
        tmp,
        str(source),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{source.name}: nvcc failed:\n{log}")
    os.replace(tmp, so)
    seconds = time.monotonic() - t0
    record_build(f"nvcc:{source.name}", f"{tag}{'-trace' if trace else ''}", seconds)
    return so, seconds, log


def build(trace: bool = False) -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; idempotent.
    ``trace`` builds the diagnostic library (``-DFOLD_TRACE``, which also
    exports ``fold_lanes_trace``) instead; :data:`BUILD` is the product's."""
    with _lock:
        if trace in _libs:
            return _libs[trace]
    so, seconds, log = compile_library(SOURCE, trace)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.fold_lanes_plan.argtypes = [i, i, ip, ip, ip, ip]
    lib.fold_lanes_plan.restype = i
    lib.fold_lanes_launch.argtypes = [p, p, p, p, i, i, i, i, i, p, p, p, i, p]
    lib.fold_lanes_launch.restype = i
    lib.fold_lanes_counters.argtypes = []
    lib.fold_lanes_counters.restype = i
    lib.fold_lanes_error_string.argtypes = [i]
    lib.fold_lanes_error_string.restype = ctypes.c_char_p
    with _lock:
        if trace not in _libs:
            if not trace:
                BUILD.update(path=str(so), seconds=seconds, log=log)
            _libs[trace] = lib
        return _libs[trace]


def _check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.fold_lanes_error_string(rc).decode()
        raise RuntimeError(f"fold_lanes {what} failed: {msg} (cudaError {rc})")


def plan(lib: ctypes.CDLL, device: torch.device, r: int, l: int) -> tuple[int, int, int, int]:
    """``(shared, stride, grid_cap, block_lanes)`` for an ``[r, l]`` table
    on ``device``, asked of the library once per device and shape."""
    key = (id(lib), device.index, r, l)
    got = _plans.get(key)
    if got is None:
        out = [ctypes.c_int(0) for _ in range(4)]
        with torch.cuda.device(device):
            _check(lib, lib.fold_lanes_plan(r, l, *(ctypes.byref(o) for o in out)), "plan")
        got = _plans[key] = tuple(o.value for o in out)
    return got


def _check_args(seed, row, length, rh) -> None:
    """Raise, saying what is wrong, on arguments the kernel cannot take."""
    dev = seed.device
    if dev.type != "cuda":
        raise ValueError(f"fold_lanes_cuda needs CUDA tensors, got {dev}")
    for name, t, nd in (("seed", seed, 1), ("row", row, 1), ("length", length, 1), ("rh", rh, 2)):
        if t.device != dev:
            raise ValueError(f"fold_lanes: {name} is on {t.device}, seed on {dev}")
        if t.dtype != torch.int64:
            raise ValueError(f"fold_lanes: {name} must be int64, got {t.dtype}")
        if t.dim() != nd:
            raise ValueError(f"fold_lanes: {name} must be {nd}-D, got {tuple(t.shape)}")
    if row.shape[0] != seed.shape[0] or length.shape[0] != seed.shape[0]:
        raise ValueError("fold_lanes: seed, row and length must have one length")
    raise ValueError("fold_lanes: bad arguments")


def fold_lanes_cuda(
    seed: torch.Tensor,
    row: torch.Tensor,
    length: torch.Tensor,
    rh: torch.Tensor,
    trace: bool = False,
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: ``seed``/``row``/``length`` are
    ``[N]`` int64, ``rh`` the ``[R, L]`` int64 table.  Returns ``[N]``.
    ``trace`` launches the diagnostic build (:func:`build`).

    A call's host work is most of its time below about 0.04 ms of device
    work (the search's narrow calls), so the common case takes one test of
    the arguments, no device guard when the device is current, and the
    stream's raw handle."""
    if not (
        seed.is_cuda
        and seed.dtype == row.dtype == length.dtype == rh.dtype == torch.int64
        and seed.get_device() == row.get_device() == length.get_device() == rh.get_device()
        and seed.dim() == row.dim() == length.dim() == 1
        and rh.dim() == 2
        and seed.shape[0] == row.shape[0] == length.shape[0]
    ):
        _check_args(seed, row, length, rh)
    dev = seed.device
    n = seed.shape[0]
    r, l = rh.shape
    if n >= 1 << 30 or r * (l | 1) >= 1 << 31:
        raise ValueError(f"fold_lanes: {n} lanes or an [{r}, {l}] table exceed int32 indexing")
    if not (seed.is_contiguous() and row.is_contiguous() and length.is_contiguous() and rh.is_contiguous()):
        seed, row, length, rh = (t.contiguous() for t in (seed, row, length, rh))
    out = torch.empty_like(seed)
    if n == 0:
        return out
    lib = _libs.get(trace) or build(trace)
    shared, stride, grid_cap, block_lanes = plan(lib, dev, r, l)
    blocks = min(grid_cap, -(-n // block_lanes))
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    # More than one block: the kernel lists the lanes that fold in this
    # stream's lane list and counts in its counters, which it leaves at zero.
    lanes = counters = None
    if blocks > 1:
        key = (id(lib), dev.index, stream)
        counters, lanes = _scratch.get(key) or (None, None)
        if counters is None:
            counters = torch.zeros(lib.fold_lanes_counters(), dtype=torch.int32, device=dev)
        if lanes is None or lanes.numel() < n:
            lanes = torch.empty(n, dtype=torch.int32, device=dev)
        _scratch[key] = counters, lanes
    guard = contextlib.nullcontext() if dev.index == torch.cuda.current_device() else torch.cuda.device(dev)
    with guard:
        rc = lib.fold_lanes_launch(
            seed.data_ptr(),
            row.data_ptr(),
            length.data_ptr(),
            rh.data_ptr(),
            n,
            r,
            l,
            stride,
            shared,
            out.data_ptr(),
            None if lanes is None else lanes.data_ptr(),
            None if counters is None else counters.data_ptr(),
            blocks,
            stream,
        )
    if rc != 0 and counters is not None:
        _scratch.pop(key, None)  # a launch that failed may leave the counters nonzero
    _check(lib, rc, "launch")
    LAUNCHES["fold_lanes"] += 1
    LAST_LAUNCH.update(shared=shared, blocks=blocks, grid_cap=grid_cap, block_lanes=block_lanes)
    return out


def fold_lanes(
    seed: torch.Tensor, row: torch.Tensor, length: torch.Tensor, rh: torch.Tensor
) -> torch.Tensor:
    """Fold each lane's record-hash row into its seed: the plain PyTorch
    fold for CPU tensors, the CUDA kernel for CUDA tensors."""
    if seed.device.type == "cpu":
        return fold_record_hashes_indexed(seed, row, length, rh)
    return fold_lanes_cuda(seed, row, length, rh)
