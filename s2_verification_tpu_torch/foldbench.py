"""The fold kernel on the card: its bound, its times, the main path's calls.

    python -m s2_verification_tpu_torch.foldbench [--baseline-source PATH]
        [--json OUT.json]

``chip_smoke.py`` takes its fold measurements from the helpers here.  Run
on its own, this records every fold call of the main path
(``check_device_auto`` of adversarial k=10, batch=100, seed 0), then times
on the same inputs, in one process, the build of csrc/fold_lanes.cu and,
with ``--baseline-source``, another version of the source that exports
the one-thread-per-lane launcher ``fold_lanes_launch(seed, row, length,
rh, int64 n, int r, int l, out, stream, int* used_shared)`` (unpack an
earlier commit with ``git archive`` and point at its csrc/fold_lanes.cu),
at the main path's calls (each call, their sum, the largest by steps), on
2^20 random lanes with a table in shared memory (also with the lanes
ordered by length) and one in global memory, and on one lane of length
100 (and of one step).  Every result is held bit-exact against the
plain fold.  Two times per input: ``device`` (the calls queued behind a
spin kernel, so the device runs them back to back and the host's launch
cost is hidden) and ``call`` (CUDA events around back-to-back calls from
Python, host cost included), and the host's own time per call.  Rows
print ``device/call/host ms (share of the bound)``.  Then it summarises one launch of the
diagnostic ``FOLD_TRACE`` build (a per-warp timeline) at the main path's
two widest calls and on the random inputs.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .ops import fold_cuda, xxh3

#: H100 SXM HBM3 rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: Per SM and clock on Hopper (sm_90), in thread-instructions: the integer
#: ALU pipe (LOP3, SHF, IADD3, ...) and the FMA pipe that runs IMAD each
#: take 64 (16 lanes per sub-partition), and the four sub-partitions issue
#: one warp instruction each, 128 in all.  The two pipes run side by side.
PIPE_RATE = {"alu": 64, "fma": 64, "issue": 128}
#: Instructions per fold step by pipe: on each pipe the fewest of the step
#: loops (unrolled 4x) read with ``cuobjdump -sass`` from csrc/fold_lanes.cu
#: built by nvcc 12.8 for sm_90a: the one-thread-per-lane kernel that the
#: persistent design replaced (ALU / FMA / issued: 19.50 / 9.25 / 30.25 with
#: the table in shared memory, 20.25 / 9.50 / 31.00 in global memory) and
#: the persistent kernel (18.50 / 9.50 / 29.75 and 21.50 / 10.00 / 34.00).
#: Fixed here, and the same wherever the table lies, so that the bound
#: counts the work of the inputs and not the instructions of the kernel
#: under test.
STEP_INSTRUCTIONS = {"alu": 18.50, "fma": 9.25, "issue": 29.75}
#: back-to-back calls per timing
REPS = 20
_ALU_OPS = {"LOP3", "SHF", "IADD3", "ISETP", "LEA", "PRMT", "SEL", "MOV", "IMNMX", "PLOP3", "IABS"}


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def sm_clocks_per_s() -> tuple[float, int, float]:
    """``(SM clocks per second over the card, SMs, max MHz)``: the SM count
    times nvidia-smi's ``clocks.max.sm``."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(
        subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True,
        ).stdout.split()[0]
    )
    return sms * mhz * 1e6, sms, mhz


def fold_bound_ms(length: torch.Tensor, r: int, l: int, clocks_per_s: float) -> tuple[float, str]:
    """Least time for one fold call on these inputs, and what sets it:
    operations (the steps these lengths ask for, each costing the fixed
    per-step instructions on the busiest pipe) or bytes (each lane's
    seed/row/length read and result written once, the table read once)."""
    steps = int(length.clamp(min=0, max=l).sum())
    ops_s = steps * max(STEP_INSTRUCTIONS[p] / PIPE_RATE[p] for p in PIPE_RATE) / clocks_per_s
    bytes_s = (int(length.numel()) * 32 + r * l * 8) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s else "bytes")


def ptxas_lines(log: str) -> list[str]:
    """The lines of an ``nvcc -Xptxas -v`` log that give registers, spills
    and shared memory, each after the kernel they belong to (``scan``,
    ``fold/shared``, ``fold/global``)."""
    out, fn = [], ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ("scan" if "scan_kernel" in ln else
                  "fold/shared" if "fold_kernelILb1E" in ln else
                  "fold/global" if "fold_kernelILb0E" in ln else ln.split()[-3])
        elif "registers" in ln or "spill" in ln:
            out.append(f"{fn}: {ln.split(':', 1)[-1].strip()}")
    return out


def blocks_per_sm(lib, sms: int) -> dict[str, int]:
    """Fold blocks resident per SM, as the launch plan reads them from the
    occupancy API, with the table in shared memory (the main path's
    [16, 112]) and in global memory ([4096, 128])."""
    dev = torch.device("cuda", torch.cuda.current_device())
    return {
        variant: fold_cuda.plan(lib, dev, r, l)[2] // sms
        for variant, (r, l) in (("shared", (16, 112)), ("global", (4096, 128)))
    }


def call_stats(length: torch.Tensor, l: int) -> dict:
    """Lanes, active lanes (length > 0), fold steps, and the warp efficiency
    a one-thread-per-lane kernel would get on these lengths: steps over
    32 x the sum, over 32-lane groups, of the group's longest length."""
    ln = length.clamp(min=0, max=l)
    steps = int(ln.sum())
    groups = torch.nn.functional.pad(ln, (0, -ln.numel() % 32)).view(-1, 32)
    slots = 32 * int(groups.max(dim=1).values.sum())
    return {
        "lanes": int(ln.numel()),
        "active": int((ln > 0).sum()),
        "steps": steps,
        "warp_efficiency": steps / slots if slots else None,
    }


def sass_step_counts(so_path: str, cuobjdump: str) -> dict[str, dict[str, float]]:
    """:func:`step_counts` of the built library's SASS (``cuobjdump -sass``)."""
    sass = subprocess.run([cuobjdump, "-sass", so_path], capture_output=True, text=True, check=True).stdout
    return step_counts(sass)


def step_counts(sass: str) -> dict[str, dict[str, float]]:
    """Instructions per fold step of each fold kernel variant in ``sass``,
    for information beside :data:`STEP_INSTRUCTIONS`.  The step loop is the
    innermost loop with the most byte permutes (one ``__byte_perm`` per
    XXH3 step); its body, branch included, is split by pipe and divided by
    its step count.  Raises unless both variants have one."""
    line_re = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)[.A-Z0-9_]*\s*([^;]*);")
    out = {}
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split()[0]
        if "fold_kernel" not in name:
            continue
        variant = "shared" if "ILb1E" in name else "global"
        ins = [(int(m[1], 16), m[2], m[3]) for m in line_re.finditer(chunk)]
        loops = set()
        for addr, op, args in ins:
            target = args.split()[0] if args else ""
            if op == "BRA" and target.startswith("0x") and int(target, 16) < addr:
                loops.add((int(target, 16), addr))
        best = None
        for lo, hi in loops:
            if any(o != (lo, hi) and lo <= o[0] and o[1] <= hi for o in loops):
                continue  # not innermost
            body = [o for a, o, _ in ins if lo <= a <= hi and o != "NOP"]
            k = body.count("PRMT")
            if k and (best is None or (k, -len(body)) > (best.count("PRMT"), -len(best))):
                best = body
        if best is None:
            raise RuntimeError(f"no XXH3 step loop found in the {variant} kernel's SASS")
        if variant in out:
            raise RuntimeError(f"two {variant}-table fold kernels in the SASS")
        steps = best.count("PRMT")
        out[variant] = {
            "unroll": steps,
            "alu": sum(o in _ALU_OPS for o in best) / steps,
            "fma": sum(o == "IMAD" for o in best) / steps,
            "issue": len(best) / steps,
        }
    if set(out) != {"shared", "global"}:
        raise RuntimeError(f"fold kernels found in the SASS: {sorted(out)}, want both variants")
    return out


def call_ms(fn, reps: int) -> float:
    """Time per call of ``fn`` from CUDA events around ``reps``
    back-to-back calls, the median of five such timings (so that one stall
    of the host does not set it): a call whose host work outlasts its
    device work is timed by the host."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    got = []
    for _ in range(5):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        got.append(start.elapsed_time(end) / reps)
    return float(np.median(got))


def times(fn, reps: int, sm_hz: float) -> tuple[float, float, float]:
    """``(device ms, call ms, host ms)`` per call of ``fn``, which launches
    a few kernels at most.

    ``call`` is :func:`call_ms`.  ``device``: the same calls queued behind
    ``torch.cuda._sleep``, long enough that the host has enqueued them all
    before the device starts the first; the events then read the device's
    own time per call, and the host's clock around the enqueue reads
    ``host``, the host's time per call with the device never in its way.
    ``sm_hz`` is the SM clock the spin counts in (the max clock: a slower
    clock only lengthens the spin).  Raises if the spin did not cover the
    enqueue after three tries."""
    t0 = time.perf_counter()
    call = call_ms(fn, reps)
    host_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for attempt in range(3):
        torch.cuda._sleep(int(2 ** (attempt + 1) * host_s * sm_hz) + 10_000)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t0) / reps * 1e3
        covered = not start.query()
        end.record()
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(end) / reps, call, host
    raise RuntimeError("the spin kernel ended before the host had enqueued the timed calls")


@contextlib.contextmanager
def recording_folds(dev_mod):
    """Record a clone of the arguments of every ``fold_lanes`` call the
    search makes through ``dev_mod`` (checker.device) while inside, and of
    every fold a replay of one of its CUDA graphs launches
    (:func:`.ops.fold_cuda.replayed`), in the order they run.  A search's
    table is one tensor that no call changes, so the calls on one table
    tensor share one clone of it."""
    calls: list[list[torch.Tensor]] = []
    last = [None, None]  # the last table seen, and its clone
    real, real_replayed = dev_mod.fold_lanes, fold_cuda.replayed

    def record(seed, row, length, rh):
        if last[0] is not rh:
            last[:] = rh, rh.clone()
        calls.append([t.clone() for t in (seed, row, length)] + [last[1]])

    def recording(seed, row, length, rh):
        record(seed, row, length, rh)
        return real(seed, row, length, rh)

    def recording_replayed(seed, row, length, rh):
        record(seed, row, length, rh)
        real_replayed(seed, row, length, rh)

    dev_mod.fold_lanes, fold_cuda.replayed = recording, recording_replayed
    try:
        yield calls
    finally:
        dev_mod.fold_lanes, fold_cuda.replayed = real, real_replayed


def random_inputs(r: int, l: int, n: int, seed: int, device: str = "cuda") -> list[torch.Tensor]:
    """``[seed, row, length, rh]``: random u64 words as int64, rows in
    ``[0, r)``, lengths uniform in ``[0, l]`` with both ends present."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 64, n + r * l, dtype=np.uint64).view(np.int64)
    length = rng.integers(0, l + 1, n, dtype=np.int64)
    length[: min(n, 2)] = (0, l)[: min(n, 2)]
    out = [words[:n], rng.integers(0, r, n, dtype=np.int64), length, words[n:].reshape(r, l)]
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in out]


def edge_cases() -> dict[str, list[np.ndarray]]:
    """Inputs that stress the kernel's lane scheduling, as numpy int64
    ``[seed, row, length, rh]``: sparse lanes clustered at the front (10%
    active, all of one length, as in the main path's wide calls), no lane
    active, one lane, 33 lanes (not a whole warp), lengths above L and
    below 0 (clamped), and a table too large for shared memory."""
    def case(seed, r, l, n, length):
        rng = np.random.default_rng(seed)
        words = rng.integers(0, 1 << 64, n + r * l, dtype=np.uint64).view(np.int64)
        row = rng.integers(0, r, n, dtype=np.int64)
        return [words[:n], row, np.asarray(length, np.int64), words[n:].reshape(r, l)]

    front = np.zeros(4096, np.int64)
    front[: 4096 // 5 : 2] = 100  # every other lane of the first fifth
    rng = np.random.default_rng(9)
    return {
        "sparse_front": case(1, 16, 112, 4096, front),
        "all_zero": case(2, 16, 112, 4096, np.zeros(4096, np.int64)),
        "one_lane": case(3, 16, 112, 1, [100]),
        "n33": case(4, 13, 100, 33, rng.integers(0, 101, 33)),
        "clamped": case(5, 7, 40, 1000, rng.integers(-50, 90, 1000)),
        "big_table": case(6, 4096, 128, 2048, rng.integers(0, 129, 2048)),
    }


def kernel_breakdown(fn, reps: int) -> dict[str, float]:
    """Device microseconds per call of ``fn`` by CUDA kernel name, from
    ``torch.profiler`` over ``reps`` calls (empty if the profiler sees no
    device time)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)
        if evt.device_type == torch.autograd.DeviceType.CUDA and us:
            out[evt.key] = out.get(evt.key, 0.0) + us / reps
    return out


_TRACE = np.dtype([("smid", "u4"), ("warpid", "u4"), ("entry", "u8"), ("staged", "u8"),
                   ("waited", "u8"), ("listed", "u8"), ("folded", "u8"), ("done", "u8"),
                   ("clocks", "u8"), ("takes", "i4"), ("lanes", "i4")])


def trace_summary(a: list[torch.Tensor]) -> dict:
    """One launch of the ``FOLD_TRACE`` build on ``a``, summarised from its
    per-warp globaltimer timeline (microseconds from the first warp's
    entry): when the warps entered, had staged the table, had the scan's
    list, took their first lanes, ended folding and exited, the lanes taken
    per SM scheduler (SM, warp slot % 4), and the SM clock the warps ran
    at.  The scan kernel before the fold kernel is not traced."""
    lib = fold_cuda.build(trace=True)
    lib.fold_lanes_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fold_lanes_trace.restype = ctypes.c_int
    fold_cuda.fold_lanes_cuda(*a, trace=True)
    warps = fold_cuda.LAST_LAUNCH["blocks"] * fold_cuda.LAST_LAUNCH["block_lanes"] // 32
    buf = np.zeros(warps, _TRACE)
    if lib.fold_lanes_trace(buf.ctypes.data, warps) != 0:
        raise RuntimeError("fold_lanes_trace failed")
    t0 = int(buf["entry"].min())

    def us(x):
        return (x.astype(np.int64) - t0) / 1e3

    folding = buf[buf["lanes"] > 0]
    sched = {}
    for w in buf:
        key = (int(w["smid"]), int(w["warpid"]) % 4)
        sched[key] = sched.get(key, 0) + int(w["lanes"])
    loads = np.array(list(sched.values()))

    def q(x):
        return {"min": float(x.min()), "median": float(np.median(x)), "max": float(x.max())} if len(x) else {}

    return {
        "warps": warps,
        "folding_warps": int(len(folding)),
        "sms": len({int(w) for w in buf["smid"]}),
        "entry_us": q(us(buf["entry"])),
        "staged_us": q(us(buf["staged"])),
        "scan_awaited_us": q(us(buf["waited"])),
        "first_take_us": q(us(folding["listed"])),
        "folded_us": q(us(folding["folded"])),
        "done_us": q(us(buf["done"])),
        "lanes_per_scheduler": q(loads) | {"schedulers": int(len(loads)), "mean": float(loads.mean())},
        # SM clocks per globaltimer ns over each warp's life: the clock it ran at
        "sm_mhz": q(1e3 * buf["clocks"] / np.maximum(buf["done"] - buf["entry"], 1)),
        "raw": {k: buf[k].tolist() for k in ("smid", "warpid", "lanes")},
    }


def _baseline_fold(source: Path):
    """A fold through the one-thread-per-lane launcher of ``source``."""
    so, _, _ = fold_cuda.compile_library(source)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fold_lanes_launch.argtypes = [p, p, p, p, ctypes.c_int64, i, i, p, p, ctypes.POINTER(i)]
    lib.fold_lanes_launch.restype = i

    def fold(seed, row, length, rh):
        out = torch.empty_like(seed)
        used = ctypes.c_int(0)
        rc = lib.fold_lanes_launch(
            seed.data_ptr(), row.data_ptr(), length.data_ptr(), rh.data_ptr(), seed.numel(),
            rh.shape[0], rh.shape[1], out.data_ptr(), torch.cuda.current_stream().cuda_stream,
            ctypes.byref(used),
        )
        if rc != 0:
            raise RuntimeError(f"baseline fold launch failed (cudaError {rc})")
        return out

    return fold


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m s2_verification_tpu_torch.foldbench")
    ap.add_argument("--baseline-source", type=Path, default=None)
    ap.add_argument("--json", default=None, help="also write the results here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("foldbench: needs a CUDA device", file=sys.stderr)
        return 2
    from .checker import device as dev_mod
    from .checker.entries import prepare
    from .collector.adversarial import adversarial_events

    print(card(), flush=True)
    clocks, sms, mhz = sm_clocks_per_s()
    with ThreadPoolExecutor() as pool:  # one nvcc per build, all at once
        builds = [pool.submit(fold_cuda.build, trace) for trace in (False, True)]
        baseline = pool.submit(_baseline_fold, args.baseline_source) if args.baseline_source else None
    lib = builds[0].result()
    builds[1].result()  # the trace build, for trace_summary
    folds = {"default": fold_cuda.fold_lanes_cuda}
    if baseline is not None:
        folds["baseline"] = baseline.result()
    print(f"build: {fold_cuda.BUILD['seconds']:.2f}s; {'; '.join(ptxas_lines(fold_cuda.BUILD['log']))}",
          flush=True)
    print(f"blocks per SM: {blocks_per_sm(lib, sms)}", flush=True)

    hist = prepare(adversarial_events(10, batch=100, seed=0))
    with recording_folds(dev_mod) as calls:
        if dev_mod.check_device_auto(hist).outcome.value != "ok":
            raise RuntimeError("adversarial k=10 did not decide OK")
    stats = [call_stats(c[2], int(c[3].shape[1])) for c in calls]
    largest = max(range(len(calls)), key=lambda j: stats[j]["steps"])
    inputs = {f"call{j + 1}": c for j, c in enumerate(calls)}
    inputs["random_shared"] = random_inputs(13, 100, 1 << 20, 0)
    inputs["random_global"] = random_inputs(4096, 128, 1 << 20, 1)
    # The shared-table lanes ordered by length: what mixing lengths in a warp costs.
    order = torch.argsort(inputs["random_shared"][2], stable=True)
    inputs["random_shared_by_length"] = [t[order] for t in inputs["random_shared"][:3]] + [
        inputs["random_shared"][3]
    ]
    inputs["one_lane"] = [torch.from_numpy(a).cuda() for a in edge_cases()["one_lane"]]
    inputs["one_lane_one_step"] = [t.clone() for t in inputs["one_lane"]]
    inputs["one_lane_one_step"][2].fill_(1)

    results: dict = {"card": card(), "sms": sms, "max_mhz": mhz, "largest_call": f"call{largest + 1}",
                     "calls": stats, "inputs": {}}
    for name, a in inputs.items():
        want = xxh3.fold_record_hashes_indexed(*a)
        b_ms, b_by = fold_bound_ms(a[2], int(a[3].shape[0]), int(a[3].shape[1]), clocks)
        row = {"bound_ms": b_ms, "bound_by": b_by, **call_stats(a[2], int(a[3].shape[1]))}
        for label, fold in folds.items():
            got = fold(*a)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"{label} differs from the plain fold on {name}")
            dev_ms, call_ms, host_ms = times(lambda: fold(*a), REPS, mhz * 1e6)
            row[label] = {"device_ms": dev_ms, "call_ms": call_ms, "host_ms": host_ms,
                          "share": b_ms / dev_ms}
        results["inputs"][name] = row
        print(
            f"{name}: lanes {row['lanes']} steps {row['steps']} bound {b_ms:.4f} ms ({b_by}); "
            + "; ".join(f"{k} {v['device_ms']:.4f}/{v['call_ms']:.4f}/{v['host_ms']:.4f} ms "
                        f"({100 * v['share']:.0f}%)" for k, v in row.items() if isinstance(v, dict)),
            flush=True,
        )
    for label in folds:
        sums = {k: sum(results["inputs"][f"call{j + 1}"][label][k] for j in range(len(calls)))
                for k in ("device_ms", "call_ms", "host_ms")}
        sums["bound_ms"] = sum(results["inputs"][f"call{j + 1}"]["bound_ms"] for j in range(len(calls)))
        results.setdefault("main_path_sum", {})[label] = sums
        print(f"main path, {len(calls)} calls, {label}: device {sums['device_ms']:.4f} ms, "
              f"per call {sums['call_ms']:.4f} ms, host {sums['host_ms']:.4f} ms, "
              f"bound {sums['bound_ms']:.4f} ms", flush=True)
    for name in ("call10", "call11", "random_shared", "random_global"):
        a = inputs.get(name)
        for label in ("default", "baseline"):
            if a is None or label not in folds:
                continue
            kt = kernel_breakdown(lambda: folds[label](*a), REPS)
            results.setdefault("kernels_us", {}).setdefault(name, {})[label] = kt
            print(f"{name}, {label}, device us per call by kernel: "
                  + ", ".join(f"{k[:60]} {v:.2f}" for k, v in sorted(kt.items(), key=lambda kv: -kv[1])),
                  flush=True)
    for name in ("call10", "call11", "random_shared", "random_global"):
        results.setdefault("trace", {})[name] = tr = trace_summary(inputs[name])
        print(f"trace {name}: {json.dumps({k: v for k, v in tr.items() if k != 'raw'})}", flush=True)
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
