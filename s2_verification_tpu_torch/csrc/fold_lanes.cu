// The chain-hash fold over frontier lanes, written by hand for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// s2_verification_tpu/ops/fold_pallas.py::fold_lanes_pallas (body
// _fold_kernel).  Per lane i:
//
//     acc = seed[i]
//     for j < clamp(length[i], 0, L):  acc = XXH3_64(le8(rh[row[i], j]), seed = acc)
//     out[i] = acc
//
// XXH3_64 here is the len == 8 seeded path only (utils/hashing.py).
//
// What bounds it.  A fold step is about 30 integer instructions on 64-bit
// words (two 64x64 multiplies, rotates, xors), 20 of them on the integer
// ALU pipe, and the steps of one lane form a serial chain.  A lane reads
// and writes 32 bytes, so the kernel is bound by integer operations.
//
// Design.  The search hands the fold many lanes of length 0 (children that
// are not candidates) mixed with lanes of the full batch length, clustered
// in some stretches of the lane range and absent from others.  One thread
// per lane would keep a warp busy until its longest lane ends, and a grid
// over all lanes would start blocks that fold nothing.  So a call runs two
// kernels:
//
// - scan_kernel lists the lanes that fold (length > 0 after the clamp) in
//   a device-wide list, one atomicAdd per block and pass of 2048 lanes,
//   keeping the lanes' order.
// - fold_kernel is launched behind it as a programmatic dependent, so that
//   its blocks start while the scan runs: a persistent grid of blocks of
//   1024 threads, SMs x the blocks the occupancy API finds resident on one
//   SM (one on an H100: at 40 or 48 registers a thread, one block takes
//   more than half the register file), so that the table is staged once
//   per SM.  Each block stages the [R, L] table in shared memory, with an
//   odd row stride so that lanes of different rows at the same step read
//   different banks (a table over the opt-in budget stays in device
//   memory and is read through the read-only cache, __ldg; any table size
//   is accepted), then waits for the scan (griddepcontrol.wait).  Warps
//   take the listed lanes 32 at a time into a queue in shared memory.
//   Only as many warps fold
//   as give each the same number of takes, so that no sparse last wave
//   runs alone; their first takes are fixed and spread over the SMs and
//   each SM's four schedulers (by the warp's slot, %warpid), later ones
//   come from a cursor (one atomicAdd per 32 lanes).  Each round, every
//   idle thread takes a queued lane and the warp runs
//   m = __reduce_min_sync(remaining) steps with no test in the loop but its
//   counter; when m is shorter than kRound (16 steps with the shared
//   table, 8 with the global one: the best of 1, 8 and 16 on an H100),
//   threads whose lanes have more steps go on up to kRound, so that lanes
//   of mixed lengths do not cut every round to a step or two.  A thread
//   whose lane is done writes the result and takes the next lane in the
//   next round.  The warps that fold nothing copy seed to out for the
//   lanes of length 0.  The last block to leave zeroes the counters for
//   the next call on the stream.
//
// So only lanes that fold occupy warp slots, and lanes of equal length
// (every active lane of the adversarial family) run in full warps with no
// divergence.  A call of at most kThreads lanes (the one-lane calls of the
// search's forced stretches) is bound by the latency of one chain: it runs
// fold_kernel alone on one block, one thread per lane, with no list or
// counters.  Lanes are independent, so the order in which warps take them
// changes no bit of the result.
//
// Interface: a plain C launcher bound with ctypes (built by nvcc alone, no
// PyTorch headers).  Tensors are int64 on the torch side and are read as
// uint64_t bit patterns.  The launcher runs on the caller's stream, does
// not synchronise, allocates nothing (the wrapper passes the lane list and
// the counters), and returns the cudaError_t of the launches.
// Built with -DFOLD_TRACE (a diagnostic build, ops/fold_cuda.py's
// build(trace=True)), fold_kernel also records a per-warp timeline that
// python -m s2_verification_tpu_torch.foldbench reads.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// __ldg has overloads for (unsigned) long long on every platform.
using u64 = unsigned long long;
using i64 = long long;

constexpr uint64_t kBitflip = 0x1CAD21F72C81017CULL ^ 0xDB979083E96DD4DEULL;
constexpr uint64_t kPrime = 0x9FB21C651E98DF25ULL;
constexpr int kThreads = 1024;     // threads per fold_kernel block
constexpr int kWarps = kThreads / 32;
constexpr int kStageCells = 8;     // table cells per thread and staging pass
constexpr int kCopyLanes = 256;    // lanes per copy chunk
constexpr int kQueue = 64;         // < 32 waiting + one 32-lane take
constexpr int kScanThreads = 256;  // scan_kernel
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kScanLanes = 8;      // lanes per thread and scan pass
constexpr int kScanBlocks = 1024;  // at most; a block then scans more than one pass
// The least steps a round runs while its lanes last, by table variant.
template <bool kShared>
constexpr unsigned kRound = kShared ? 16 : 8;
constexpr unsigned kFull = 0xffffffffu;

// counters[]: lanes listed, the take cursor, fold blocks gone, each on a
// 128-byte line of its own (kLine int32 apart).  Zero before a call; the
// last fold block to leave zeroes them again.
constexpr int kLine = 32;
enum { kListed = 0, kCursor = kLine, kGone = 2 * kLine, kCounters = 3 * kLine };

struct Queue {
  u64 seed[kQueue];
  int lane[kQueue];
  int off[kQueue];  // row * table stride
  int len[kQueue];  // clamped to [1, L]
};

#ifdef FOLD_TRACE
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Per-warp timeline of the last multi-block launch (a diagnostic build:
// foldbench reads it with fold_lanes_trace).
struct WarpTrace {
  unsigned smid, warpid;
  unsigned long long entry, staged, waited, listed, folded, done, clocks;
  int takes, lanes;
};
constexpr int kTraceWarps = 1 << 16;
__device__ WarpTrace g_trace[kTraceWarps];
#endif

__device__ __forceinline__ uint64_t rotl64(uint64_t h, int k) {
  return (h << k) | (h >> (64 - k));
}

__device__ __forceinline__ uint64_t chain_hash(uint64_t seed, uint64_t value) {
  const uint32_t lo = static_cast<uint32_t>(seed);
  seed ^= static_cast<uint64_t>(__byte_perm(lo, 0, 0x0123)) << 32;
  uint64_t h = rotl64(value, 32) ^ (kBitflip - seed);
  h ^= rotl64(h, 49) ^ rotl64(h, 24);
  h *= kPrime;
  h ^= (h >> 35) + 8;
  h *= kPrime;
  return h ^ (h >> 28);
}

__device__ __forceinline__ int steps_of(const i64* __restrict__ length, i64 i, int l) {
  const i64 raw = __ldg(length + i);
  return raw < 0 ? 0 : (raw > l ? l : static_cast<int>(raw));
}

// `steps` chain steps from p[0] on: p points into the shared-memory table
// or, for the global variant, into rh.
template <bool kShared>
__device__ __forceinline__ u64 fold_steps(u64 acc, const u64* p, unsigned steps) {
#pragma unroll 4
  for (unsigned j = 0; j < steps; ++j) acc = chain_hash(acc, kShared ? p[j] : __ldg(p + j));
  return acc;
}

// The scan: each block lists the lanes of its share of [0, n) that fold
// in `list`, one atomicAdd on counters[kListed] per pass of
// kScanThreads * kScanLanes lanes.  It lets the fold kernel launch at once
// (programmatic dependent launch), so that the fold blocks stage their
// tables while it runs.
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(const i64* __restrict__ length, int n, int l, int* __restrict__ list,
                int* __restrict__ counters) {
  asm volatile("griddepcontrol.launch_dependents;");
  // base[k][w]: where warp w's listed lanes of sub-pass k start.  The list
  // keeps the lanes' order, so that each warp's stores are contiguous.
  __shared__ int base[kScanLanes][kScanWarps];
  __shared__ int block_base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1;
  const i64 share = (static_cast<i64>(n) + gridDim.x - 1) / gridDim.x;
  const i64 begin = blockIdx.x * share;
  const i64 end = begin + share < n ? begin + share : n;
  for (i64 pass = begin; pass < end; pass += kScanThreads * kScanLanes) {
    i64 raw[kScanLanes];  // loads first, so that a pass keeps kScanLanes in flight
#pragma unroll
    for (int k = 0; k < kScanLanes; ++k) {
      const i64 i = pass + static_cast<i64>(k) * kScanThreads + threadIdx.x;
      raw[k] = i < end ? __ldg(length + i) : 0;
    }
    unsigned act[kScanLanes];
#pragma unroll
    for (int k = 0; k < kScanLanes; ++k) {
      act[k] = __ballot_sync(kFull, raw[k] > 0 && l > 0);
      if (lane == 0) base[k][warp] = __popc(act[k]);
    }
    __syncthreads();
    if (warp == 0) {
      // Exclusive prefix over the kScanLanes * kScanWarps counts, k-major, two
      // per lane, and one atomicAdd for the pass.
      static_assert(kScanLanes * kScanWarps == 64, "two counts per lane");
      int* flat = &base[0][0];
      const int c0 = flat[2 * lane], c1 = flat[2 * lane + 1];
      int incl = c0 + c1;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += v;
      }
      int start = 0;
      if (lane == 31) start = incl > 0 ? atomicAdd(counters + kListed, incl) : 0;
      start = __shfl_sync(kFull, start, 31);
      flat[2 * lane] = start + incl - c0 - c1;
      flat[2 * lane + 1] = start + incl - c1;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kScanLanes; ++k) {
      if (act[k] >> lane & 1) {
        list[base[k][warp] + __popc(act[k] & below)] =
            static_cast<int>(pass + static_cast<i64>(k) * kScanThreads + threadIdx.x);
      }
    }
    __syncthreads();  // base is reused by the next pass
  }
}

// This warp's place in its block's order of the first sweep.  An SM's
// four schedulers each run the warps of one slot class (%warpid % 4).  The
// key of slot s, in aligned group g = s / 8 of eight slots (two per
// class), is ((s % 4 - g) & 3) + 4 * ((s / 4) & 1): the warps of equal key
// lie on different classes, one per group, so each run of four ranks
// falls on all four schedulers when the block's slots are contiguous.
// Computed as a rank over the block's warps, so it is a permutation of
// 0..kWarps-1 whatever the slots.
__device__ int sweep_rank() {
  __shared__ int key[kWarps];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    unsigned slot;
    asm volatile("mov.u32 %0, %%warpid;" : "=r"(slot));
    key[warp] = ((static_cast<int>(slot % 4) - static_cast<int>(slot / 8)) & 3) + 4 * ((slot / 4) & 1);
  }
  __syncthreads();
  int rank = 0;
  for (int w = 0; w < kWarps; ++w) rank += key[w] < key[warp] || (key[w] == key[warp] && w < warp);
  return rank;
}

// With `list` null, one block holds every lane (n <= kThreads) and each
// thread folds one; otherwise the persistent grid of the design notes,
// launched right behind scan_kernel with `list` and `counters` as it
// leaves them.
template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
    fold_kernel(const u64* __restrict__ seed, const i64* __restrict__ row,
                const i64* __restrict__ length, const u64* __restrict__ rh, int n, int r,
                int l, int stride, u64* __restrict__ out, int* list, int* counters) {
  extern __shared__ u64 tab[];
  __shared__ Queue queues[kWarps];
#ifdef FOLD_TRACE
  const unsigned long long t_entry = now_ns();
  const long long c_entry = clock64();
#endif
  // Phase 1: stage the table (while the scan kernel runs), then wait for
  // the scan's list.
  const int rank = list != nullptr ? sweep_rank() : 0;
  if constexpr (kShared) {
    // Loads first, stores after, so that a pass keeps kStageCells loads in
    // flight.  Each block starts at another 128-byte line of the table, so
    // that the grid's first reads spread over the L2 slices that hold it.
    const int cells = r * l;
    const int rot = static_cast<int>((blockIdx.x * 97ULL * 16) % cells);
    for (int j0 = threadIdx.x; j0 < cells; j0 += kThreads * kStageCells) {
      u64 v[kStageCells];
      int at[kStageCells];
#pragma unroll
      for (int k = 0; k < kStageCells; ++k) {
        const int j = j0 + k * kThreads;
        at[k] = j + rot < cells ? j + rot : j + rot - cells;
        v[k] = j < cells ? __ldg(rh + at[k]) : 0;
      }
#pragma unroll
      for (int k = 0; k < kStageCells; ++k) {
        if (j0 + k * kThreads < cells) tab[(at[k] / l) * stride + at[k] % l] = v[k];
      }
    }
  }
  __syncthreads();
  if (list == nullptr) {
    const int i = threadIdx.x;
    if (i < n) {
      const u64* p = (kShared ? tab : rh) + static_cast<int>(__ldg(row + i)) * stride;
      out[i] = fold_steps<kShared>(__ldg(seed + i), p, steps_of(length, i, l));
    }
    return;
  }
#ifdef FOLD_TRACE
  const unsigned long long t_staged = now_ns();
#endif
  asm volatile("griddepcontrol.wait;" ::: "memory");
  // The list (written by other SMs: read past L1) and the count, side by
  // side: the first take's entries are read before the count bounds them.
  const int count = __ldcg(counters + kListed);
  const i64 first_entry = static_cast<i64>(rank * gridDim.x + blockIdx.x) * 32 + (threadIdx.x & 31);
  const int first_lane = first_entry < n ? __ldcg(list + first_entry) : 0;
#ifdef FOLD_TRACE
  const unsigned long long t_waited = now_ns();
#endif

  // Phase 2: takes of 32 listed lanes.  The first sweep is static and
  // spreads over the blocks before it fills any block's warps; the rest
  // come from the cursor, so warps that finish early take more.
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const int warp = threadIdx.x >> 5;
  // Takes in all, and the warps that fold: as many as give each the same
  // number of takes, so that no sparse last wave of takes runs alone.
  const int takes_all = (count + 31) / 32;
  const int grid_warps = kWarps * gridDim.x;
  const int per_warp = (takes_all + grid_warps - 1) / grid_warps;
  const int warps = per_warp > 0 ? (takes_all + per_warp - 1) / per_warp : 0;
  const int first = rank * gridDim.x + blockIdx.x;
  bool swept = false;
#ifdef FOLD_TRACE
  unsigned long long t_listed = 0;
  int takes = 0, lanes = 0;
#endif

  Queue& q = queues[warp];
  int queued = 0;    // warp-uniform
  bool more = true;  // warp-uniform
  int me = 0, off = 0;
  unsigned rem = 0;  // steps left of this thread's lane, 0 when idle
  u64 acc = 0;
  while (true) {
    const unsigned idle = __ballot_sync(kFull, rem == 0);
    const int need = __popc(idle);
    while (more && queued < need) {
      int take = first < warps ? first : takes_all;
      if (swept) {
        if (lane == 0) take = warps + atomicAdd(counters + kCursor, 1);
        take = __shfl_sync(kFull, take, 0);
      }
      const i64 start = static_cast<i64>(take) * 32;
      if (start >= count) {
        more = false;
        break;
      }
      const int got = count - start < 32 ? static_cast<int>(count - start) : 32;
      if (lane < got) {
        const int i = swept ? __ldcg(list + start + lane) : first_lane;
        const int slot = queued + lane;
        q.seed[slot] = __ldg(seed + i);
        q.lane[slot] = i;
        q.off[slot] = static_cast<int>(__ldg(row + i)) * stride;
        q.len[slot] = steps_of(length, i, l);
      }
      queued += got;
      swept = true;
#ifdef FOLD_TRACE
      if (takes++ == 0) t_listed = now_ns();
      lanes += got;
#endif
    }
    __syncwarp();
    if (need == 32 && queued == 0) break;  // all idle, no lanes left
    if (rem == 0) {
      const int k = __popc(idle & below);
      if (k < queued) {
        const int slot = queued - 1 - k;
        me = q.lane[slot];
        acc = q.seed[slot];
        off = q.off[slot];
        rem = static_cast<unsigned>(q.len[slot]);
      }
    }
    queued -= queued < need ? queued : need;
    __syncwarp();

    const unsigned m = __reduce_min_sync(kFull, rem > 0 ? rem : UINT_MAX);
    if (rem > 0) {
      // The round's m steps are common to every busy thread; then each
      // goes on alone up to kRound steps or its lane's end.
      constexpr unsigned least = kRound<kShared>;
      const unsigned run = m < least ? (rem < least ? rem : least) : m;
      const u64* p = (kShared ? tab : rh) + off;
      acc = fold_steps<kShared>(acc, p, m);
      acc = fold_steps<kShared>(acc, p + m, run - m);
      off += static_cast<int>(run);
      rem -= run;
      if (rem == 0) out[me] = acc;
    }
  }
#ifdef FOLD_TRACE
  const unsigned long long t_folded = now_ns();
#endif

  // Phase 3: the lanes that do not fold keep their seed.  The chunks go to
  // the warps that fold nothing, or to all warps when all fold.
  const int copiers = warps < grid_warps ? grid_warps - warps : grid_warps;
  for (i64 c = warps < grid_warps ? first - warps : first; c >= 0 && c * kCopyLanes < n;
       c += copiers) {
#pragma unroll
    for (int k = lane; k < kCopyLanes; k += 32) {
      const i64 i = c * kCopyLanes + k;
      if (i < n && steps_of(length, i, l) == 0) out[i] = __ldg(seed + i);
    }
  }
#ifdef FOLD_TRACE
  const int t = blockIdx.x * kWarps + warp;
  if (lane == 0 && t < kTraceWarps) {
    WarpTrace w;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(w.smid));
    asm volatile("mov.u32 %0, %%warpid;" : "=r"(w.warpid));
    w.entry = t_entry;
    w.staged = t_staged;
    w.waited = t_waited;
    w.listed = t_listed;
    w.folded = t_folded;
    w.done = now_ns();
    w.clocks = clock64() - c_entry;
    w.takes = takes;
    w.lanes = lanes;
    g_trace[t] = w;
  }
#endif
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(counters + kGone, 1) == static_cast<int>(gridDim.x) - 1) {
    for (int k = 0; k < kCounters; k += kLine) counters[k] = 0;
    __threadfence();
  }
}

}  // namespace

extern "C" {

// The number of int32 counters fold_lanes_launch takes.
int fold_lanes_counters() { return kCounters; }

// The launch plan for an [r, l] table on the current device: *shared is 1
// when the table is staged in shared memory (row stride *stride, odd), else
// 0 (stride l); *grid_cap is the persistent grid, SMs x the blocks that
// cudaOccupancyMaxActiveBlocksPerMultiprocessor finds resident on one SM;
// *block_lanes is kThreads: a call of at most that many lanes runs on one
// block.
int fold_lanes_plan(int r, int l, int* shared, int* stride, int* grid_cap, int* block_lanes) {
  int dev = 0, sms = 0, smem_optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fold_kernel<true>);
  if (err != cudaSuccess) return err;
  // The scan and the shared-table fold prefer one shared-memory carveout,
  // so that the SMs need not change it between the scan and the fold it
  // launches early (a change drains the SM: it cost each call 10-40 us on
  // an H100).  The global-table fold prefers the most L1, which caches its
  // table reads.
  const struct {
    const void* fn;
    int carveout;
  } prefs[] = {{reinterpret_cast<const void*>(scan_kernel), cudaSharedmemCarveoutMaxShared},
               {reinterpret_cast<const void*>(fold_kernel<true>), cudaSharedmemCarveoutMaxShared},
               {reinterpret_cast<const void*>(fold_kernel<false>), cudaSharedmemCarveoutMaxL1}};
  for (const auto& p : prefs) {
    err = cudaFuncSetAttribute(p.fn, cudaFuncAttributePreferredSharedMemoryCarveout, p.carveout);
    if (err != cudaSuccess) return err;
  }
  const int odd = l | 1;
  const size_t table_bytes = static_cast<size_t>(r) * odd * sizeof(u64);
  // What the block's static shared memory (the queues) leaves of the
  // opt-in budget.
  const size_t budget = static_cast<size_t>(smem_optin) - attr.sharedSizeBytes;
  *shared = table_bytes <= budget;
  if (*shared) {
    *stride = odd;
    err = cudaFuncSetAttribute(fold_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(budget));
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fold_kernel<true>, kThreads,
                                                        table_bytes);
  } else {
    *stride = l;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fold_kernel<false>, kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid_cap = sms * per_sm;
  *block_lanes = kThreads;
  return cudaSuccess;
}

// Launch the fold over n lanes with the plan's shared and stride: the fold
// kernel on one block when blocks == 1 (then n <= kThreads, and list and
// counters may be null), else the scan kernel on min(ceil(n / 2048),
// kScanBlocks) blocks and the fold kernel on `blocks` blocks (at most the
// plan's grid_cap) as its programmatic dependent, with `list` room for n
// int32 and `counters` the fold_lanes_counters() int32 of this stream,
// zero.
int fold_lanes_launch(const void* seed, const void* row, const void* length,
                      const void* rh, int n, int r, int l, int stride, int shared,
                      void* out, void* list, void* counters, int blocks, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (blocks < 1 || (blocks == 1 && n > kThreads) ||
      (blocks > 1 && (list == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* sp = static_cast<const u64*>(seed);
  const auto* rp = static_cast<const i64*>(row);
  const auto* lp = static_cast<const i64*>(length);
  const auto* tp = static_cast<const u64*>(rh);
  auto* op = static_cast<u64*>(out);
  int* lst = blocks > 1 ? static_cast<int*>(list) : nullptr;
  int* ctr = blocks > 1 ? static_cast<int*>(counters) : nullptr;
  void* args[] = {&sp, &rp, &lp, &tp, &n, &r, &l, &stride, &op, &lst, &ctr};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = shared ? static_cast<size_t>(r) * stride * sizeof(u64) : 0;
  cfg.stream = s;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  if (blocks > 1) {
    const int passes = (n + kScanThreads * kScanLanes - 1) / (kScanThreads * kScanLanes);
    scan_kernel<<<passes < kScanBlocks ? passes : kScanBlocks, kScanThreads, 0, s>>>(lp, n, l, lst, ctr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    cfg.attrs = pdl;
    cfg.numAttrs = 1;
  }
  const void* fn = shared ? reinterpret_cast<const void*>(fold_kernel<true>)
                          : reinterpret_cast<const void*>(fold_kernel<false>);
  return cudaLaunchKernelExC(&cfg, fn, args);
}

#ifdef FOLD_TRACE
// Copies the timelines of the first `warps` warps of the last multi-block
// launch (blockIdx.x * kWarps + warp) to host memory: per warp the SM, the warp
// slot, globaltimer ns at entry, table staged, the scan's list awaited,
// first take, end of folding and exit, the SM clocks from entry to exit,
// the takes and the lanes taken.
int fold_lanes_trace(void* dst, int warps) {
  if (warps > kTraceWarps) warps = kTraceWarps;
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return err;
  return cudaMemcpyFromSymbol(dst, g_trace, sizeof(WarpTrace) * warps);
}
#endif

const char* fold_lanes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
