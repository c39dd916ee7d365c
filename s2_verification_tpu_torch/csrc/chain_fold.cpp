// The host's chain-hash fold in native code: the left fold of
// acc = XXH3-64(le_bytes(rh[i]), seed = acc) over a batch of record hashes,
// as utils/hashing.py::fold_record_hashes computes it on Python ints.
//
// The XXH3-64 len == 8 code path is csrc/s2check.cpp's, bit-exact with the
// xxhash C library (pinned vectors: reference history.rs:687-696,
// main_test.go:15-32).
//
// Exposed as a C ABI consumed from Python via ctypes (utils/hashing.py).

#include <cstdint>

namespace {

constexpr uint64_t kBitflipBase = 0x1CAD21F72C81017CULL ^ 0xDB979083E96DD4DEULL;
constexpr uint64_t kPrimeMX2 = 0x9FB21C651E98DF25ULL;

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

// XXH3-64(le_bytes(value), seed), len==8 code path.
inline uint64_t xxh3_8byte_seeded(uint64_t value, uint64_t seed) {
  seed ^= static_cast<uint64_t>(__builtin_bswap32(static_cast<uint32_t>(seed)))
          << 32;
  uint64_t input64 = (value << 32) | (value >> 32);
  uint64_t h = input64 ^ (kBitflipBase - seed);
  h ^= rotl64(h, 49) ^ rotl64(h, 24);
  h *= kPrimeMX2;
  h ^= (h >> 35) + 8;  // + input length
  h *= kPrimeMX2;
  h ^= h >> 28;
  return h;
}

}  // namespace

extern "C" uint64_t s2_chain_fold(uint64_t acc, const uint64_t* rh, int64_t n) {
  for (int64_t i = 0; i < n; ++i) acc = xxh3_8byte_seeded(rh[i], acc);
  return acc;
}
