// Native Wing–Gong linearizability checker for the S2 stream model.
//
// The reference's checking path is native (Go: golang/s2-porcupine/main.go
// driving the compiled porcupine library, go.mod:6); this is the framework's
// native-speed CPU engine, the C++ twin of checker/oracle.py:
//
//   - entries: the call/return events on a doubly-linked list
//     (oracle.py:_build_entry_list), lift/unlift in LIFO order;
//   - at each call entry, apply the powerset-lifted nondeterministic step
//     (models/stream.py:step_set; reference main.go:264-335) to the current
//     candidate state set; commit if non-empty and the (linearized-bitset,
//     state-set) pair is unseen (Lowe's memoization);
//   - a return of an unlinearized op, or falling off the list, backtracks.
//
// The chain-hash fold uses the same len==8 XXH3-64-with-seed specialization
// as ops/xxh3.py, bit-exact with the xxhash C library (pinned vectors:
// reference history.rs:687-696, main_test.go:15-32).
//
// Exposed as a C ABI consumed from Python via ctypes (checker/native.py).

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

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

struct State {
  uint32_t tail;
  uint64_t hash;
  int32_t tok;  // interned fencing token id; 0 = none

  bool operator==(const State& o) const {
    return tail == o.tail && hash == o.hash && tok == o.tok;
  }
  bool operator<(const State& o) const {
    if (tail != o.tail) return tail < o.tail;
    if (hash != o.hash) return hash < o.hash;
    return tok < o.tok;
  }
};

struct Ops {
  int32_t n;
  const int32_t* op_type;
  const uint8_t* has_set_token;
  const int32_t* set_token;
  const uint8_t* has_batch_token;
  const int32_t* batch_token;
  const uint8_t* has_match;
  const uint32_t* match_seq;
  const uint32_t* num_records;
  const int32_t* rh_row;
  const int32_t* rh_len;
  int32_t rh_width;
  const uint32_t* rh_hi;
  const uint32_t* rh_lo;
  const uint8_t* out_failure;
  const uint8_t* out_definite;
  const uint32_t* out_tail;
  const uint8_t* out_has_hash;
  const uint64_t* out_hash;
};

uint64_t fold_row(const Ops& ops, int32_t j, uint64_t acc) {
  const int32_t row = ops.rh_row[j];
  const int32_t len = ops.rh_len[j];
  const uint32_t* hi = ops.rh_hi + static_cast<int64_t>(row) * ops.rh_width;
  const uint32_t* lo = ops.rh_lo + static_cast<int64_t>(row) * ops.rh_width;
  for (int32_t i = 0; i < len; ++i) {
    uint64_t rh = (static_cast<uint64_t>(hi[i]) << 32) | lo[i];
    acc = xxh3_8byte_seeded(rh, acc);
  }
  return acc;
}

// models/stream.py:step — writes 0..2 successors of `s` under op j.
// The chain-hash fold (the expensive part) only runs on branches that
// actually materialize the optimistic state.
int step_one(const Ops& ops, int32_t j, const State& s, State out[2]) {
  if (ops.op_type[j] == 0) {  // append
    const bool fail = ops.out_failure[j];
    const bool definite = ops.out_definite[j];
    if (fail && definite) {
      out[0] = s;
      return 1;
    }
    const bool tok_mismatch =
        ops.has_batch_token[j] && (s.tok == 0 || ops.batch_token[j] != s.tok);
    const bool seq_mismatch = ops.has_match[j] && ops.match_seq[j] != s.tail;
    const uint32_t opt_tail = s.tail + ops.num_records[j];
    const int32_t opt_tok =
        ops.has_set_token[j] ? ops.set_token[j] : s.tok;
    if (fail) {  // indefinite
      if (tok_mismatch || seq_mismatch) {
        out[0] = s;
        return 1;
      }
      out[0] = State{opt_tail, fold_row(ops, j, s.hash), opt_tok};
      out[1] = s;
      return 2;
    }
    // success
    if (tok_mismatch || seq_mismatch) return 0;
    if (ops.out_tail[j] != opt_tail) return 0;
    out[0] = State{opt_tail, fold_row(ops, j, s.hash), opt_tok};
    return 1;
  }
  // read / check-tail
  if (ops.out_has_hash[j] && s.hash != ops.out_hash[j]) return 0;
  if (ops.out_failure[j] || s.tail == ops.out_tail[j]) {
    out[0] = s;
    return 1;
  }
  return 0;
}

// step_set: powerset lifting, deduped, order-preserving.
std::vector<State> step_set(const Ops& ops, int32_t j,
                            const std::vector<State>& states) {
  std::vector<State> result;
  result.reserve(states.size() + 1);
  State buf[2];
  for (const State& s : states) {
    int k = step_one(ops, j, s, buf);
    for (int i = 0; i < k; ++i) {
      bool seen = false;
      for (const State& r : result)
        if (r == buf[i]) {
          seen = true;
          break;
        }
      if (!seen) result.push_back(buf[i]);
    }
  }
  return result;
}

struct CacheKey {
  std::vector<uint64_t> bits;
  std::vector<State> states;  // sorted

  bool operator==(const CacheKey& o) const {
    return bits == o.bits && states == o.states;
  }
};

uint64_t mix64(uint64_t h, uint64_t v) {
  h ^= v + 0x9E3779B97F4A7C15ULL + (h << 6) + (h >> 2);
  return h;
}

uint64_t key_hash(const CacheKey& k) {
  uint64_t h = 0xCBF29CE484222325ULL;
  for (uint64_t w : k.bits) h = mix64(h, w);
  for (const State& s : k.states) {
    h = mix64(h, s.tail);
    h = mix64(h, s.hash);
    h = mix64(h, static_cast<uint64_t>(static_cast<uint32_t>(s.tok)));
  }
  return h;
}

struct Entry {
  int32_t op;      // op index
  bool is_call;
  int32_t match;   // index of the paired entry
  int32_t prev;    // linked-list neighbor entry indices; -1 = none
  int32_t next;
};

}  // namespace

extern "C" {

// Returns 0 OK, 1 ILLEGAL, 2 UNKNOWN (time budget exhausted).
// out_order[0..*out_order_len) receives the linearization (encoded op
// indices) when OK, or the deepest linearized set reached when not.
// out_states_* receive the final candidate states when OK: *out_states_len
// is the FULL set size; only min(size, out_states_cap) entries are written
// (the caller re-invokes with a larger buffer on truncation).
//
// app_rank / inert carry the verdict-exact commutativity prunes
// (checker/prune.py); both may be null (no pruning).  app_rank[j] >= 0
// gives op j's dense position in the statically-forced successful-append
// order (-1 = unranked): ranked calls are gated until exactly their turn,
// since any other order provably never accepts.  inert[j] marks identity
// ops: once an inert op's subtree at a position is exhausted, its DFS
// siblings are skipped (sleep-set style) — any accepting order through a
// sibling reorders to commit the identity op first, which already failed.
int32_t s2_check(
    int32_t n_ops, const int32_t* op_type, const uint8_t* has_set_token,
    const int32_t* set_token, const uint8_t* has_batch_token,
    const int32_t* batch_token, const uint8_t* has_match,
    const uint32_t* match_seq, const uint32_t* num_records,
    const int32_t* rh_row, const int32_t* rh_len, int32_t rh_width,
    const uint32_t* rh_hi, const uint32_t* rh_lo, const uint8_t* out_failure,
    const uint8_t* out_definite, const uint32_t* out_tail,
    const uint8_t* out_has_hash, const uint64_t* out_hash,
    const int32_t* call_time, const int32_t* ret_time,
    const int32_t* app_rank, const uint8_t* inert, int32_t n_init,
    const uint32_t* init_tail, const uint64_t* init_hash,
    const int32_t* init_tok, double time_budget_s, int32_t* out_order,
    int32_t* out_order_len, uint32_t* out_states_tail,
    uint64_t* out_states_hash, int32_t* out_states_tok,
    int32_t out_states_cap, int32_t* out_states_len, int64_t* out_steps,
    int64_t* out_cache_hits) {
  Ops ops{n_ops,    op_type,  has_set_token, set_token, has_batch_token,
          batch_token, has_match, match_seq, num_records, rh_row,
          rh_len,   rh_width, rh_hi,         rh_lo,     out_failure,
          out_definite, out_tail, out_has_hash, out_hash};

  *out_order_len = 0;
  *out_states_len = 0;
  *out_steps = 0;
  *out_cache_hits = 0;
  std::vector<State> states;
  for (int32_t i = 0; i < n_init; ++i)
    states.push_back(State{init_tail[i], init_hash[i], init_tok[i]});
  if (n_ops == 0) {
    int32_t m = std::min<int32_t>(n_init, out_states_cap);
    for (int32_t i = 0; i < m; ++i) {
      out_states_tail[i] = states[i].tail;
      out_states_hash[i] = states[i].hash;
      out_states_tok[i] = states[i].tok;
    }
    *out_states_len = n_init;
    return 0;
  }

  // Entry list sorted by event time; pending returns (INT32_MAX) sink last.
  std::vector<Entry> entries(2 * n_ops);
  std::vector<std::pair<int64_t, int32_t>> order_idx(2 * n_ops);
  for (int32_t j = 0; j < n_ops; ++j) {
    entries[2 * j] = Entry{j, true, 2 * j + 1, -1, -1};
    entries[2 * j + 1] = Entry{j, false, 2 * j, -1, -1};
    // Tie-break on entry id keeps the sort deterministic for the
    // all-equal INT32_MAX pending returns.
    order_idx[2 * j] = {(static_cast<int64_t>(call_time[j]) << 32) | (2 * j),
                        2 * j};
    order_idx[2 * j + 1] = {
        (static_cast<int64_t>(ret_time[j]) << 32) | (2 * j + 1), 2 * j + 1};
  }
  std::sort(order_idx.begin(), order_idx.end());
  int32_t head = order_idx[0].second;
  for (size_t i = 0; i + 1 < order_idx.size(); ++i) {
    entries[order_idx[i].second].next = order_idx[i + 1].second;
    entries[order_idx[i + 1].second].prev = order_idx[i].second;
  }

  const int32_t n_words = (n_ops + 63) / 64;
  std::vector<uint64_t> bits(n_words, 0);
  // Deepest linearized set reached, for failure diagnostics (oracle.py's
  // `best`): reported through out_order on ILLEGAL/UNKNOWN.
  std::vector<uint64_t> best_bits(n_words, 0);
  size_t best_count = 0;

  std::unordered_map<uint64_t, std::vector<CacheKey>> cache;
  {
    CacheKey k0{bits, states};
    std::sort(k0.states.begin(), k0.states.end());
    cache[key_hash(k0)].push_back(std::move(k0));
  }

  struct Undo {
    int32_t call_entry;
    std::vector<State> saved_states;
  };
  std::vector<Undo> calls;
  calls.reserve(n_ops);

  // Ranked successful appends committed so far: the next one to commit
  // must be exactly rank `next_rank` (ranks are dense over the history).
  int32_t next_rank = 0;

  int64_t steps = 0, cache_hits = 0;
  const bool budgeted = time_budget_s > 0;
  const auto deadline = std::chrono::steady_clock::now() +
                        std::chrono::duration_cast<std::chrono::steady_clock::duration>(
                            std::chrono::duration<double>(time_budget_s));

  auto lift = [&](int32_t ce) {
    const Entry& c = entries[ce];
    int32_t re = c.match;
    const Entry& r = entries[re];
    if (c.prev >= 0) entries[c.prev].next = c.next;
    if (c.next >= 0) entries[c.next].prev = c.prev;
    if (head == ce) head = c.next;
    if (r.prev >= 0) entries[r.prev].next = r.next;
    if (r.next >= 0) entries[r.next].prev = r.prev;
    if (head == re) head = r.next;  // unreachable: call precedes return
  };
  auto unlift = [&](int32_t ce) {
    Entry& c = entries[ce];
    int32_t re = c.match;
    Entry& r = entries[re];
    if (r.prev >= 0) entries[r.prev].next = re;
    if (r.next >= 0) entries[r.next].prev = re;
    if (c.prev >= 0) entries[c.prev].next = ce;
    else head = ce;
    if (c.next >= 0) entries[c.next].prev = ce;
  };
  auto finish_stats = [&]() {
    *out_steps = steps;
    *out_cache_hits = cache_hits;
  };
  auto emit_deepest = [&]() {
    int32_t k = 0;
    for (int32_t j = 0; j < n_ops; ++j)
      if (best_bits[j >> 6] & (1ULL << (j & 63))) out_order[k++] = j;
    *out_order_len = k;
  };

  int32_t entry = head;
  while (head >= 0) {
    if (budgeted && (steps & 1023) == 0 &&
        std::chrono::steady_clock::now() > deadline) {
      finish_stats();
        emit_deepest();
      return 2;
    }
    if (entry < 0) {
      // Fell off the end: every remaining entry was an unlinearizable call.
      if (calls.empty()) {
        finish_stats();
        emit_deepest();
        return 1;
      }
      Undo u = std::move(calls.back());
      calls.pop_back();
      int32_t j = entries[u.call_entry].op;
      bits[j >> 6] &= ~(1ULL << (j & 63));
      if (app_rank && app_rank[j] >= 0) --next_rank;
      states = std::move(u.saved_states);
      unlift(u.call_entry);
      // Inert-forced backtrack: siblings of an exhausted identity op are
      // redundant (see the ABI comment) — pop straight through.
      entry = (inert && inert[j]) ? -1 : entries[u.call_entry].next;
      continue;
    }
    Entry& e = entries[entry];
    if (e.is_call) {
      int32_t j = e.op;
      if (app_rank && app_rank[j] >= 0 && app_rank[j] != next_rank) {
        // Out-of-turn ranked append: no accepting linearization commits
        // it here (successful-append tails are monotone) — skip.
        entry = e.next;
        continue;
      }
      ++steps;
      std::vector<State> ns = step_set(ops, j, states);
      if (!ns.empty()) {
        bits[j >> 6] |= 1ULL << (j & 63);
        CacheKey key{bits, ns};
        std::sort(key.states.begin(), key.states.end());
        uint64_t h = key_hash(key);
        auto& bucket = cache[h];
        bool seen = false;
        for (const CacheKey& k : bucket)
          if (k == key) {
            seen = true;
            break;
          }
        if (!seen) {
          bucket.push_back(std::move(key));
          calls.push_back(Undo{entry, std::move(states)});
          states = std::move(ns);
          if (app_rank && app_rank[j] >= 0) ++next_rank;
          lift(entry);
          if (calls.size() > best_count) {
            best_count = calls.size();
            best_bits = bits;
          }
          entry = head;
          continue;
        }
        ++cache_hits;
        bits[j >> 6] &= ~(1ULL << (j & 63));
      }
      entry = e.next;
    } else {
      // Return of an unlinearized op: must backtrack.
      if (calls.empty()) {
        finish_stats();
        emit_deepest();
        return 1;
      }
      Undo u = std::move(calls.back());
      calls.pop_back();
      int32_t j = entries[u.call_entry].op;
      bits[j >> 6] &= ~(1ULL << (j & 63));
      if (app_rank && app_rank[j] >= 0) --next_rank;
      states = std::move(u.saved_states);
      unlift(u.call_entry);
      entry = (inert && inert[j]) ? -1 : entries[u.call_entry].next;
    }
  }

  for (size_t i = 0; i < calls.size(); ++i)
    out_order[i] = entries[calls[i].call_entry].op;
  *out_order_len = static_cast<int32_t>(calls.size());
  std::sort(states.begin(), states.end());
  int32_t m = std::min<int32_t>(static_cast<int32_t>(states.size()),
                                out_states_cap);
  for (int32_t i = 0; i < m; ++i) {
    out_states_tail[i] = states[i].tail;
    out_states_hash[i] = states[i].hash;
    out_states_tok[i] = states[i].tok;
  }
  // Report the FULL size (not the clamped write count) so the caller can
  // detect truncation and re-invoke with a larger buffer.
  *out_states_len = static_cast<int32_t>(states.size());
  *out_steps = steps;
  *out_cache_hits = cache_hits;
  return 0;
}

}  // extern "C"
