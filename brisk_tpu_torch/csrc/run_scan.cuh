// Arithmetic of the segmented run scan (run_scan.cu): the query join's
// per-slot run flag and contribution, the run aggregate that the three
// passes combine, and a lane's running sum inside a group of slots that a
// warp takes at once. Every function is __host__ __device__, so a host
// compiler builds this header too (with plain C++ definitions of the CUDA
// qualifiers): tests/test_torch_run_scan.py replays the kernels' three
// passes with it through tests/run_scan_host.cpp and holds them to
// index.sklstore._join_scan_torch and index.store._run_totals_torch.
//
// Sums are u32 and wrap: the join keeps a run's sum mod 256 and compact
// its total mod 2^32 (the plain versions' int64 differences, masked), and
// both moduli divide 2^32.

#pragma once

#include <cstdint>

#ifndef BRISK_HD
#define BRISK_HD __host__ __device__ __forceinline__
#endif

namespace brisk {

constexpr int kJoinParts = 256;  // the join's partial sums
constexpr int kMaxJoinWords = 6;  // store.key_words at k <= 63, b <= 15

// A span of slots as the scan sees it: how many runs start in it, and the
// sum of its slots from its last run start on (all of them where none
// starts). Spans combine in order; the empty span {0, 0} is the identity.
struct RunAgg {
  uint32_t count;
  uint32_t sum;
};

BRISK_HD RunAgg run_combine(RunAgg a, RunAgg b) {
  return RunAgg{a.count + b.count, b.count ? b.sum : a.sum + b.sum};
}

BRISK_HD uint64_t pack_agg(RunAgg a) {
  return ((uint64_t)a.count << 32) | a.sum;
}

BRISK_HD RunAgg unpack_agg(uint64_t v) {
  return RunAgg{(uint32_t)(v >> 32), (uint32_t)v};
}

BRISK_HD int popc(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// The highest set lane of a group's mask, -1 if none.
BRISK_HD int last_lane(uint32_t mask) {
#ifdef __CUDA_ARCH__
  return 31 - __clz(mask);
#else
  return mask ? 31 - __builtin_clz(mask) : -1;
#endif
}

// lanes [0, lane] of a group
BRISK_HD uint32_t lanes_upto(int lane) { return 0xFFFFFFFFu >> (31 - lane); }

// ---- one slot -----------------------------------------------------------

struct ScanSlot {
  bool first;        // a run starts here
  uint32_t contrib;  // what the slot adds to its run's sum
  bool hit;          // the join: a live query slot, read at its run sum
};

// The join's slot: sorted u32 words (int64 values), the side tag in bit 0
// of the last word (index 0, query 1). A run is a key with the tag masked;
// index slots add their count, query slots nothing; a query slot with
// liveness 1 reads its key's index sum so far (the index slots sort first).
template <int W>
BRISK_HD ScanSlot join_slot(const int64_t (&w)[W], const int64_t (&prev)[W],
                            bool has_prev, int64_t pay) {
  bool differs = !has_prev;
#pragma unroll
  for (int j = 0; j < W - 1; ++j) differs |= w[j] != prev[j];
  differs |= ((w[W - 1] ^ prev[W - 1]) & ~(int64_t)1) != 0;
  const bool is_q = (w[W - 1] & 1) != 0;
  return ScanSlot{differs, is_q ? 0u : (uint32_t)pay, is_q && pay == 1};
}

// compact's slot: its run-first flag and its count
BRISK_HD ScanSlot run_slot(bool first, int64_t data) {
  return ScanSlot{first, (uint32_t)data, false};
}

// A slot past the end: no run starts, nothing added.
BRISK_HD ScanSlot dead_slot() { return ScanSlot{false, 0u, false}; }

// ---- a group of slots, one a lane ---------------------------------------
//
// A warp takes a tile's slots in groups of one a lane. With `firsts` the
// group's run-start mask, the group's aggregate is its run starts and the
// sum of the lanes from its last start on (in_last_run selects them). A
// lane's running sum is its run's sum up to and including it: from the
// group's inclusive prefix sum `incl`, less the exclusive prefix at its
// run's start lane, or the carry in plus `incl` where its run started
// before the group.

BRISK_HD bool in_last_run(int lane, uint32_t firsts) {
  return lane >= last_lane(firsts);
}

BRISK_HD RunAgg group_agg(uint32_t firsts, uint32_t tail_sum) {
  return RunAgg{(uint32_t)popc(firsts), tail_sum};
}

// the lane where the lane's run starts in the group, -1 before it
BRISK_HD int run_start_lane(uint32_t firsts, int lane) {
  return last_lane(firsts & lanes_upto(lane));
}

BRISK_HD uint32_t lane_run_sum(int start, uint32_t incl,
                               uint32_t excl_at_start, uint32_t carry_sum) {
  return start < 0 ? carry_sum + incl : incl - excl_at_start;
}

// a lane's run index: the run starts up to it, less one
BRISK_HD int64_t lane_run_id(uint32_t carry_count, uint32_t firsts,
                             int lane) {
  return (int64_t)carry_count + popc(firsts & lanes_upto(lane)) - 1;
}

// ---- outputs ------------------------------------------------------------

// the join: slots per partial sum (the plain version's reshape to
// (256, ceil(S / 256))), a slot's partial and what a hit adds
BRISK_HD int64_t join_part_len(int64_t n) {
  return (n + kJoinParts - 1) / kJoinParts;
}

BRISK_HD int join_part(int64_t slot, int64_t part_len) {
  return (int)(slot / part_len);
}

BRISK_HD uint32_t join_value(uint32_t run_sum) { return run_sum & 255u; }

// compact: a run's total at its last slot, 0 elsewhere
BRISK_HD int64_t run_total(bool last, uint32_t run_sum) {
  return last ? (int64_t)run_sum : 0;
}

// ---- the tiles' carries -------------------------------------------------
//
// Pass 1 leaves each tile's aggregate; pass 2 (one block) gives thread t
// the tiles [lo, hi) of tile_range, folds them, scans the threads' folds
// and walks its tiles again, writing each one's carry in: the combine of
// every tile before it.

BRISK_HD void tile_range(int thread, int threads, int n_tiles, int& lo,
                         int& hi) {
  const int per = (n_tiles + threads - 1) / threads;
  lo = thread * per < n_tiles ? thread * per : n_tiles;
  hi = lo + per < n_tiles ? lo + per : n_tiles;
}

}  // namespace brisk
