// Arithmetic of the segmented run scan (run_scan.cu): the query join's
// per-slot run flag and contribution, the run aggregate that tiles, warps
// and groups combine, a lane's running sum inside a group of slots that a
// warp takes at once, and the decoupled look-back's fold and stop rules.
// Every function is __host__ __device__, so a host compiler builds this
// header too (with plain C++ definitions of the CUDA qualifiers):
// tests/test_torch_run_scan.py replays the kernels' one pass with it
// through tests/run_scan_host.cpp, under seeded look-back schedules, and
// holds it to index.sklstore._join_scan_torch and
// index.store._run_totals_torch.
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

// The lowest set lane of a mask, -1 if none.
BRISK_HD int first_lane(uint32_t mask) {
#ifdef __CUDA_ARCH__
  return __ffs(mask) - 1;
#else
  return mask ? __builtin_ctz(mask) : -1;
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

// The join's slot: sorted u32 words, the side tag in bit 0 of the last
// word (index 0, query 1). A run is a key with the tag masked; index slots
// add their count, query slots nothing; a query slot with liveness 1 reads
// its key's index sum so far (the index slots sort first).
template <int W>
BRISK_HD ScanSlot join_slot(const uint32_t (&w)[W],
                            const uint32_t (&prev)[W], bool has_prev,
                            uint32_t pay) {
  bool differs = !has_prev;
#pragma unroll
  for (int j = 0; j < W - 1; ++j) differs |= w[j] != prev[j];
  differs |= ((w[W - 1] ^ prev[W - 1]) & ~1u) != 0;
  const bool is_q = (w[W - 1] & 1u) != 0;
  return ScanSlot{differs, is_q ? 0u : pay, is_q && pay == 1};
}

// compact's slot: its run-first flag and its count
BRISK_HD ScanSlot run_slot(bool first, uint32_t data) {
  return ScanSlot{first, data, false};
}

// A slot past the end: no run starts, nothing added.
BRISK_HD ScanSlot dead_slot() { return ScanSlot{false, 0u, false}; }

// ---- a group of slots, one a lane ---------------------------------------
//
// A warp takes a tile's slots in groups of one a lane, scanning them from a
// warp-local carry of 0 before the tile's carry in is known. With `firsts`
// the group's run-start mask, a lane's running sum is its run's sum up to
// and including it: from the group's inclusive prefix sum `incl`, less the
// exclusive prefix at its run's start lane, or the carry plus `incl` where
// its run started before the group. A lane whose run started before the
// warp's share of the tile is open: the tile's carry in adds to its sum.
// The warp's aggregate is its run starts and its last slot's local sum.

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

// whether the lane's run started before the warp's share (no run start in
// the warp's earlier groups, nor in its group up to it)
BRISK_HD bool lane_open(uint32_t starts_before, uint32_t firsts, int lane) {
  return starts_before == 0 && (firsts & lanes_upto(lane)) == 0;
}

// a lane's run sum once the warp's carry in is known
BRISK_HD uint32_t with_carry(bool open, uint32_t local, uint32_t carry_sum) {
  return open ? carry_sum + local : local;
}

// ---- outputs ------------------------------------------------------------

// the join: slots per partial sum (the plain version's reshape to
// (256, ceil(S / 256))), a slot's partial and what a hit adds
BRISK_HD int64_t join_part_len(int64_t n) {
  return (n + kJoinParts - 1) / kJoinParts;
}

// (slots below 2^31, as the C entries require: a 32-bit division)
BRISK_HD int join_part(int64_t slot, int64_t part_len) {
  return (int)((uint32_t)slot / (uint32_t)part_len);
}

BRISK_HD uint32_t join_value(uint32_t run_sum) { return run_sum & 255u; }

// compact: a run's total at its last slot, 0 elsewhere
BRISK_HD int64_t run_total(bool last, uint32_t run_sum) {
  return last ? (int64_t)run_sum : 0;
}

// ---- the tiles' carries: decoupled look-back --------------------------
//
// A block takes the next tile from a counter, folds it and publishes its
// aggregate (tile 0 its prefix at once). One warp then reads the
// descriptors of the 32 nearest tiles before it, one a lane (lane l holds
// tile t - 1 - l; a tile before 0 reads as the prefix {0, 0}), and folds
// them in tile order up to the nearest lane that stops the look-back; if
// none does, it moves 32 tiles further back. Lanes up to the stop lane must
// be published first. The fold is the tile's carry in; the block then
// publishes its prefix, the carry combined with its aggregate.
//
// Stop rules: run_totals needs the carry's run count (seg_id), so only a
// prefix ends its look-back. The join reads only the carry's sum, and a run
// start resets the sum: an aggregate with a run start ends its look-back
// too. Its prefixes' counts are then partial, and only their sums are read.

enum TileStatus : uint32_t {
  kUnpublished = 0,  // what the C entry's zeroing leaves
  kAggregate = 1,    // the tile's own aggregate
  kPrefix = 2,       // the combine of every tile up to and including it
};

BRISK_HD bool join_stops(uint32_t status, RunAgg v) {
  return status == kPrefix || (status == kAggregate && v.count > 0);
}

BRISK_HD bool totals_stops(uint32_t status, RunAgg) {
  return status == kPrefix;
}

// The last lane of a window of `width` lanes that the fold takes: the
// nearest one that stops the look-back, the window's last without one.
BRISK_HD int window_end(uint32_t stops, int width) {
  return stops ? first_lane(stops) : width - 1;
}

// Whether every lane the fold takes is published.
BRISK_HD bool window_ready(uint32_t unpublished, uint32_t stops, int width) {
  return (unpublished & lanes_upto(window_end(stops, width))) == 0;
}

// A lane's term of the window's fold: its descriptor up to the window's
// end, the identity past it.
BRISK_HD RunAgg window_value(int lane, int end, RunAgg v) {
  return lane <= end ? v : RunAgg{0, 0};
}

// The look-back's combine: the earlier tiles' fold first (a lane's
// higher neighbours in the window's tree, then an earlier window before
// the later ones already folded).
BRISK_HD RunAgg lookback_combine(RunAgg earlier, RunAgg later) {
  return run_combine(earlier, later);
}

}  // namespace brisk
