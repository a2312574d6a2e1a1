// Host build of brisk_tpu_torch/csrc/run_scan.cuh, the arithmetic of the
// segmented run scan (run_scan.cu), for tests/test_torch_run_scan.py: a
// shim gives the CUDA qualifiers plain C++ meanings, and C entry points
// replay the kernel's one pass with the header's functions, on host memory
// laid out as the kernels' C entries take it. A "warp" here is kLanes
// lanes, so that tiles of a few slots hold several groups: the ballot, the
// warp reduction, the prefix sum and the shuffles are loops over the
// group's lanes. A tile is one block: two warps when the tile holds two
// warps' whole groups, else one, each of tile / (warps * kLanes) groups.
// Tiles run in order (the order the counter hands them out); what a tile
// sees of its predecessors at its look-back, a window of kLanes tiles at a
// time, is the schedule's choice:
//
//   0  every predecessor shows its prefix;
//   1  every predecessor shows only its aggregate (tile 0, which publishes
//      no aggregate, its prefix), so the look-back walks to the start
//      unless the join's stop rule ends it sooner;
//   s  (s >= 2) seeded by s: each predecessor reads as unpublished for its
//      first 0-2 reads, then as its aggregate or its prefix.
//
//   g++ -O2 -std=c++17 -shared -fPIC -I brisk_tpu_torch/csrc \
//       tests/run_scan_host.cpp -o librun_scan_host.so

#include <cstdint>
#include <vector>

#define __host__
#define __device__
#define __forceinline__ inline

#include "run_scan.cuh"

namespace {

constexpr int kLanes = 4;

struct GroupOut {
  uint32_t firsts;
  uint32_t run[kLanes];  // each lane's run sum
};

// The kernel's scan_group over one group's slots s[0..kLanes).
GroupOut group_scan(const brisk::ScanSlot* s, uint32_t carry) {
  GroupOut g{0, {}};
  uint32_t incl[kLanes];
  uint32_t sum = 0;
  for (int l = 0; l < kLanes; ++l) {
    if (s[l].first) g.firsts |= 1u << l;
    sum += s[l].contrib;
    incl[l] = sum;
  }
  for (int l = 0; l < kLanes; ++l) {
    const int start = brisk::run_start_lane(g.firsts, l);
    const int src = start < 0 ? 0 : start;
    g.run[l] = brisk::lane_run_sum(start, incl[l], incl[src] - s[src].contrib,
                                   carry);
  }
  return g;
}

// ---- the look-back -------------------------------------------------------

// What a finished tile left: its aggregate and its prefix.
struct Desc {
  brisk::RunAgg agg, prefix;
};

uint32_t mix(uint64_t x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdull;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ull;
  return (uint32_t)(x ^ (x >> 33));
}

// The status tile t's look-back reads for tile p at its attempt-th read of
// the window, under `schedule`.
uint32_t seen(int schedule, int64_t t, int64_t p, int attempt) {
  uint32_t status = brisk::kPrefix;
  if (schedule == 1) {
    status = brisk::kAggregate;
  } else if (schedule >= 2) {
    const uint32_t h = mix(((uint64_t)schedule << 48) ^ ((uint64_t)t << 24) ^
                           (uint64_t)p);
    if (attempt < (int)(h % 3)) return brisk::kUnpublished;
    status = (h >> 8) & 1 ? brisk::kPrefix : brisk::kAggregate;
  }
  return p == 0 ? brisk::kPrefix : status;
}

uint32_t read_tile(const std::vector<Desc>& d, int schedule, int64_t t,
                   int64_t p, int attempt, brisk::RunAgg& v) {
  v = brisk::RunAgg{0, 0};
  if (p < 0) return brisk::kPrefix;
  const uint32_t status = seen(schedule, t, p, attempt);
  if (status == brisk::kPrefix) v = d[p].prefix;
  if (status == brisk::kAggregate) v = d[p].agg;
  return status;
}

// Tile t's carry in: the kernel's windows, one tile a lane, folded by the
// shuffle-down tree of brisk::lookback_combine.
template <bool kJoin>
brisk::RunAgg look_back(const std::vector<Desc>& d, int schedule,
                        int64_t t) {
  brisk::RunAgg later{0, 0};
  for (int64_t base = t - 1;; base -= kLanes) {
    brisk::RunAgg v[kLanes];
    uint32_t stops;
    for (int attempt = 0;; ++attempt) {
      uint32_t unpublished = 0;
      stops = 0;
      for (int l = 0; l < kLanes; ++l) {
        const uint32_t status = read_tile(d, schedule, t, base - l, attempt,
                                          v[l]);
        if (kJoin ? brisk::join_stops(status, v[l])
                  : brisk::totals_stops(status, v[l]))
          stops |= 1u << l;
        if (status == brisk::kUnpublished) unpublished |= 1u << l;
      }
      if (brisk::window_ready(unpublished, stops, kLanes)) break;
    }
    const int end = brisk::window_end(stops, kLanes);
    brisk::RunAgg x[kLanes];
    for (int l = 0; l < kLanes; ++l) x[l] = brisk::window_value(l, end, v[l]);
    for (int o = 1; o < kLanes; o <<= 1) {
      brisk::RunAgg y[kLanes];
      for (int l = 0; l < kLanes; ++l) y[l] = l + o < kLanes ? x[l + o] : x[l];
      for (int l = 0; l < kLanes; ++l)
        x[l] = brisk::lookback_combine(y[l], x[l]);
    }
    later = brisk::lookback_combine(x[0], later);
    if (stops) return later;
  }
}

// ---- one pass ------------------------------------------------------------

// Runs the pass over n slots in tiles of `tile`: load(g, s) fills the
// group at slot g; apply(i, s, run, id) takes slot i (s its group's slots
// from its lane) with its run sum and run index.
template <bool kJoin, class Load, class Apply>
void one_pass(int64_t n, int tile, int schedule, Load load, Apply apply) {
  const int warps = tile % (2 * kLanes) == 0 ? 2 : 1;
  const int groups = tile / (warps * kLanes);
  const int64_t n_tiles = (n + tile - 1) / tile;
  std::vector<Desc> d(n_tiles);
  std::vector<brisk::ScanSlot> held(tile);
  std::vector<uint32_t> local(tile);
  std::vector<bool> open(tile);
  std::vector<brisk::RunAgg> wagg(warps);
  for (int64_t t = 0; t < n_tiles; ++t) {
    const int64_t t0 = t * tile;
    brisk::RunAgg agg{0, 0};
    for (int w = 0; w < warps; ++w) {
      // the warp's groups, scanned from a warp-local carry of 0
      uint32_t run = 0, starts = 0;
      for (int g = 0; g < groups; ++g) {
        const int k = (w * groups + g) * kLanes;
        load(t0 + k, &held[k]);
        const GroupOut o = group_scan(&held[k], run);
        for (int l = 0; l < kLanes; ++l) {
          local[k + l] = o.run[l];
          open[k + l] = brisk::lane_open(starts, o.firsts, l);
        }
        run = o.run[kLanes - 1];
        starts += brisk::popc(o.firsts);
      }
      wagg[w] = brisk::RunAgg{starts, run};
      agg = brisk::run_combine(agg, wagg[w]);
    }
    d[t].agg = agg;
    const brisk::RunAgg carry = t > 0 ? look_back<kJoin>(d, schedule, t)
                                      : brisk::RunAgg{0, 0};
    d[t].prefix = brisk::run_combine(carry, agg);
    brisk::RunAgg c = carry;
    for (int w = 0; w < warps; ++w) {
      uint32_t count = c.count;  // the run starts before the group
      for (int g = 0; g < groups; ++g) {
        const int k = (w * groups + g) * kLanes;
        uint32_t firsts = 0;
        for (int l = 0; l < kLanes; ++l)
          if (held[k + l].first) firsts |= 1u << l;
        for (int l = 0; l < kLanes; ++l)
          apply(t0 + k + l, &held[k], l,
                brisk::with_carry(open[k + l], local[k + l], c.sum),
                brisk::lane_run_id(count, firsts, l));
        count += brisk::popc(firsts);
      }
      c = brisk::run_combine(c, wagg[w]);
    }
  }
}

// The join's group at g: lane l's words from memory (their low 32 bits:
// the values are u32), the previous slot's from lane l - 1 (the shuffle)
// or, on lane 0, from memory.
template <int W>
void join_group(const int64_t* words, const int64_t* pay, int64_t n,
                int64_t g, brisk::ScanSlot* s) {
  uint32_t w[kLanes][W];
  for (int l = 0; l < kLanes; ++l)
    for (int j = 0; j < W; ++j)
      w[l][j] = g + l < n ? (uint32_t)words[j * n + g + l] : 0;
  for (int l = 0; l < kLanes; ++l) {
    const int64_t i = g + l;
    if (i >= n) {
      s[l] = brisk::dead_slot();
      continue;
    }
    uint32_t prev[W];
    for (int j = 0; j < W; ++j)
      prev[j] = l > 0 ? w[l - 1][j]
                      : (i > 0 ? (uint32_t)words[j * n + i - 1] : 0);
    s[l] = brisk::join_slot<W>(w[l], prev, i > 0, (uint32_t)pay[i]);
  }
}

template <int W>
void join_scan(const int64_t* words, const int64_t* pay, int64_t* parts,
               int64_t n, int tile, int schedule) {
  for (int p = 0; p < brisk::kJoinParts; ++p) parts[p] = 0;
  const int64_t part_len = brisk::join_part_len(n);
  one_pass<true>(
      n, tile, schedule,
      [&](int64_t g, brisk::ScanSlot* s) {
        join_group<W>(words, pay, n, g, s);
      },
      [&](int64_t i, const brisk::ScanSlot* s, int l, uint32_t run,
          int64_t) {
        if (s[l].hit)
          parts[brisk::join_part(i, part_len)] += brisk::join_value(run);
      });
}

}  // namespace

extern "C" int host_join_scan(const int64_t* words, const int64_t* pay,
                              int64_t* parts, long long n, int W, int tile,
                              int schedule) {
  if (n < 1 || tile < kLanes || tile % kLanes || schedule < 0) return 1;
  switch (W) {
    case 1: join_scan<1>(words, pay, parts, n, tile, schedule); break;
    case 2: join_scan<2>(words, pay, parts, n, tile, schedule); break;
    case 3: join_scan<3>(words, pay, parts, n, tile, schedule); break;
    case 4: join_scan<4>(words, pay, parts, n, tile, schedule); break;
    case 5: join_scan<5>(words, pay, parts, n, tile, schedule); break;
    case 6: join_scan<6>(words, pay, parts, n, tile, schedule); break;
    default: return 1;
  }
  return 0;
}

extern "C" int host_run_totals(const bool* first, const int64_t* data,
                               int64_t* seg_total, int64_t* seg_id,
                               long long n, int tile, int schedule) {
  if (n < 1 || tile < kLanes || tile % kLanes || schedule < 0) return 1;
  one_pass<false>(
      n, tile, schedule,
      [&](int64_t g, brisk::ScanSlot* s) {
        for (int l = 0; l < kLanes; ++l)
          s[l] = g + l < n ? brisk::run_slot(first[g + l],
                                             (uint32_t)data[g + l])
                           : brisk::dead_slot();
      },
      [&](int64_t i, const brisk::ScanSlot* s, int l, uint32_t run,
          int64_t id) {
        if (i >= n) return;
        const bool next_first =
            l + 1 < kLanes ? s[l + 1].first : (i + 1 < n && first[i + 1]);
        seg_total[i] = brisk::run_total(i + 1 == n || next_first, run);
        seg_id[i] = id;
      });
  return 0;
}
