// Host build of brisk_tpu_torch/csrc/run_scan.cuh, the arithmetic of the
// segmented run scan (run_scan.cu), for tests/test_torch_run_scan.py: a
// shim gives the CUDA qualifiers plain C++ meanings, and C entry points
// replay the kernels' three passes in order with the header's functions,
// on host memory laid out as the kernels' C entries take it. A "warp" here
// is kLanes lanes, so that tiles of a few slots hold several groups: the
// ballot, the warp reduction, the prefix sum and the shuffles are loops
// over the group's lanes; pass 2 gives kCarryThreads threads their ranges
// of tiles and scans their folds in thread order.
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
constexpr int kCarryThreads = 3;

struct GroupOut {
  uint32_t firsts;
  uint32_t run[kLanes];  // each lane's run sum
};

// The kernels' per-group steps over one group's slots s[0..kLanes).
brisk::RunAgg group_reduce(const brisk::ScanSlot* s) {
  uint32_t firsts = 0, tail = 0;
  for (int l = 0; l < kLanes; ++l)
    if (s[l].first) firsts |= 1u << l;
  for (int l = 0; l < kLanes; ++l)
    if (brisk::in_last_run(l, firsts)) tail += s[l].contrib;
  return brisk::group_agg(firsts, tail);
}

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

// Pass 2: each tile's carry in.
std::vector<uint64_t> carries(const std::vector<uint64_t>& agg) {
  const int n_tiles = (int)agg.size();
  std::vector<uint64_t> carry(n_tiles);
  std::vector<brisk::RunAgg> fold(kCarryThreads, brisk::RunAgg{0, 0});
  for (int th = 0; th < kCarryThreads; ++th) {
    int lo, hi;
    brisk::tile_range(th, kCarryThreads, n_tiles, lo, hi);
    for (int t = lo; t < hi; ++t)
      fold[th] = brisk::run_combine(fold[th], brisk::unpack_agg(agg[t]));
  }
  brisk::RunAgg ex{0, 0};
  for (int th = 0; th < kCarryThreads; ++th) {
    int lo, hi;
    brisk::tile_range(th, kCarryThreads, n_tiles, lo, hi);
    brisk::RunAgg e = ex;
    for (int t = lo; t < hi; ++t) {
      carry[t] = brisk::pack_agg(e);
      e = brisk::run_combine(e, brisk::unpack_agg(agg[t]));
    }
    ex = brisk::run_combine(ex, fold[th]);
  }
  return carry;
}

// The join's group at g: lane l's words from memory, the previous slot's
// from lane l - 1 (the shuffle) or, on lane 0, from memory.
template <int W>
void join_group(const int64_t* words, const int64_t* pay, int64_t n,
                int64_t g, brisk::ScanSlot* s) {
  int64_t w[kLanes][W];
  for (int l = 0; l < kLanes; ++l)
    for (int j = 0; j < W; ++j)
      w[l][j] = g + l < n ? words[j * n + g + l] : 0;
  for (int l = 0; l < kLanes; ++l) {
    const int64_t i = g + l;
    if (i >= n) {
      s[l] = brisk::dead_slot();
      continue;
    }
    int64_t prev[W];
    for (int j = 0; j < W; ++j)
      prev[j] = l > 0 ? w[l - 1][j] : (i > 0 ? words[j * n + i - 1] : 0);
    s[l] = brisk::join_slot<W>(w[l], prev, i > 0, pay[i]);
  }
}

void run_group(const bool* first, const int64_t* data, int64_t n, int64_t g,
               brisk::ScanSlot* s) {
  for (int l = 0; l < kLanes; ++l)
    s[l] = g + l < n ? brisk::run_slot(first[g + l], data[g + l])
                     : brisk::dead_slot();
}

template <int W>
void join_scan(const int64_t* words, const int64_t* pay, int64_t* parts,
               int64_t n, int tile) {
  const int n_tiles = (int)((n + tile - 1) / tile);
  brisk::ScanSlot s[kLanes];
  std::vector<uint64_t> agg(n_tiles);
  for (int t = 0; t < n_tiles; ++t) {
    brisk::RunAgg acc{0, 0};
    for (int64_t g = (int64_t)t * tile; g < (int64_t)(t + 1) * tile && g < n;
         g += kLanes) {
      join_group<W>(words, pay, n, g, s);
      acc = brisk::run_combine(acc, group_reduce(s));
    }
    agg[t] = brisk::pack_agg(acc);
  }
  const std::vector<uint64_t> carry = carries(agg);
  for (int p = 0; p < brisk::kJoinParts; ++p) parts[p] = 0;
  const int64_t part_len = brisk::join_part_len(n);
  for (int t = 0; t < n_tiles; ++t) {
    uint32_t run = brisk::unpack_agg(carry[t]).sum;
    for (int64_t g = (int64_t)t * tile; g < (int64_t)(t + 1) * tile && g < n;
         g += kLanes) {
      join_group<W>(words, pay, n, g, s);
      const GroupOut o = group_scan(s, run);
      for (int l = 0; l < kLanes; ++l)
        if (s[l].hit)
          parts[brisk::join_part(g + l, part_len)] +=
              brisk::join_value(o.run[l]);
      run = o.run[kLanes - 1];
    }
  }
}

}  // namespace

extern "C" int host_join_scan(const int64_t* words, const int64_t* pay,
                              int64_t* parts, long long n, int W, int tile) {
  if (n < 1 || tile < kLanes || tile % kLanes) return 1;
  switch (W) {
    case 1: join_scan<1>(words, pay, parts, n, tile); break;
    case 2: join_scan<2>(words, pay, parts, n, tile); break;
    case 3: join_scan<3>(words, pay, parts, n, tile); break;
    case 4: join_scan<4>(words, pay, parts, n, tile); break;
    case 5: join_scan<5>(words, pay, parts, n, tile); break;
    case 6: join_scan<6>(words, pay, parts, n, tile); break;
    default: return 1;
  }
  return 0;
}

extern "C" int host_run_totals(const bool* first, const int64_t* data,
                               int64_t* seg_total, int64_t* seg_id,
                               long long n, int tile) {
  if (n < 1 || tile < kLanes || tile % kLanes) return 1;
  const int n_tiles = (int)((n + tile - 1) / tile);
  brisk::ScanSlot s[kLanes];
  std::vector<uint64_t> agg(n_tiles);
  for (int t = 0; t < n_tiles; ++t) {
    brisk::RunAgg acc{0, 0};
    for (int64_t g = (int64_t)t * tile; g < (int64_t)(t + 1) * tile && g < n;
         g += kLanes) {
      run_group(first, data, n, g, s);
      acc = brisk::run_combine(acc, group_reduce(s));
    }
    agg[t] = brisk::pack_agg(acc);
  }
  const std::vector<uint64_t> carry = carries(agg);
  for (int t = 0; t < n_tiles; ++t) {
    const brisk::RunAgg c = brisk::unpack_agg(carry[t]);
    uint32_t run = c.sum, count = c.count;
    for (int64_t g = (int64_t)t * tile; g < (int64_t)(t + 1) * tile && g < n;
         g += kLanes) {
      run_group(first, data, n, g, s);
      const GroupOut o = group_scan(s, run);
      for (int l = 0; l < kLanes && g + l < n; ++l) {
        const int64_t i = g + l;
        const bool next_first =
            l + 1 < kLanes ? s[l + 1].first : (i + 1 < n && first[i + 1]);
        seg_total[i] = brisk::run_total(i + 1 == n || next_first, o.run[l]);
        seg_id[i] = brisk::lane_run_id(count, o.firsts, l);
      }
      run = o.run[kLanes - 1];
      count += brisk::popc(o.firsts);
    }
  }
  return 0;
}
