// The segmented run scan over sorted slots for Hopper (sm_90a), with two
// C entries: the query join's scan (brisk_join_scan) and compact's run
// totals (brisk_run_totals).
//
// Replaces the scan of the reference's XLA programs after their sorts:
// brisk_tpu/index/sklstore.py _query_join_partials (lines 1430-1497: the
// run flags, the u32 cumsum, the cummax of each run's base, the (256,)
// partial sums) and brisk_tpu/index/store.py compact (lines 199-223: the
// run totals and run ranks before its packing sorts). Plain PyTorch
// versions beside their callers: brisk_tpu_torch.index.sklstore.
// _join_scan_torch and brisk_tpu_torch.index.store._run_totals_torch,
// whose contracts these kernels keep element for element; the arithmetic
// is run_scan.cuh's.
//
// join: words (W, n) int64 holding the sorted u32 key words (the side tag
// in bit 0 of word W - 1), pay (n,) int64 (index counts; query
// liveness). Out: (256,) int64, partial p the sum over the live query
// slots of [p * L, (p + 1) * L), L = ceil(n / 256), of their key's index
// count mod 256. The kernel reads the int64 words as the sort leaves
// them: narrowing them to int32 first would be a pass of its own that
// moves more bytes than it saves.
// run totals: first (n,) bool run flags, data (n,) int64. Out: seg_total
// (n,) int64, each run's u32 sum at its last slot and 0 elsewhere, and
// seg_id (n,) int64, each slot's run index (run starts up to it, less 1).
//
// What bounds it on this card: bytes. Each pass reads every slot's words
// and payload (the join 8 (W + 1) B a slot, 32 B at W = 3; the totals
// 9 B), and the totals write 16 B a slot. Design: reduce, then scan, then
// apply, over tiles of `tile` slots (a multiple of 32, the wrapper's
// choice), one warp a tile. Pass 1 walks each tile in groups of 32 slots,
// one a lane, loads coalesced across the lanes; a slot's run flag
// compares its words with the previous slot's (from the neighbouring lane
// by a shuffle, lane 0 from memory); a ballot gives the group's run
// starts and one warp reduction the sum from its last start, folded into
// the tile's aggregate. Pass 2, one block of 1024 threads, scans the
// tiles' aggregates into each tile's carry in. Pass 3 walks each tile
// again from its carry: a warp prefix sum gives each lane its run's sum
// (brisk::lane_run_sum). The join adds each hit's value to a per-lane
// partial, then to the block's 256 partials in shared memory and those
// by 64-bit integer atomicAdd to the output (exact in any order); the
// totals write both outputs coalesced.

#include <cstdint>
#include <cuda_runtime.h>

#include "run_scan.cuh"

namespace {

constexpr int kWarps = 8;  // tiles a block: one a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kCarryThreads = 1024;
constexpr unsigned kAll = 0xFFFFFFFFu;

__device__ __forceinline__ int64_t ld64(const int64_t* p) {
  return (int64_t)__ldg((const long long*)p);
}

// the join's slot i on every lane of the warp
template <int W>
struct JoinSlots {
  const int64_t* words;  // (W, n)
  const int64_t* pay;
  int64_t n;

  __device__ __forceinline__ brisk::ScanSlot at(int64_t i, int lane) const {
    const bool live = i < n;
    int64_t w[W], prev[W];
#pragma unroll
    for (int j = 0; j < W; ++j) w[j] = live ? ld64(words + j * n + i) : 0;
#pragma unroll
    for (int j = 0; j < W; ++j)
      prev[j] = (int64_t)__shfl_up_sync(kAll, (long long)w[j], 1);
    if (lane == 0 && live && i > 0) {
#pragma unroll
      for (int j = 0; j < W; ++j) prev[j] = ld64(words + j * n + i - 1);
    }
    if (!live) return brisk::dead_slot();
    return brisk::join_slot<W>(w, prev, i > 0, ld64(pay + i));
  }
};

// compact's slot i
struct RunSlots {
  const bool* first;
  const int64_t* data;
  int64_t n;

  __device__ __forceinline__ brisk::ScanSlot at(int64_t i, int) const {
    if (i >= n) return brisk::dead_slot();
    return brisk::run_slot(first[i], ld64(data + i));
  }
};

__device__ __forceinline__ uint32_t warp_prefix_sum(uint32_t x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kAll, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// A group's run starts and each lane's run sum, from the carry in.
struct Group {
  uint32_t firsts;
  uint32_t run;
};

__device__ __forceinline__ Group scan_group(const brisk::ScanSlot& s,
                                            int lane, uint32_t carry) {
  const uint32_t firsts = __ballot_sync(kAll, s.first);
  const uint32_t incl = warp_prefix_sum(s.contrib, lane);
  const int start = brisk::run_start_lane(firsts, lane);
  const uint32_t excl =
      __shfl_sync(kAll, incl - s.contrib, start < 0 ? 0 : start);
  return Group{firsts, brisk::lane_run_sum(start, incl, excl, carry)};
}

// Pass 1: the aggregate of warp w's tile.
template <class Slots>
__device__ __forceinline__ void reduce_tile(const Slots& slots, int tile,
                                            int n_tiles, uint64_t* agg) {
  const int lane = threadIdx.x & 31;
  const int64_t t = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= n_tiles) return;
  const int64_t t0 = t * tile;
  const int64_t t1 = t0 + tile < slots.n ? t0 + tile : slots.n;
  brisk::RunAgg acc{0, 0};
  for (int64_t g = t0; g < t1; g += 32) {
    const brisk::ScanSlot s = slots.at(g + lane, lane);
    const uint32_t firsts = __ballot_sync(kAll, s.first);
    const uint32_t tail = __reduce_add_sync(
        kAll, brisk::in_last_run(lane, firsts) ? s.contrib : 0u);
    acc = brisk::run_combine(acc, brisk::group_agg(firsts, tail));
  }
  if (lane == 0) agg[t] = brisk::pack_agg(acc);
}

__device__ __forceinline__ brisk::RunAgg shfl_up_agg(brisk::RunAgg x,
                                                     int o) {
  return brisk::RunAgg{__shfl_up_sync(kAll, x.count, o),
                       __shfl_up_sync(kAll, x.sum, o)};
}

// Pass 2: each tile's carry in, the combine of the tiles before it (one
// block of kCarryThreads).
__device__ __forceinline__ void tile_carries(const uint64_t* agg,
                                             uint64_t* carry, int n_tiles) {
  __shared__ uint64_t warp_total[kCarryThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int lo, hi;
  brisk::tile_range(threadIdx.x, kCarryThreads, n_tiles, lo, hi);
  brisk::RunAgg x{0, 0};
  for (int t = lo; t < hi; ++t)
    x = brisk::run_combine(x, brisk::unpack_agg(agg[t]));
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const brisk::RunAgg y = shfl_up_agg(x, o);
    if (lane >= o) x = brisk::run_combine(y, x);
  }
  if (lane == 31) warp_total[warp] = brisk::pack_agg(x);
  __syncthreads();
  if (warp == 0) {
    brisk::RunAgg v = brisk::unpack_agg(warp_total[lane]);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const brisk::RunAgg y = shfl_up_agg(v, o);
      if (lane >= o) v = brisk::run_combine(y, v);
    }
    warp_total[lane] = brisk::pack_agg(v);
  }
  __syncthreads();
  brisk::RunAgg ex = warp ? brisk::unpack_agg(warp_total[warp - 1])
                          : brisk::RunAgg{0, 0};
  const brisk::RunAgg before = shfl_up_agg(x, 1);
  if (lane > 0) ex = brisk::run_combine(ex, before);
  for (int t = lo; t < hi; ++t) {
    const brisk::RunAgg a = brisk::unpack_agg(agg[t]);
    carry[t] = brisk::pack_agg(ex);
    ex = brisk::run_combine(ex, a);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
join_scan_reduce(const JoinSlots<W> slots, int tile, int n_tiles,
                 uint64_t* agg) {
  reduce_tile(slots, tile, n_tiles, agg);
}

__global__ void __launch_bounds__(kCarryThreads)
join_scan_carries(const uint64_t* agg, uint64_t* carry, int n_tiles,
                  unsigned long long* parts) {
  if (threadIdx.x < brisk::kJoinParts) parts[threadIdx.x] = 0;
  tile_carries(agg, carry, n_tiles);
}

// Pass 3 of the join: every hit's value into its partial.
template <int W>
__global__ void __launch_bounds__(kThreads)
join_scan_apply(const JoinSlots<W> slots, int tile, int n_tiles,
                const uint64_t* carry, int64_t part_len,
                unsigned long long* parts) {
  __shared__ unsigned long long block_parts[brisk::kJoinParts];
  for (int p = threadIdx.x; p < brisk::kJoinParts; p += kThreads)
    block_parts[p] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t t = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t < n_tiles) {
    const int64_t t0 = t * tile;
    const int64_t t1 = t0 + tile < slots.n ? t0 + tile : slots.n;
    uint32_t run = brisk::unpack_agg(carry[t]).sum;
    int part = -1;
    unsigned long long acc = 0;
    for (int64_t g = t0; g < t1; g += 32) {
      const brisk::ScanSlot s = slots.at(g + lane, lane);
      const Group grp = scan_group(s, lane, run);
      if (s.hit) {
        const int p = brisk::join_part(g + lane, part_len);
        if (p != part) {
          if (acc) atomicAdd(&block_parts[part], acc);
          part = p;
          acc = 0;
        }
        acc += brisk::join_value(grp.run);
      }
      run = __shfl_sync(kAll, grp.run, 31);
    }
    if (acc) atomicAdd(&block_parts[part], acc);
  }
  __syncthreads();
  for (int p = threadIdx.x; p < brisk::kJoinParts; p += kThreads)
    if (block_parts[p]) atomicAdd(&parts[p], block_parts[p]);
}

__global__ void __launch_bounds__(kThreads)
run_totals_reduce(const RunSlots slots, int tile, int n_tiles,
                  uint64_t* agg) {
  reduce_tile(slots, tile, n_tiles, agg);
}

__global__ void __launch_bounds__(kCarryThreads)
run_totals_carries(const uint64_t* agg, uint64_t* carry, int n_tiles) {
  tile_carries(agg, carry, n_tiles);
}

// Pass 3 of the totals: each slot's run total (at its run's last slot)
// and run index.
__global__ void __launch_bounds__(kThreads)
run_totals_apply(const RunSlots slots, int tile, int n_tiles,
                 const uint64_t* carry, int64_t* seg_total,
                 int64_t* seg_id) {
  const int lane = threadIdx.x & 31;
  const int64_t t = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= n_tiles) return;
  const int64_t n = slots.n;
  const int64_t t0 = t * tile;
  const int64_t t1 = t0 + tile < n ? t0 + tile : n;
  const brisk::RunAgg c = brisk::unpack_agg(carry[t]);
  uint32_t run = c.sum, count = c.count;
  for (int64_t g = t0; g < t1; g += 32) {
    const int64_t i = g + lane;
    const brisk::ScanSlot s = slots.at(i, lane);
    const Group grp = scan_group(s, lane, run);
    bool next_first = __shfl_down_sync(kAll, s.first, 1);
    if (lane == 31) next_first = i + 1 < n && slots.first[i + 1];
    if (i < n) {
      seg_total[i] = brisk::run_total(i + 1 == n || next_first, grp.run);
      seg_id[i] = brisk::lane_run_id(count, grp.firsts, lane);
    }
    run = __shfl_sync(kAll, grp.run, 31);
    count += brisk::popc(grp.firsts);
  }
}

// The tiles and the blocks of n slots; 0 tiles when the shape is out of
// range (n outside [1, 2^31), tile not a positive multiple of 32).
int n_tiles_of(long long n, int tile) {
  if (n < 1 || n >= (1ll << 31) || tile < 32 || tile % 32) return 0;
  return (int)((n + tile - 1) / tile);
}

unsigned blocks_of(int n_tiles) {
  return (unsigned)((n_tiles + kWarps - 1) / kWarps);
}

template <int W>
int join_launch(const int64_t* words, const int64_t* pay, long long n,
                int tile, unsigned long long* parts, uint64_t* scratch,
                cudaStream_t stream) {
  const int n_tiles = n_tiles_of(n, tile);
  const JoinSlots<W> slots{words, pay, n};
  uint64_t* agg = scratch;
  uint64_t* carry = scratch + n_tiles;
  join_scan_reduce<W><<<blocks_of(n_tiles), kThreads, 0, stream>>>(
      slots, tile, n_tiles, agg);
  join_scan_carries<<<1, kCarryThreads, 0, stream>>>(agg, carry, n_tiles,
                                                     parts);
  join_scan_apply<W><<<blocks_of(n_tiles), kThreads, 0, stream>>>(
      slots, tile, n_tiles, carry, brisk::join_part_len(n), parts);
  return (int)cudaGetLastError();
}

}  // namespace

// words: (W, n) int64 sorted key words, pay: (n,) int64; parts: (256,)
// int64 out; scratch: 2 * ceil(n / tile) int64. Returns a cudaError_t:
// the launches', or cudaErrorInvalidValue for W outside [1, 6], n outside
// [1, 2^31) or a tile that is not a positive multiple of 32.
extern "C" int brisk_join_scan(const void* words, const void* pay,
                               void* parts, void* scratch, long long n,
                               int W, int tile, void* stream) {
  if (W < 1 || W > brisk::kMaxJoinWords || n_tiles_of(n, tile) == 0)
    return (int)cudaErrorInvalidValue;
  const auto* w = (const int64_t*)words;
  const auto* p = (const int64_t*)pay;
  auto* out = (unsigned long long*)parts;
  auto* s = (uint64_t*)scratch;
  const auto st = (cudaStream_t)stream;
  switch (W) {
    case 1: return join_launch<1>(w, p, n, tile, out, s, st);
    case 2: return join_launch<2>(w, p, n, tile, out, s, st);
    case 3: return join_launch<3>(w, p, n, tile, out, s, st);
    case 4: return join_launch<4>(w, p, n, tile, out, s, st);
    case 5: return join_launch<5>(w, p, n, tile, out, s, st);
    default: return join_launch<6>(w, p, n, tile, out, s, st);
  }
}

// first: (n,) bool, data: (n,) int64; seg_total, seg_id: (n,) int64 out;
// scratch: 2 * ceil(n / tile) int64. Returns a cudaError_t: the
// launches', or cudaErrorInvalidValue for n outside [1, 2^31) or a tile
// that is not a positive multiple of 32.
extern "C" int brisk_run_totals(const void* first, const void* data,
                                void* seg_total, void* seg_id,
                                void* scratch, long long n, int tile,
                                void* stream) {
  const int n_tiles = n_tiles_of(n, tile);
  if (n_tiles == 0) return (int)cudaErrorInvalidValue;
  const RunSlots slots{(const bool*)first, (const int64_t*)data, n};
  auto* agg = (uint64_t*)scratch;
  uint64_t* carry = agg + n_tiles;
  const auto st = (cudaStream_t)stream;
  run_totals_reduce<<<blocks_of(n_tiles), kThreads, 0, st>>>(
      slots, tile, n_tiles, agg);
  run_totals_carries<<<1, kCarryThreads, 0, st>>>(agg, carry, n_tiles);
  run_totals_apply<<<blocks_of(n_tiles), kThreads, 0, st>>>(
      slots, tile, n_tiles, carry, (int64_t*)seg_total, (int64_t*)seg_id);
  return (int)cudaGetLastError();
}
