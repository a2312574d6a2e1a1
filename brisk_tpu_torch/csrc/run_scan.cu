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
// in bit 0 of word W - 1), pay (n,) int64 (u32 index counts; query
// liveness). Out: (256,) int64, partial p the sum over the live query
// slots of [p * L, (p + 1) * L), L = ceil(n / 256), of their key's index
// count mod 256. The kernel reads the int64 words as the sort leaves
// them (their low 32 bits: the values are u32): narrowing them to int32
// first would be a pass of its own that moves more bytes than it saves.
// run totals: first (n,) bool run flags, data (n,) int64 u32 counts. Out:
// seg_total (n,) int64, each run's u32 sum at its last slot and 0
// elsewhere, and seg_id (n,) int64, each slot's run index (run starts up
// to it, less 1).
//
// What bounds it on this card: bytes. The join reads 8 (W + 1) B a slot
// (32 B at W = 3), the totals read 9 B and write 16 B. So each slot is
// read once: one launch a call, a single pass with decoupled look-back.
// A block of 8 warps takes its tile (`tile` slots, 256 to 4,096, the
// wrapper's choice) from a counter in the scratch, so that it waits only
// on tiles whose blocks already run. Each warp walks its share in groups
// of 32 slots, one a lane, loads coalesced across the lanes and issued
// two groups ahead of their use; a slot's run flag compares its words
// with the previous slot's (from the neighbouring lane by a shuffle, lane
// 0 from lane 31's previous group, or from memory for the warp's first).
// The warp scans each group from a warp-local carry of 0 (a ballot gives
// the run starts, a warp prefix sum each lane's run sum, brisk::
// lane_run_sum) and keeps in registers only each slot's local run sum and
// its run-start, open and hit bits, never the words. Its aggregate is its
// run starts and its last slot's local sum. The block combines its warps'
// aggregates in shared memory and publishes the tile's aggregate; one
// warp looks back over its predecessors' descriptors (run_scan.cuh) for
// the tile's carry in and publishes its prefix. Each lane then adds the
// carry to its open slots' sums (brisk::with_carry). The join adds each
// hit's value to a per-lane partial, then, one warp reduction a part, to
// the block's 256 partials in shared memory and those by 64-bit integer
// atomicAdd to the output (exact in any order); the totals write both
// outputs coalesced. A descriptor is a status word and a value (the
// aggregate and the prefix each have their own): the value is stored
// first, then the status with release semantics; a reader loads the
// status with acquire, then the value. The C entry zeroes the counter,
// the statuses and the join's output on its stream before the launch.

#include <cstdint>
#include <cuda/atomic>
#include <cuda_runtime.h>

#include "run_scan.cuh"

namespace {

constexpr int kWarps = 8;  // a block's warps, one tile a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGroups = 16;  // 32-slot groups a warp takes in a tile
constexpr int kAhead = 2;  // groups whose loads a warp issues ahead of use
constexpr unsigned kAll = 0xFFFFFFFFu;
// Reads of a look-back window that wait on an unpublished tile before the
// kernel traps (seconds: a tile that is never published is a fault, and a
// launch that fails is better than one that never ends).
constexpr unsigned kSpinLimit = 1u << 24;

using u64 = unsigned long long;
using Ref = cuda::atomic_ref<u64, cuda::thread_scope_device>;

// the low 32 bits of an int64 in memory (whose values are u32)
__device__ __forceinline__ uint32_t lo32(const int64_t* p) {
  return __ldg((const unsigned*)p);
}

// The join's slots: Raw is what a lane loads of slot i, slot() the
// ScanSlot from it and the previous slot's words, which lane l - 1 holds
// (lane 0 takes them from lane 31's, that lane passing on its previous
// group's or, for the warp's first group, the slot before the warp's).
template <int W>
struct JoinSlots {
  const int64_t* words;  // (W, n)
  const int64_t* pay;
  int64_t n;

  struct Raw {
    uint32_t w[W];
    uint32_t pay;
  };

  __device__ __forceinline__ Raw load(int64_t i) const {
    const bool live = i < n;
    Raw r;
#pragma unroll
    for (int j = 0; j < W; ++j) r.w[j] = live ? lo32(words + j * n + i) : 0u;
    r.pay = live ? lo32(pay + i) : 0u;
    return r;
  }

  // on lane 31: the words of the slot before the warp's first, `base`
  __device__ __forceinline__ Raw before(int64_t base, int lane) const {
    Raw r{};
    if (lane == 31 && base > 0) r = load(base - 1);
    return r;
  }

  __device__ __forceinline__ brisk::ScanSlot slot(int64_t i, const Raw& r,
                                                  const Raw& last,
                                                  int lane) const {
    uint32_t prev[W];
#pragma unroll
    for (int j = 0; j < W; ++j)
      prev[j] = __shfl_sync(kAll, lane == 31 ? last.w[j] : r.w[j],
                            (lane + 31) & 31);
    if (i >= n) return brisk::dead_slot();
    return brisk::join_slot<W>(r.w, prev, i > 0, r.pay);
  }
};

// compact's slots
struct RunSlots {
  const bool* first;
  const int64_t* data;
  int64_t n;

  struct Raw {
    bool first;
    uint32_t data;
  };

  __device__ __forceinline__ Raw load(int64_t i) const {
    const bool live = i < n;
    return Raw{live && first[i], live ? lo32(data + i) : 0u};
  }

  __device__ __forceinline__ Raw before(int64_t, int) const { return Raw{}; }

  __device__ __forceinline__ brisk::ScanSlot slot(int64_t i, const Raw& r,
                                                  const Raw&, int) const {
    if (i >= n) return brisk::dead_slot();
    return brisk::run_slot(r.first, r.data);
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

// A lane's slots of its warp's share of the tile, one a group, as the
// warp-local scan leaves them: kept in registers until the carry is known.
struct Held {
  uint32_t local[kMaxGroups];  // the run sum from a warp-local carry of 0
  uint32_t open;   // bit g: the run started before the warp's share
  uint32_t first;  // bit g: the slot starts a run
  uint32_t hit;    // bit g: the slot is a join hit
};

// Loads the warp's `groups` groups from `base` (the loads kAhead groups
// ahead of their use) and scans them from a warp-local carry of 0 into
// `h`; returns the warp's aggregate.
template <class Slots>
__device__ __forceinline__ brisk::RunAgg scan_warp(const Slots& slots,
                                                   int64_t base, int groups,
                                                   int lane, Held& h) {
  typename Slots::Raw raw[kMaxGroups];
#pragma unroll
  for (int g = 0; g < kAhead; ++g)
    if (g < groups) raw[g] = slots.load(base + 32 * g + lane);
  const typename Slots::Raw before = slots.before(base, lane);
  uint32_t run = 0, starts = 0;
  h.open = h.first = h.hit = 0;
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    if (g < groups) {
      if (g + kAhead < kMaxGroups && g + kAhead < groups)
        raw[g + kAhead] = slots.load(base + 32 * (g + kAhead) + lane);
      const brisk::ScanSlot s =
          slots.slot(base + 32 * g + lane, raw[g],
                     g > 0 ? raw[g > 0 ? g - 1 : 0] : before, lane);
      const Group grp = scan_group(s, lane, run);
      h.local[g] = grp.run;
      h.open |= (uint32_t)brisk::lane_open(starts, grp.firsts, lane) << g;
      h.first |= (uint32_t)s.first << g;
      h.hit |= (uint32_t)s.hit << g;
      run = __shfl_sync(kAll, grp.run, 31);
      starts += brisk::popc(grp.firsts);
    }
  }
  return brisk::RunAgg{starts, run};
}

// The tiles' state in the scratch (u64 words): the tile counter, then
// n_tiles statuses, aggregates and prefixes.
struct Tiles {
  u64* counter;
  u64* status;
  u64* agg;
  u64* prefix;
};

Tiles tiles_of(void* scratch, int n_tiles) {
  auto* s = (u64*)scratch;
  return Tiles{s, s + 1, s + 1 + n_tiles, s + 1 + 2 * (int64_t)n_tiles};
}

__device__ __forceinline__ void publish(const Tiles& tiles, int t,
                                        uint32_t status, brisk::RunAgg v) {
  u64* value = status == brisk::kPrefix ? tiles.prefix : tiles.agg;
  Ref(value[t]).store(brisk::pack_agg(v), cuda::std::memory_order_relaxed);
  Ref(tiles.status[t]).store(status, cuda::std::memory_order_release);
}

// Tile p's descriptor (a tile before 0 reads as the prefix {0, 0}).
__device__ __forceinline__ uint32_t read_tile(const Tiles& tiles, int64_t p,
                                              brisk::RunAgg& v) {
  v = brisk::RunAgg{0, 0};
  if (p < 0) return brisk::kPrefix;
  const auto status =
      (uint32_t)Ref(tiles.status[p]).load(cuda::std::memory_order_acquire);
  if (status != brisk::kUnpublished) {
    u64* value = status == brisk::kPrefix ? tiles.prefix : tiles.agg;
    v = brisk::unpack_agg(
        Ref(value[p]).load(cuda::std::memory_order_relaxed));
  }
  return status;
}

__device__ __forceinline__ brisk::RunAgg shfl_down_agg(brisk::RunAgg x,
                                                       int o) {
  return brisk::RunAgg{__shfl_down_sync(kAll, x.count, o),
                       __shfl_down_sync(kAll, x.sum, o)};
}

// Tile t's carry in, by one warp: windows of the 32 nearest tiles before
// it, lane l reading tile base - l, each folded in tile order up to the
// nearest lane that stops the look-back (the join's or the totals' rule).
template <bool kJoin>
__device__ __forceinline__ brisk::RunAgg look_back(const Tiles& tiles,
                                                   int t, int lane) {
  brisk::RunAgg later{0, 0};
  for (int64_t base = (int64_t)t - 1;; base -= 32) {
    brisk::RunAgg v;
    uint32_t stops;
    for (unsigned ns = 32, spins = 0;; ns = ns < 1024 ? 2 * ns : ns) {
      const uint32_t status = read_tile(tiles, base - lane, v);
      stops = __ballot_sync(kAll, kJoin ? brisk::join_stops(status, v)
                                        : brisk::totals_stops(status, v));
      const uint32_t unpublished =
          __ballot_sync(kAll, status == brisk::kUnpublished);
      if (brisk::window_ready(unpublished, stops, 32)) break;
      if (++spins == kSpinLimit) __trap();
      __nanosleep(ns);
    }
    brisk::RunAgg x =
        brisk::window_value(lane, brisk::window_end(stops, 32), v);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)
      x = brisk::lookback_combine(shfl_down_agg(x, o), x);
    x = brisk::RunAgg{__shfl_sync(kAll, x.count, 0),
                      __shfl_sync(kAll, x.sum, 0)};
    later = brisk::lookback_combine(x, later);
    if (stops) return later;
  }
}

struct BlockShared {
  u64 warp_agg[kWarps];
  u64 carry;  // the tile's carry in
  int tile;
};

// The block's tile, from the counter: the blocks before it already run.
__device__ __forceinline__ int take_tile(const Tiles& tiles,
                                         BlockShared& sh) {
  if (threadIdx.x == 0) sh.tile = (int)atomicAdd(tiles.counter, 1ull);
  __syncthreads();
  return sh.tile;
}

// The warp's carry in: the block publishes tile t's aggregate, looks back
// for its carry in and publishes its prefix; each warp then combines the
// carry with the aggregates of the warps before it.
template <bool kJoin>
__device__ __forceinline__ brisk::RunAgg warp_carry(const Tiles& tiles,
                                                    int t,
                                                    brisk::RunAgg wagg,
                                                    BlockShared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh.warp_agg[warp] = brisk::pack_agg(wagg);
  __syncthreads();
  if (warp == 0) {
    brisk::RunAgg agg{0, 0};
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      agg = brisk::run_combine(agg, brisk::unpack_agg(sh.warp_agg[w]));
    brisk::RunAgg carry{0, 0};
    if (t > 0) {
      if (lane == 0) publish(tiles, t, brisk::kAggregate, agg);
      carry = look_back<kJoin>(tiles, t, lane);
    }
    if (lane == 0) {
      publish(tiles, t, brisk::kPrefix, brisk::run_combine(carry, agg));
      sh.carry = brisk::pack_agg(carry);
    }
  }
  __syncthreads();
  brisk::RunAgg c = brisk::unpack_agg(sh.carry);
  for (int w = 0; w < warp; ++w)
    c = brisk::run_combine(c, brisk::unpack_agg(sh.warp_agg[w]));
  return c;
}

// Adds the lanes' partials to the block's: one shared atomic for each
// part the warp's lanes hold (one, but where a part ends in the warp).
__device__ __forceinline__ void add_parts(u64* block_parts, int part,
                                          uint32_t acc, int lane) {
  for (uint32_t left = __ballot_sync(kAll, acc != 0); left;
       left = __ballot_sync(kAll, acc != 0)) {
    const int src = brisk::first_lane(left);
    const int p = __shfl_sync(kAll, part, src);
    const uint32_t sum = __reduce_add_sync(kAll, part == p ? acc : 0u);
    if (lane == src) atomicAdd(&block_parts[p], (u64)sum);
    if (part == p) acc = 0;
  }
}

// The join: every hit's value into its partial. A tile is `groups` groups
// a warp.
template <int W>
__global__ void __launch_bounds__(kThreads)
join_scan_onepass(const JoinSlots<W> slots, int groups, const Tiles tiles,
                  int64_t part_len, u64* parts) {
  __shared__ BlockShared sh;
  __shared__ u64 block_parts[brisk::kJoinParts];
  for (int p = threadIdx.x; p < brisk::kJoinParts; p += kThreads)
    block_parts[p] = 0;
  const int t = take_tile(tiles, sh);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t base = ((int64_t)t * kWarps + warp) * groups * 32;
  Held h;
  const brisk::RunAgg wagg = scan_warp(slots, base, groups, lane, h);
  const uint32_t carry = warp_carry<true>(tiles, t, wagg, sh).sum;
  // the warp's first partial and where it ends: a division only past it
  const int part0 = brisk::join_part(base, part_len);
  const int64_t end0 = (part0 + 1) * part_len;
  int part = -1;
  uint32_t acc = 0;  // the lane's hits' values in `part` (<= 16 * 255)
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    if (g < groups && ((h.hit >> g) & 1u)) {
      const int64_t i = base + 32 * g + lane;
      const int p = i < end0 ? part0 : brisk::join_part(i, part_len);
      if (p != part) {
        if (acc) atomicAdd(&block_parts[part], (u64)acc);
        part = p;
        acc = 0;
      }
      acc += brisk::join_value(
          brisk::with_carry((h.open >> g) & 1u, h.local[g], carry));
    }
  }
  add_parts(block_parts, part, acc, lane);
  __syncthreads();
  for (int p = threadIdx.x; p < brisk::kJoinParts; p += kThreads)
    if (block_parts[p]) atomicAdd(&parts[p], block_parts[p]);
}

// The totals: each slot's run total (at its run's last slot) and run
// index.
__global__ void __launch_bounds__(kThreads)
run_totals_onepass(const RunSlots slots, int groups, const Tiles tiles,
                   int64_t* seg_total, int64_t* seg_id) {
  __shared__ BlockShared sh;
  const int t = take_tile(tiles, sh);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n = slots.n;
  const int64_t base = ((int64_t)t * kWarps + warp) * groups * 32;
  Held h;
  const brisk::RunAgg wagg = scan_warp(slots, base, groups, lane, h);
  const brisk::RunAgg c = warp_carry<false>(tiles, t, wagg, sh);
  uint32_t count = c.count;  // the run starts before the group
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    if (g < groups) {
      const int64_t i = base + 32 * g + lane;
      // the next slot's run flag: lane l + 1's, for lane 31 lane 0's of
      // the next group or, after the warp's last, from memory
      const bool first = (h.first >> g) & 1u;
      const uint32_t firsts = __ballot_sync(kAll, first);
      bool next_first = __shfl_down_sync(kAll, first, 1);
      const bool next_group =
          __shfl_sync(kAll, (h.first >> (g + 1)) & 1u, 0) != 0;
      if (lane == 31)
        next_first = g + 1 < groups ? next_group
                                    : i + 1 < n && slots.first[i + 1];
      if (i < n) {
        seg_total[i] = brisk::run_total(
            i + 1 == n || next_first,
            brisk::with_carry((h.open >> g) & 1u, h.local[g], c.sum));
        seg_id[i] = brisk::lane_run_id(count, firsts, lane);
      }
      count += brisk::popc(firsts);
    }
  }
}

// The tiles of n slots; 0 when the shape is out of range (n outside
// [1, 2^31), tile not 1 to kMaxGroups times kThreads).
int n_tiles_of(long long n, int tile) {
  if (n < 1 || n >= (1ll << 31) || tile < kThreads || tile % kThreads ||
      tile > kThreads * kMaxGroups)
    return 0;
  return (int)((n + tile - 1) / tile);
}

// Zero the tile counter and the statuses on the stream.
cudaError_t reset(void* scratch, int n_tiles, cudaStream_t stream) {
  return cudaMemsetAsync(scratch, 0, (1 + (size_t)n_tiles) * sizeof(u64),
                         stream);
}

template <int W>
int join_launch(const int64_t* words, const int64_t* pay, long long n,
                int tile, u64* parts, void* scratch, cudaStream_t stream) {
  const int n_tiles = n_tiles_of(n, tile);
  cudaError_t err = cudaMemsetAsync(
      parts, 0, brisk::kJoinParts * sizeof(u64), stream);
  if (err == cudaSuccess) err = reset(scratch, n_tiles, stream);
  if (err != cudaSuccess) return (int)err;
  const JoinSlots<W> slots{words, pay, n};
  join_scan_onepass<W><<<n_tiles, kThreads, 0, stream>>>(
      slots, tile / kThreads, tiles_of(scratch, n_tiles),
      brisk::join_part_len(n), parts);
  return (int)cudaGetLastError();
}

}  // namespace

// words: (W, n) int64 sorted key words, pay: (n,) int64; parts: (256,)
// int64 out; scratch: 1 + 3 * ceil(n / tile) int64 of any contents.
// Returns a cudaError_t: the zeroing's or the launch's, or
// cudaErrorInvalidValue for W outside [1, 6], n outside [1, 2^31) or a
// tile that is not 1 to 16 times 256 slots.
extern "C" int brisk_join_scan(const void* words, const void* pay,
                               void* parts, void* scratch, long long n,
                               int W, int tile, void* stream) {
  if (W < 1 || W > brisk::kMaxJoinWords || n_tiles_of(n, tile) == 0)
    return (int)cudaErrorInvalidValue;
  const auto* w = (const int64_t*)words;
  const auto* p = (const int64_t*)pay;
  auto* out = (u64*)parts;
  const auto st = (cudaStream_t)stream;
  switch (W) {
    case 1: return join_launch<1>(w, p, n, tile, out, scratch, st);
    case 2: return join_launch<2>(w, p, n, tile, out, scratch, st);
    case 3: return join_launch<3>(w, p, n, tile, out, scratch, st);
    case 4: return join_launch<4>(w, p, n, tile, out, scratch, st);
    case 5: return join_launch<5>(w, p, n, tile, out, scratch, st);
    default: return join_launch<6>(w, p, n, tile, out, scratch, st);
  }
}

// first: (n,) bool, data: (n,) int64; seg_total, seg_id: (n,) int64 out;
// scratch: 1 + 3 * ceil(n / tile) int64 of any contents. Returns a
// cudaError_t: the zeroing's or the launch's, or cudaErrorInvalidValue
// for n outside [1, 2^31) or a tile that is not 1 to 16 times 256 slots.
extern "C" int brisk_run_totals(const void* first, const void* data,
                                void* seg_total, void* seg_id,
                                void* scratch, long long n, int tile,
                                void* stream) {
  const int n_tiles = n_tiles_of(n, tile);
  if (n_tiles == 0) return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
  const cudaError_t err = reset(scratch, n_tiles, st);
  if (err != cudaSuccess) return (int)err;
  const RunSlots slots{(const bool*)first, (const int64_t*)data, n};
  run_totals_onepass<<<n_tiles, kThreads, 0, st>>>(
      slots, tile / kThreads, tiles_of(scratch, n_tiles),
      (int64_t*)seg_total, (int64_t*)seg_id);
  return (int)cudaGetLastError();
}
