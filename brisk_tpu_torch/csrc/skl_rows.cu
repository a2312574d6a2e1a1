// Super-k-mer row assembly for Hopper (sm_90a): from one emission batch,
// each lane's compacted super-k-mer rows (bucket, meta, nucleotide
// words), compacted to the front of the lane's row_cap slots, one block
// per lane.
//
// Replaces the XLA program brisk_tpu/index/sklstore.py
// rows_from_emissions (lines 168-275): its cummax / cummin passes, the
// segmented suffix-OR (associative_scan) and the per-lane sort. Plain
// PyTorch version beside it: brisk_tpu_torch.index.sklstore.
// rows_from_emissions_torch, whose contract this kernel keeps bit for bit
// on every emission batch, padding slots included: the per-position
// arithmetic is flush_math.cuh's (brisk::row_start, row_contrib, row_meta,
// row_slot), and so are the runs' sequential steps and the segmented
// sum's combine (run_starts ... run_seg, seg_combine).
//
// Per lane (L positions): a row starts at a valid position after a
// boundary or at the lane's first valid one, and past a split
// (2(k - m) + 1 > s_max) also every s_max-th valid position from the
// last such start (first0, a running max); first_pos is the last start at
// or before p (a running max), rank the count of starts before p (a
// running sum); a position is its row's last when the next position is
// not valid or starts a row; last_pos is the next last at or after p (a
// running min from the right). Each valid position contributes disjoint
// bits to its row's words (brisk::row_contrib, from d = last_pos - p and
// j = p - first_pos), and a row's words are the sum of its positions'
// contributions over [p, last_pos]: a suffix sum that restarts after
// each row last, in u32 (brisk::Seg: one row's disjoint bits never
// carry, so it equals the plain version's int64 suffix difference). A
// lane with more starts than row_cap overflows and keeps none. Every
// position goes to one slot (brisk::row_slot: kept starts first in
// order, then every other position in order, as the plain version's
// stable sort puts them) and writes it when the slot is below out_w =
// min(L, row_cap): a kept start its bucket, the others INVALID; meta and
// the words from every position, as the plain version's gather reads
// them.
//
// What bounds it on this card: bytes, at best. It must move the flags
// everywhere, one key limb where a row does not start, all 4 at a row's
// first position, mini_idx and use_rc where a contribution or a slot's
// meta needs them, the bucket at a kept start, and per lane out_w slots
// of 2 + nw int64 (bench_enumerate.skl_rows_bytes: 31.1 MB, 0.0093 ms at
// 3.35 TB/s at the insert's batch, B 2048, L 512, row_cap 128; 37.3 MB,
// 0.0111 ms at the k=63 batch, B 1024, row_cap 512). The previous design
// (256 threads, one position each, in 256-position chunks walked twice)
// waited on its scans: 6 Hillis-Steele block scans of 16 barriers a
// chunk on int64 words, and a global round trip for the chunks' entry
// values: 0.073 / 0.054 ms, 13% / 21% of the bound.
//
// The design: a block of kRowThreads (256) threads walks its lane in
// tiles of kRowTile = 512 positions, each thread over a run of kRowRun
// (2) consecutive ones. Each tile's inputs are staged in shared memory
// with every load issued before the first store (one round trip): a
// flags byte a position (valid, natural start, use_rc), the key limbs
// below bit 2k (the bits a row can read), mini_idx and the bucket. Each
// scan is a sequential pass over the run, a warp scan of the runs'
// totals with shuffles (up for the running max and the (first_pos, rank)
// pair, down for the running min and the segmented sum) and one combine
// of the warps' totals through shared memory: one barrier a scan. Three
// rounds: first0; then first_pos and rank with last_pos (both need only
// the starts); then the contributions' segmented sum, whose u32 words
// halve the widest scan. A contribution past a row's first position is
// one base, read straight from its key bits (brisk::row_contrib). All
// counts are int32 (L < 2^31 - kRowTile). A lane that fits one tile
// (every lane of the main path: L 512 at the insert and the k=63 stream,
// <= 150 on short reads) takes one pass with 5 barriers and no scratch;
// a longer one walks its tiles forward for the start count, keeping each
// tile's entry values in a (B, tiles, 3) int32 scratch, then backward,
// recomputing each tile's forward scans from its entry, with the
// running min and the segmented sum carried in registers. Where out_w <=
// kRowTile the slots are gathered in shared memory and written out
// coalesced after the lane's last tile. Threads past L take part in every
// shuffle and barrier with the scans' identities (flags 0).
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; bench_enumerate, device time):
// 0.036 ms at the insert's batch (26% of the bound), 0.032 ms at the k=63
// batch (35%); the previous design took 0.072 / 0.054. What is left, from
// ablations of a 128 x 4 build: staging the inputs and the forward scans
// took 0.027 of its 0.038 ms at k=31, the slot writes 0.014 of 0.031 ms
// at k=63 (512 slots of 8 int64 a lane, most of the bound's bytes).

#include <array>
#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

#include "flush_math.cuh"

namespace {

constexpr int kThreads = brisk::kRowThreads;
constexpr int kRun = brisk::kRowRun;
constexpr int kTile = brisk::kRowTile;
constexpr int kWarps = kThreads / 32;
constexpr int kBig = brisk::kBigPos;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct RowArgs {
  const int64_t* key[4];  // (B, L) limbs
  const int64_t* bucket;
  const int64_t* mini_idx;
  const bool* use_rc;
  const bool* valid;
  const bool* first_valid;
  const bool* boundary;
  int64_t* out;    // 2 + NW planes of B * out_w: bucket, meta, words
  bool* overflow;  // (B,)
  int* carry;      // (B, tiles, 3) entry values; only when tiles > 1
};

struct Geo {
  int L, out_w, row_cap, k, m, b, s_max, tiles;
  bool split;
};

// the forward running values entering a tile
struct Carry {
  int first0, first_pos, rank;
};

// a thread's run after the forward scans of its tile
struct Run {
  uint32_t valid, starts, lasts;  // a bit a position (starts: bit kRun
                                  // the successor's)
  int fp[kRun], rk[kRun];         // first_pos, rank
  int after;  // the first row last past the run inside the tile, or kBig
};

// A tile's inputs in shared memory: per position a flags byte (valid,
// natural start, use_rc), the 4 key limbs (u32 values), mini_idx and the
// bucket.
constexpr uint8_t kUseRc = 4;

struct Shared {
  uint32_t key[4][kTile];
  int64_t mini[kTile], bucket[kTile];
  uint8_t flags[kTile + 1];
  int first0[kWarps], first_pos[kWarps], rank[kWarps], last[kWarps];
};

// A lane's out_w slots, written out coalesced after its last tile where
// out_w <= kTile (every lane of the main path)
template <int NW>
struct Slots {
  int64_t bucket[kTile], meta[kTile];
  uint32_t words[NW][kTile];
};

__device__ __forceinline__ bool ldb(const bool* p) {
  return __ldg((const unsigned char*)p) != 0;
}

__device__ __forceinline__ int64_t ld64(const int64_t* p) {
  return (int64_t)__ldg((const long long*)p);
}

// Forward scans of the tile from c0: stages its flags (and, with
// `inputs`, its keys, mini_idx and buckets: one read of the lane's
// inputs, issued together), then first0 (a running max), then the
// starts, row lasts, first_pos and rank (a running max and sum) and the
// first row last at or after each position inside the tile (a running
// min from the right). Advances `carry` past the tile; returns the
// tile's first row last (kBig if none).
__device__ __forceinline__ int forward_tile(const RowArgs& a, int64_t base,
                                            int c0, const Geo& g,
                                            bool inputs, Carry& carry,
                                            Shared& sh, Run& run) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // every load of the tile issued before the first store (one round
  // trip): position j = tid + r * kThreads, and the successor of the
  // tile's last at j = kTile (thread 0)
  // key bits at and above 2k never reach a row (row_contrib reads the
  // compacted k-mer's 2(k - b) bits below the hole and 2b above it)
  const int limbs = (2 * g.k + 31) / 32;
  uint8_t f[kRun + 1];
  uint32_t key[kRun][4];
  int64_t mini[kRun], bucket[kRun];
#pragma unroll
  for (int r = 0; r <= kRun; ++r) {
    const int j = tid + r * kThreads;
    const int p = c0 + j;
    f[r] = 0;
    if (j <= kTile && p < g.L) {
      const int64_t q = base + p;
      const bool v = ldb(a.valid + q);
      f[r] = (v ? brisk::kValid : 0) |
             (brisk::natural_start(v, ldb(a.boundary + q),
                                   ldb(a.first_valid + q))
                  ? brisk::kStart0
                  : 0);
      if (inputs && r < kRun) {
        if (ldb(a.use_rc + q)) f[r] |= kUseRc;
#pragma unroll
        for (int l = 0; l < 4; ++l)
          key[r][l] = l < limbs ? (uint32_t)ld64(a.key[l] + q) : 0u;
        mini[r] = ld64(a.mini_idx + q);
        bucket[r] = ld64(a.bucket + q);
      }
    }
  }
  __syncthreads();  // the last tile's readers of the inputs are done
#pragma unroll
  for (int r = 0; r <= kRun; ++r) {
    const int j = tid + r * kThreads;
    if (j <= kTile) sh.flags[j] = f[r];
    if (inputs && r < kRun && c0 + j < g.L) {
#pragma unroll
      for (int l = 0; l < 4; ++l) sh.key[l][j] = key[r][l];
      sh.mini[j] = mini[r];
      sh.bucket[j] = bucket[r];
    }
  }
  __syncthreads();
  const int p0 = c0 + tid * kRun;
  const uint8_t* fl = sh.flags + tid * kRun;

  // first0: the last natural start at or before p
  int f0 = brisk::run_last_start0<kRun>(fl, p0);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, f0, off);
    if (lane >= off) f0 = max(y, f0);
  }
  if (lane == 31) sh.first0[warp] = f0;
  int f0_in = __shfl_up_sync(kFull, f0, 1);
  if (lane == 0) f0_in = 0;
  __syncthreads();
  f0_in = max(f0_in, carry.first0);
  int tile_f0 = carry.first0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) f0_in = max(f0_in, sh.first0[w]);
    tile_f0 = max(tile_f0, sh.first0[w]);
  }
  run.starts = brisk::run_starts<kRun>(fl, p0, f0_in, g.split, g.s_max);
  run.lasts = brisk::run_lasts<kRun>(fl, run.starts);
  run.valid = 0;
#pragma unroll
  for (int i = 0; i < kRun; ++i)
    if (fl[i] & brisk::kValid) run.valid |= 1u << i;

  // first_pos and rank from the left, last_pos from the right
  int fp, rk;
  brisk::run_start_totals<kRun>(run.starts, p0, fp, rk);
  int lp = brisk::run_first_last<kRun>(run.lasts, p0);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y_fp = __shfl_up_sync(kFull, fp, off);
    const int y_rk = __shfl_up_sync(kFull, rk, off);
    const int y_lp = __shfl_down_sync(kFull, lp, off);
    if (lane >= off) {
      fp = max(y_fp, fp);
      rk += y_rk;
    }
    if (lane + off < 32) lp = min(lp, y_lp);
  }
  if (lane == 31) {
    sh.first_pos[warp] = fp;
    sh.rank[warp] = rk;
  }
  if (lane == 0) sh.last[warp] = lp;
  int fp_in = __shfl_up_sync(kFull, fp, 1);
  int rk_in = __shfl_up_sync(kFull, rk, 1);
  int lp_in = __shfl_down_sync(kFull, lp, 1);
  if (lane == 0) fp_in = rk_in = 0;
  if (lane == 31) lp_in = kBig;
  __syncthreads();
  fp_in = max(fp_in, carry.first_pos);
  rk_in += carry.rank;
  int tile_fp = carry.first_pos, tile_rk = 0, tile_lp = kBig;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      fp_in = max(fp_in, sh.first_pos[w]);
      rk_in += sh.rank[w];
    }
    if (w > warp) lp_in = min(lp_in, sh.last[w]);
    tile_fp = max(tile_fp, sh.first_pos[w]);
    tile_rk += sh.rank[w];
    tile_lp = min(tile_lp, sh.last[w]);
  }
  brisk::run_first_rank<kRun>(run.starts, p0, fp_in, rk_in, run.fp,
                              run.rk);
  run.after = lp_in;
  carry = Carry{tile_f0, tile_fp, carry.rank + tile_rk};
  return tile_lp;
}

// The tile's contributions, their segmented suffix sums and its slots
// (into `slots` where it is not null, else straight to the output):
// `after` is the first row last past each thread's run (the lane's, not
// only the tile's); agg_next holds the words at the next tile's first
// position and leaves holding those at this tile's first.
template <int NW>
__device__ __forceinline__ void rows_tile(
    const RowArgs& a, int64_t lane_id, int64_t base, int c0, const Geo& g,
    const Shared& sh, const Run& run, int after, int n_start, bool overflow,
    uint32_t* agg_next, brisk::Seg<NW>* s_seg, Slots<NW>* slots) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = tid * kRun, p0 = c0 + j0;
  int lp[kRun];
  brisk::run_last_pos<kRun>(run.lasts, p0, after, lp);
  int slot[kRun];  // out_w where the position writes no slot
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    const int64_t s =
        p0 + i < g.L ? brisk::row_slot(run.starts >> i & 1u, overflow,
                                       run.rk[i], n_start, p0 + i)
                     : (int64_t)g.out_w;
    slot[i] = s < g.out_w ? (int)s : g.out_w;
  }
  uint32_t words[kRun][NW];
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    const int j = j0 + i;
    const bool valid = run.valid >> i & 1u;
    brisk::row_contrib<NW>(
        brisk::from_limbs(sh.key[0][j], sh.key[1][j], sh.key[2][j],
                          sh.key[3][j]),
        sh.mini[j], (sh.flags[j] & kUseRc) != 0, valid,
        valid ? lp[i] - (p0 + i) : 0, valid ? p0 + i - run.fp[i] : 0, g.k,
        g.m, g.b, words[i]);
  }
  uint32_t reach;
  brisk::Seg<NW> seg =
      brisk::run_seg<kRun, NW>(words, run.lasts, words, reach);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    brisk::Seg<NW> y;
    y.last = __shfl_down_sync(kFull, (int)seg.last, off) != 0;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      y.w[w] = __shfl_down_sync(kFull, seg.w[w], off);
    if (lane + off < 32) seg = brisk::seg_combine(seg, y);
  }
  if (lane == 0) s_seg[warp] = seg;
  brisk::Seg<NW> in;  // the lanes after this one in the warp
  in.last = __shfl_down_sync(kFull, (int)seg.last, 1) != 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) in.w[w] = __shfl_down_sync(kFull, seg.w[w], 1);
  if (lane == 31) {
    in.last = false;
#pragma unroll
    for (int w = 0; w < NW; ++w) in.w[w] = 0;
  }
  __syncthreads();
  brisk::Seg<NW> acc;
  acc.last = true;
#pragma unroll
  for (int w = 0; w < NW; ++w) acc.w[w] = agg_next[w];
#pragma unroll
  for (int w = kWarps - 1; w > warp; --w)
    acc = brisk::seg_combine(s_seg[w], acc);
  acc = brisk::seg_combine(in, acc);  // the words after the run

  const int64_t plane = (int64_t)gridDim.x * g.out_w;
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    if (slot[i] < g.out_w) {
      const int j = j0 + i;
      const bool valid = run.valid >> i & 1u;
      const bool start = run.starts >> i & 1u;
      const int64_t bucket =
          start && !overflow ? sh.bucket[j] : brisk::kInvalid;
      const int64_t meta = brisk::row_meta(
          start, sh.mini[j], (sh.flags[j] & kUseRc) != 0,
          valid ? lp[i] - (p0 + i) : 0, g.m, g.b);
      const bool on = reach >> i & 1u;
      if (slots) {
        const int s = slot[i];
        slots->bucket[s] = bucket;
        slots->meta[s] = meta;
#pragma unroll
        for (int w = 0; w < NW; ++w)
          slots->words[w][s] = words[i][w] + (on ? acc.w[w] : 0u);
      } else {
        int64_t* o = a.out + lane_id * g.out_w + slot[i];
        o[0] = bucket;
        o[plane] = meta;
#pragma unroll
        for (int w = 0; w < NW; ++w)
          o[(2 + w) * plane] =
              (int64_t)(words[i][w] + (on ? acc.w[w] : 0u));
      }
    }
  }
  brisk::Seg<NW> tile;  // the words at the tile's first position
  tile.last = true;
#pragma unroll
  for (int w = 0; w < NW; ++w) tile.w[w] = agg_next[w];
#pragma unroll
  for (int w = kWarps - 1; w >= 0; --w)
    tile = brisk::seg_combine(s_seg[w], tile);
#pragma unroll
  for (int w = 0; w < NW; ++w) agg_next[w] = tile.w[w];
}

// 4 blocks an SM (64 registers) where the words are few (nw 2 at k <= 32
// and b 8), 3 (80 registers) where they are more: nw 4 and 6 then spill
// 8 bytes, and run faster than at 2 blocks without (0.032 against 0.037
// ms at the k=63 batch)
template <int NW>
__global__ void __launch_bounds__(kThreads, NW <= 2 ? 4 : 3)
skl_rows_kernel(const __grid_constant__ RowArgs a, const Geo g) {
  __shared__ Shared sh;
  __shared__ Slots<NW> s_slots;
  __shared__ brisk::Seg<NW> s_seg[kWarps];
  const int64_t lane_id = blockIdx.x;
  const int64_t base = lane_id * g.L;
  const bool one = g.tiles == 1;
  int* carry = one ? nullptr : a.carry + lane_id * g.tiles * 3;
  Slots<NW>* slots = g.out_w <= kTile ? &s_slots : nullptr;

  Carry c{0, 0, 0};
  Run run;
  int tile_last = kBig;
  for (int t = 0; t < g.tiles; ++t) {
    if (!one && threadIdx.x == 0) {
      carry[3 * t] = c.first0;
      carry[3 * t + 1] = c.first_pos;
      carry[3 * t + 2] = c.rank;
    }
    tile_last = forward_tile(a, base, t * kTile, g, one, c, sh, run);
  }
  const int n_start = c.rank;
  const bool overflow = n_start > g.row_cap;
  if (threadIdx.x == 0) a.overflow[lane_id] = overflow;

  int last_carry = kBig;  // the first row last past the tile
  uint32_t agg_next[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) agg_next[w] = 0;
  for (int t = g.tiles - 1; t >= 0; --t) {
    if (!one) {
      Carry e{carry[3 * t], carry[3 * t + 1], carry[3 * t + 2]};
      tile_last = forward_tile(a, base, t * kTile, g, true, e, sh, run);
    }
    rows_tile<NW>(a, lane_id, base, t * kTile, g, sh, run,
                  min(run.after, last_carry), n_start, overflow, agg_next,
                  s_seg, slots);
    last_carry = min(last_carry, tile_last);
  }
  if (slots) {  // every slot below out_w was written once
    __syncthreads();
    const int64_t plane = (int64_t)gridDim.x * g.out_w;
    int64_t* o = a.out + lane_id * g.out_w;
    for (int s = threadIdx.x; s < g.out_w; s += kThreads) {
      o[s] = slots->bucket[s];
      o[plane + s] = slots->meta[s];
#pragma unroll
      for (int w = 0; w < NW; ++w)
        o[(2 + w) * plane + s] = (int64_t)slots->words[w][s];
    }
  }
}

using Launch = void (*)(const RowArgs&, const Geo&, int, cudaStream_t);

template <int NW>
void launch(const RowArgs& a, const Geo& g, int B, cudaStream_t stream) {
  skl_rows_kernel<NW><<<B, kThreads, 0, stream>>>(a, g);
}

template <int... Ns>
constexpr std::array<Launch, sizeof...(Ns)> launches(
    std::integer_sequence<int, Ns...>) {
  return {&launch<Ns + 1>...};
}

// kLaunch[nw - 1] for nw in [1, kMaxNW]
constexpr auto kLaunch =
    launches(std::make_integer_sequence<int, brisk::kMaxNW>{});

}  // namespace

// The positions a block takes at once: a lane longer than this needs the
// scratch `carry` below (its wrapper sizes it from here).
extern "C" int brisk_skl_rows_tile() { return kTile; }

// in: the 10 input pointers in RowArgs order (the 4 key limbs, bucket,
// mini_idx, use_rc, valid, first_valid, boundary), each (B, L); out:
// 2 + nw planes of B * out_w int64 (bucket, meta, the nw words);
// overflow: (B,) bool; carry: B * ceil(L / kRowTile) * 3 int32 of
// scratch where L > kRowTile (else unused, may be null). Returns a
// cudaError_t: the launch's, or cudaErrorInvalidValue for nw outside
// [1, 6], L outside [1, 2^31 - kRowTile), out_w outside
// [0, min(L, row_cap)], a split at an s_max that is no power of two, a
// missing scratch, or k, m, b outside the plain version's ranges.
extern "C" int brisk_skl_rows(const void* const* in, void* out,
                              void* overflow, void* carry, int B, int L,
                              int row_cap, int out_w, int k, int m, int b,
                              int s_max, int split, int nw, void* stream) {
  if (nw < 1 || nw > brisk::kMaxNW || L < 1 || L > 0x7FFFFFFF - kTile ||
      (L > kTile && carry == nullptr) || B < 0 || row_cap < 0 ||
      out_w < 0 || out_w > L || out_w > row_cap || k < 1 || k > 63 ||
      m < 1 || m > k || b < 0 || b > k || s_max < 1 ||
      (split && (s_max & (s_max - 1)) != 0))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  RowArgs a;
  for (int i = 0; i < 4; ++i) a.key[i] = (const int64_t*)in[i];
  a.bucket = (const int64_t*)in[4];
  a.mini_idx = (const int64_t*)in[5];
  a.use_rc = (const bool*)in[6];
  a.valid = (const bool*)in[7];
  a.first_valid = (const bool*)in[8];
  a.boundary = (const bool*)in[9];
  a.out = (int64_t*)out;
  a.overflow = (bool*)overflow;
  a.carry = (int*)carry;
  Geo g;
  g.L = L;
  g.out_w = out_w;
  g.row_cap = row_cap;
  g.k = k;
  g.m = m;
  g.b = b;
  g.s_max = s_max;
  g.tiles = (L + kTile - 1) / kTile;
  g.split = split != 0;
  kLaunch[nw - 1](a, g, B, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
