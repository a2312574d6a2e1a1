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
// on any input, padding slots included: the per-position arithmetic is
// flush_math.cuh's (brisk::row_start, row_contrib, row_meta, row_slot).
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
// j = p - first_pos), and a row's words are the SUM of its positions'
// contributions, the plain version's suffix sum: agg[p] = the sum over
// [p, min(last_pos + 1, L)). A lane with more starts than row_cap
// overflows and keeps none. Every position goes to one slot
// (brisk::row_slot: kept starts first in order, then every other
// position in order, as the plain version's stable sort puts them) and
// writes it when the slot is below out_w = min(L, row_cap): a kept start
// its bucket, the others INVALID; meta and agg from every position, as
// the plain version's gather reads them.
//
// The block walks its lane in chunks of 256 positions, twice. Forward:
// the two running maxima and the running sum as block scans, their
// values at each chunk's entry kept in a (B, chunks, 3) scratch. Backward,
// from the last chunk: the forward quantities again from the kept entry
// values, the running min and the chunk's suffix sums of the
// contributions (block scans in reverse order), agg[p] = suffix(p) -
// suffix(end) inside the chunk, or suffix(p) + agg of the next chunk's
// first position where the row runs on. So any L fits in 18 KB of
// shared memory. The scans are Hillis-Steele in shared memory (8 steps).
//
// What bounds it on this card: the scans' barriers. Per position it reads
// 4 int64 key limbs, bucket and mini_idx and 4 bools (52 B) and per lane
// writes out_w slots of 2 + nw int64, while each chunk takes 6 scans of
// 16 barriers. The least it must move is less: one key limb where a row
// does not start, the bucket only at a kept start, mini_idx and use_rc
// only where a contribution or a slot's meta needs them
// (bench_enumerate.skl_rows_bytes, from the batch's data: 31 MB, 0.0093
// ms at 3.35 TB/s at the insert's batch, B 2048, L 512, row_cap 128);
// reading only those made the kernel 2% slower on the H100. Simple and
// right first: a faster design would scan with warp shuffles.

#include <array>
#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

#include "flush_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kBig = 0x7FFFFFFF;

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
  int64_t* carry;  // (B, chunks, 3): first0, first_pos, rank at entry
};

struct Geo {
  int L, out_w, row_cap, k, m, b, s_max, chunks;
  bool split;
};

struct Pair {
  int64_t first_pos, rank;
};

template <int NW>
struct Words {
  int64_t w[NW];
};

struct MaxOp {
  __device__ int64_t operator()(int64_t a, int64_t b) const {
    return a > b ? a : b;
  }
};

struct MinOp {
  __device__ int64_t operator()(int64_t a, int64_t b) const {
    return a < b ? a : b;
  }
};

struct PairOp {
  __device__ Pair operator()(Pair a, Pair b) const {
    return Pair{a.first_pos > b.first_pos ? a.first_pos : b.first_pos,
                a.rank + b.rank};
  }
};

struct SumOp {
  template <int NW>
  __device__ Words<NW> operator()(const Words<NW>& a,
                                  const Words<NW>& b) const {
    Words<NW> s;
    for (int i = 0; i < NW; ++i) s.w[i] = a.w[i] + b.w[i];
    return s;
  }
};

// Inclusive scan over the block in the order of i (each thread's index in
// [0, kThreads)); returns this thread's value and the block total. After
// it, buf[i] holds index i's inclusive value until the next scan.
template <class T, class Op>
__device__ T block_scan(T x, T* buf, int i, Op op, T& total) {
  __syncthreads();  // the buffer's readers of the last scan are done
  buf[i] = x;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    const T y = i >= off ? op(buf[i - off], x) : x;
    __syncthreads();
    buf[i] = y;
    x = y;
    __syncthreads();
  }
  total = buf[kThreads - 1];
  return x;
}

struct Fwd {
  bool valid, start;
  int64_t first0, first_pos, rank;  // rank: starts before p
};

struct Carry {
  int64_t first0, first_pos, rank;
};

__device__ __forceinline__ bool ldb(const bool* p) {
  return __ldg((const unsigned char*)p) != 0;
}

__device__ __forceinline__ int64_t ld64(const int64_t* p) {
  return (int64_t)__ldg((const long long*)p);
}

// The forward quantities of position p = c0 + threadIdx.x, from the
// running values at the chunk's entry; advances `c` past the chunk.
__device__ Fwd forward(const RowArgs& a, int64_t base, int64_t p,
                       const Geo& g, Carry& c, int64_t* s_max_buf,
                       Pair* s_pair) {
  Fwd f;
  const bool in = p < g.L;
  f.valid = in && ldb(a.valid + base + p);
  const bool start0 =
      in && brisk::natural_start(f.valid, ldb(a.boundary + base + p),
                                 ldb(a.first_valid + base + p));
  int64_t t0;
  const int64_t f0 = block_scan(start0 ? p : (int64_t)0, s_max_buf,
                                (int)threadIdx.x, MaxOp(), t0);
  f.first0 = f0 > c.first0 ? f0 : c.first0;
  f.start = in && brisk::row_start(start0, f.valid, p, f.first0, g.split,
                                   g.s_max);
  Pair t1;
  const Pair pr = block_scan(Pair{f.start ? p : 0, f.start ? 1 : 0}, s_pair,
                             (int)threadIdx.x, PairOp(), t1);
  f.first_pos = pr.first_pos > c.first_pos ? pr.first_pos : c.first_pos;
  f.rank = c.rank + pr.rank - (f.start ? 1 : 0);
  c.first0 = t0 > c.first0 ? t0 : c.first0;
  c.first_pos = t1.first_pos > c.first_pos ? t1.first_pos : c.first_pos;
  c.rank += t1.rank;
  return f;
}

template <int NW>
__global__ void __launch_bounds__(kThreads)
skl_rows_kernel(const __grid_constant__ RowArgs a, const Geo g) {
  __shared__ int64_t s_i64[kThreads];
  __shared__ Pair s_pair[kThreads];
  __shared__ Words<NW> s_words[kThreads];
  __shared__ Words<NW> s_agg0;  // agg at the next chunk's first position
  const int tid = threadIdx.x;
  const int64_t lane = blockIdx.x;
  const int64_t base = lane * g.L;
  int64_t* carry = a.carry + lane * g.chunks * 3;

  Carry c{0, 0, 0};
  for (int ch = 0; ch < g.chunks; ++ch) {
    if (tid == 0) {
      carry[3 * ch] = c.first0;
      carry[3 * ch + 1] = c.first_pos;
      carry[3 * ch + 2] = c.rank;
    }
    forward(a, base, (int64_t)ch * kThreads + tid, g, c, s_i64, s_pair);
  }
  const int64_t n_start = c.rank;
  const bool overflow = n_start > g.row_cap;
  if (tid == 0) a.overflow[lane] = overflow;

  const int64_t plane = (int64_t)gridDim.x * g.out_w;
  int64_t last_carry = kBig;
  Words<NW> agg_next;
  for (int i = 0; i < NW; ++i) agg_next.w[i] = 0;
  for (int ch = g.chunks - 1; ch >= 0; --ch) {
    const int64_t c0 = (int64_t)ch * kThreads;
    const int64_t p = c0 + tid;
    const bool in = p < g.L;
    Carry entry{carry[3 * ch], carry[3 * ch + 1], carry[3 * ch + 2]};
    const Fwd f = forward(a, base, p, g, entry, s_i64, s_pair);
    bool next_valid = false, next_start = false;
    if (p + 1 < g.L) {
      const int64_t q = base + p + 1;
      next_valid = ldb(a.valid + q);
      const bool s0 = brisk::natural_start(next_valid, ldb(a.boundary + q),
                                           ldb(a.first_valid + q));
      next_start = brisk::row_start(s0, next_valid, p + 1,
                                    s0 ? p + 1 : f.first0, g.split,
                                    g.s_max);
    }
    const bool is_last = f.valid && (!next_valid || next_start);
    int64_t t_last;
    int64_t last = block_scan(is_last ? p : kBig, s_i64, kThreads - 1 - tid,
                              MinOp(), t_last);
    last = last < last_carry ? last : last_carry;
    const int64_t d = f.valid ? last - p : 0;
    const int64_t j = f.valid ? p - f.first_pos : 0;
    brisk::u128 key = 0;
    int64_t mini = 0, bucket = 0;
    bool use_rc = false;
    if (in) {
      const int64_t q = base + p;
      key = brisk::from_limbs(ld64(a.key[0] + q), ld64(a.key[1] + q),
                              ld64(a.key[2] + q), ld64(a.key[3] + q));
      mini = ld64(a.mini_idx + q);
      bucket = ld64(a.bucket + q);
      use_rc = ldb(a.use_rc + q);
    }
    uint32_t contrib[NW];
    brisk::row_contrib<NW>(key, mini, use_rc, f.valid, d, j, g.k, g.m, g.b,
                           contrib);
    Words<NW> x, total;
    for (int i = 0; i < NW; ++i) x.w[i] = contrib[i];
    // suffix sums of the chunk: scan index kThreads - 1 - (q - c0)
    const Words<NW> suffix =
        block_scan(x, s_words, kThreads - 1 - tid, SumOp(), total);
    const int64_t end = last + 1 < g.L ? last + 1 : g.L;
    const int64_t c_end = c0 + kThreads < g.L ? c0 + kThreads : g.L;
    Words<NW> agg = suffix;
    if (end < c_end) {
      const Words<NW>& rest = s_words[kThreads - 1 - (end - c0)];
      for (int i = 0; i < NW; ++i) agg.w[i] -= rest.w[i];
    } else if (end > c_end) {
      for (int i = 0; i < NW; ++i) agg.w[i] += agg_next.w[i];
    }
    if (in) {
      const int64_t slot =
          brisk::row_slot(f.start, overflow, f.rank, n_start, p);
      if (slot < g.out_w) {
        int64_t* o = a.out + lane * g.out_w + slot;
        o[0] = f.start && !overflow ? bucket : brisk::kInvalid;
        o[plane] = brisk::row_meta(f.start, mini, use_rc, d, g.m, g.b);
        for (int i = 0; i < NW; ++i) o[(2 + i) * plane] = agg.w[i];
      }
    }
    last_carry = last_carry < t_last ? last_carry : t_last;
    __syncthreads();  // every thread has read agg_next
    if (tid == 0) s_agg0 = agg;
    __syncthreads();
    agg_next = s_agg0;
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

// in: the 10 input pointers in RowArgs order (the 4 key limbs, bucket,
// mini_idx, use_rc, valid, first_valid, boundary), each (B, L); out:
// 2 + nw planes of B * out_w int64 (bucket, meta, the nw words);
// overflow: (B,) bool; carry: B * ceil(L / 256) * 3 int64 of scratch.
// Returns a cudaError_t: the launch's, or cudaErrorInvalidValue for nw
// outside [1, 6], L < 1, out_w outside [0, min(L, row_cap)], a split
// at an s_max that is no power of two, or k, m, b outside the plain
// version's ranges.
extern "C" int brisk_skl_rows(const void* const* in, void* out,
                              void* overflow, void* carry, int B, int L,
                              int row_cap, int out_w, int k, int m, int b,
                              int s_max, int split, int nw, void* stream) {
  if (nw < 1 || nw > brisk::kMaxNW || L < 1 || B < 0 || row_cap < 0 ||
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
  a.carry = (int64_t*)carry;
  Geo g;
  g.L = L;
  g.out_w = out_w;
  g.row_cap = row_cap;
  g.k = k;
  g.m = m;
  g.b = b;
  g.s_max = s_max;
  g.chunks = (L + kThreads - 1) / kThreads;
  g.split = split != 0;
  kLaunch[nw - 1](a, g, B, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
