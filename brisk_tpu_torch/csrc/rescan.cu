// The get_minimizer rescan for Hopper (sm_90a): the literal
// get_minimizer (reference Kmers.cpp:367-408) at every position of every
// row, one thread per (row, position).
//
// Replaces the XLA program brisk_tpu/ops/minimizer.py
// windowed_get_minimizer (lines 79-169), one fused data-parallel pass in
// the reference. Plain PyTorch version beside it:
// brisk_tpu_torch.ops.minimizer.windowed_get_minimizer_torch, whose
// contract this kernel keeps bit for bit on the inputs position_pipeline
// makes (the invariant below). The arithmetic is enum_math.cuh's.
//
// For position p of a row of length L, with W = k_arg - m + 1, the state
// starts at the position's own candidate (canonical m-mer, offset 0, its
// strand flag, its hash) and folds the offsets i = 1 .. W-1 in order
// (brisk::fold_offset: the strict improvement, the closer mirror, the
// strand rule, the tie count whose cnt == 1 is `unique`):
// * i <= clean_max = 32 - m: the candidate at p - i (zero when p < i:
//   codec._shift_right_axis zero-fills, so whole rows compare equal to the
//   plain version's, also where no k-mer is emitted);
// * i > clean_max: the reference truncates the k-mer to its low 64 bits
//   (Kmers.cpp:371), so the m-mer at offset i is recomputed from the
//   position's own k-mer (brisk::truncated_candidate); for i >= 32 that
//   m-mer is 0 and the candidate one constant of m.
//
// Invariant: every candidate's hash is compared as ONE packed int64
// (brisk::pack_hash), which orders like the (heavy, hi, lo) triple that
// the plain version compares while heavy is in {0, 1, 2} and hi << 32 |
// lo < 2^62. position_pipeline makes exactly such hashes (a decycling
// class, a key masked to 2m <= 62 bits), and the rescan receives nothing
// else; the outputs unpack the same way.
//
// What bounds it on this card.
// * k <= 32 (clean offsets only): memory. Per position 9 int64 and 1 bool
//   in, 6 int64 and 1-2 bool out (~130 B): 136.5 MB at the insert's batch
//   (R 2048, L 542), 0.041 ms at 3.35 TB/s. The first version read each
//   of the W-1 neighbours' six inputs with __ldg and compared triples
//   word by word: 120 L1 loads a position, 3x the byte bound. Here a
//   block stages its 256 positions and the W-1 before them (the halo)
//   in shared memory once, coalesced, each packed to two int64 (the hash;
//   the minimizer with scan_rev in bit 63), and each offset is two
//   shared loads and two compares.
// * k > 32: operations. Each position evaluates the truncated offsets
//   clean_max < i < 32 (20 at m=21, 22 at m=23): a canonical form, the
//   7-step mixer and two decycling sums of m - 1 float64 additions each,
//   with their table loads and digit extractions. That is integer and
//   load work more than the additions (2 x 20 per offset at m=21, which
//   the card's 17 TFLOP/s of float64 additions would take 0.028 ms for
//   at the k=63 batch, R 1024 x L 574); the kernel is bound by the
//   instructions it issues. The design cuts them: the offsets i >= 32
//   (11 at m=21, 9 at m=23), which the first version evaluated one by
//   one, share one constant candidate that the block computes once; the
//   kernel is instantiated per m, so each sum is unrolled with constant
//   digit shifts and table offsets, and both sums read the same digits;
//   the reverse complement of each truncated m-mer comes from one reverse
//   complement of the position's 32-base word. The offsets of a position
//   stay in one thread, in a loop: they are independent until the fold,
//   so the card's 48 resident warps an SM hide their latency (evaluating
//   11 more offsets a position costs in proportion to their count, as
//   an issue-bound loop does); a split across threads issues the same
//   evaluations plus a shared-memory round trip (on an H100 it ran 1.5x
//   slower at k=63). The sums keep the reference's order of additions
//   (__dadd_rn, no multiply, so -fmad cannot fuse them); the table of
//   4m float64 coefficients is the host's (pyref.get_decycling(m).coef),
//   loaded into shared memory: no device sin/cos.

#include <array>
#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

#include "enum_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHalo = 31;  // clean_max at m = 1

struct RescanArgs {
  // (R, L) inputs
  const int64_t* c_lo;     // canonical m-mer (the rolling candidate)
  const int64_t* c_hi;
  const int64_t* heavy;    // its hash triple
  const int64_t* hhi;
  const int64_t* hlo;
  const bool* scan_rev;    // canon_m != fwd_m
  const int64_t* kmer[4];  // the k_arg-base window, u32 limbs
  // (R, L) outputs
  int64_t* o_lo;
  int64_t* o_hi;
  int64_t* o_pos;
  bool* o_rev;
  int64_t* o_heavy;
  int64_t* o_hhi;
  int64_t* o_hlo;
  bool* o_unique;          // null unless with_unique
  const double* coef;      // (4m,) decycling coefficients
};

__device__ __forceinline__ int64_t ld64(const int64_t* p) {
  return (int64_t)__ldg((const long long*)p);
}

__device__ __forceinline__ bool ldb(const bool* p) {
  return __ldg((const unsigned char*)p) != 0;
}

// M = 0: k_arg <= 32, every offset clean; else M = m, with truncated
// offsets.
template <int M>
__global__ void __launch_bounds__(kThreads)
rescan_kernel(const __grid_constant__ RescanArgs a, int64_t n, int L,
              int k_arg, int m) {
  // the block's positions after a halo of H: packed hash, word
  __shared__ int64_t s_h[kMaxHalo + kThreads];
  __shared__ int64_t s_w[kMaxHalo + kThreads];
  __shared__ double coef[M > 0 ? 4 * M : 1];
  __shared__ int64_t const_h, const_w;  // offsets i >= 32
  const int W = k_arg - m + 1;
  const int clean_max = 32 - m;
  const int H = min(W - 1, clean_max);
  const int64_t q0 = (int64_t)blockIdx.x * kThreads;
  for (int j = threadIdx.x; j < H + kThreads; j += kThreads) {
    const int64_t q = q0 - H + j;
    if (q >= 0 && q < n) {
      s_h[j] = brisk::pack_hash(ld64(a.heavy + q), ld64(a.hhi + q),
                                ld64(a.hlo + q));
      s_w[j] = brisk::pack_word(ld64(a.c_lo + q), ld64(a.c_hi + q),
                                ldb(a.scan_rev + q));
    }
  }
  if constexpr (M > 0) {
    for (int j = threadIdx.x; j < 4 * M; j += kThreads) coef[j] = a.coef[j];
    if (threadIdx.x == 0)
      brisk::constant_candidate<M>(a.coef, const_h, const_w);
  }
  const int64_t idx = q0 + threadIdx.x;
  uint32_t x[4] = {0, 0, 0, 0};  // loaded before the barrier: in flight
  if (idx < n) {                 // while the block stages its window
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = (uint32_t)ld64(a.kmer[j] + idx);
  }
  __syncthreads();
  if (idx >= n) return;
  const int p = (int)(idx % L);
  const bool canon = brisk::canonized(x, k_arg);
  const int me = H + threadIdx.x;
  brisk::FoldState s = brisk::fold_start(s_h[me], s_w[me]);
  for (int i = 1; i <= H; ++i) {
    const bool in_row = p >= i;
    brisk::fold_offset(s, in_row ? s_h[me - i] : brisk::kZeroHash,
                       in_row ? s_w[me - i] : 0, i, W - 1 - i, canon);
  }
  if constexpr (M > 0) {
    const uint64_t trunc = (uint64_t)x[0] | ((uint64_t)x[1] << 32);
    const uint64_t rc_trunc = brisk::rc32(trunc);
    const int last = min(W - 1, 31);
    for (int i = clean_max + 1; i <= last; ++i) {
      int64_t h, w;
      brisk::truncated_candidate<M>(trunc, rc_trunc, i, coef, h, w);
      brisk::fold_offset(s, h, w, i, W - 1 - i, canon);
    }
    const int64_t ch = const_h, cw = const_w;
    for (int i = 32; i < W; ++i)
      brisk::fold_offset(s, ch, cw, i, W - 1 - i, canon);
  }
  int64_t heavy, hhi, hlo;
  brisk::unpack_hash(s.h, heavy, hhi, hlo);
  a.o_lo[idx] = s.mini & brisk::kM32;
  a.o_hi[idx] = s.mini >> 32;
  a.o_pos[idx] = s.pos;
  a.o_rev[idx] = s.rev;
  a.o_heavy[idx] = heavy;
  a.o_hhi[idx] = hhi;
  a.o_hlo[idx] = hlo;
  if (a.o_unique) a.o_unique[idx] = s.cnt == 1;
}

using Launch = void (*)(const RescanArgs&, int64_t, int, int, int,
                        cudaStream_t);

template <int M>
void launch(const RescanArgs& a, int64_t n, int L, int k_arg, int m,
            cudaStream_t stream) {
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  rescan_kernel<M><<<grid, kThreads, 0, stream>>>(a, n, L, k_arg, m);
}

template <int... Ms>
constexpr std::array<Launch, sizeof...(Ms)> launches(
    std::integer_sequence<int, Ms...>) {
  return {&launch<Ms>...};
}

// kLaunch[0]: k_arg <= 32; kLaunch[m]: k_arg > 32
constexpr auto kLaunch =
    launches(std::make_integer_sequence<int, brisk::kMaxM + 1>{});

}  // namespace

// in: the 10 input pointers in RescanArgs order (canon lo/hi, heavy, hi,
// lo, scan_rev, the 4 k-mer limbs); out: the 8 output pointers (the 7
// state fields in MinimizerState order, then unique or null); coef: the
// (4m,) float64 table on the device. Rows of length L, n = R * L
// positions. Returns a cudaError_t: the launch's, or
// cudaErrorInvalidValue for m outside [1, 31], k_arg outside [m, 63] or
// L < 1.
extern "C" int brisk_rescan(const void* const* in, void* const* out,
                            const void* coef, int R, int L, int k_arg,
                            int m, void* stream) {
  if (m < 1 || m > brisk::kMaxM || k_arg < m || k_arg > 63 || L < 1 ||
      R < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)R * L;
  if (n == 0) return 0;
  RescanArgs a;
  a.c_lo = (const int64_t*)in[0];
  a.c_hi = (const int64_t*)in[1];
  a.heavy = (const int64_t*)in[2];
  a.hhi = (const int64_t*)in[3];
  a.hlo = (const int64_t*)in[4];
  a.scan_rev = (const bool*)in[5];
  for (int j = 0; j < 4; ++j) a.kmer[j] = (const int64_t*)in[6 + j];
  a.o_lo = (int64_t*)out[0];
  a.o_hi = (int64_t*)out[1];
  a.o_pos = (int64_t*)out[2];
  a.o_rev = (bool*)out[3];
  a.o_heavy = (int64_t*)out[4];
  a.o_hhi = (int64_t*)out[5];
  a.o_hlo = (int64_t*)out[6];
  a.o_unique = (bool*)out[7];
  a.coef = (const double*)coef;
  const bool truncated = k_arg - m > 32 - m;  // W - 1 > clean_max
  kLaunch[truncated ? m : 0](a, n, L, k_arg, m, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
