// The get_minimizer rescan for Hopper (sm_90a): the literal
// get_minimizer (reference Kmers.cpp:367-408) at every position of every
// row, one thread per (row, position).
//
// Replaces the XLA program brisk_tpu/ops/minimizer.py
// windowed_get_minimizer (lines 79-169), one fused data-parallel pass in
// the reference. Plain PyTorch version beside it:
// brisk_tpu_torch.ops.minimizer.windowed_get_minimizer_torch, whose
// contract this kernel keeps bit for bit.
//
// For position p of a row of length L, with W = k_arg - m + 1, the state
// starts at the position's own candidate (canonical m-mer, offset 0, its
// strand flag, its hash triple) and walks the offsets i = 1 .. W-1:
// * i <= clean_max = (64 - 2m) / 2: the candidate at p - i (zero when
//   p < i: codec._shift_right_axis zero-fills, so whole rows compare
//   equal to the plain version's, also where no k-mer is emitted);
// * i > clean_max: the reference truncates the k-mer to its low 64 bits
//   (Kmers.cpp:371), so the m-mer at offset i is recomputed from the
//   position's own k-mer: mm = (kmer64 >> 2i) mod 4^m, its canonical form
//   (canonize64), decycling class (mem_double) and mixed key (mix_key).
// Each offset applies the branch logic: a strictly smaller hash takes
// the offset (pos i); an equal hash takes the mirror W-1-i when it is
// closer to the edge than the current pos; at equal distance the strand
// rule clears rev unless the k-mer is canonized (x <= rcb128_broken(x),
// the reference's broken 128-bit reverse complement, replicated). cnt
// counts offsets tying the running minimum (reset to 1 on a strict
// improvement); unique = cnt == 1 is the windowed packer's certificate.
//
// Hash triples compare lexicographically (heavy, hi, lo), as the plain
// version's hash_lt / hash_eq do. The decycling class sums float64
// coefficients in the reference's order (i from m-1 down to 1) from a
// table the host computed (pyref.get_decycling(m).coef, handed over as a
// device tensor: no device sin/cos, whose rounding differs from the
// host's libm). Only additions: no multiply exists for FMA contraction to
// fuse, so -fmad cannot change a sum. Keep it so.
//
// What bounds it on this card. Memory: per position it reads 9 int64
// and 1 bool inputs and writes 6 int64 and 1-2 bool outputs (~130 B),
// ~150 MB at the bench geometry (B 2048, L_buf 542), ~0.04 ms at
// 3.35 TB/s; the W-1 neighbour reads of a warp are 32 consecutive
// positions of one row, coalesced, and hit L1. At k = 63 m = 21 the 31
// truncated offsets add 2 * 2 * (m-1) = 80 float64 additions per offset
// and position (seq and its rotation), 2,480 per position, besides the
// integer mixing; at 34 TFLOP/s (the data sheet's float64 rate, SXM)
// those are ~0.04 ms at B 1024 x L_buf 574. Its first version reads the
// neighbours with __ldg (no shared-memory tile) and keeps the table in
// shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxM = 31;  // 2m <= 62 bits: the packed hash's key

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

// revcomp._swizzle_byte_local on 32 bits: reverse the 4 bases inside
// each byte, complement.
__device__ __forceinline__ uint32_t swizzle32(uint32_t x) {
  x = ((x & 0x0F0F0F0Fu) << 4) | ((x & 0xF0F0F0F0u) >> 4);
  x = ((x & 0x33333333u) << 2) | ((x & 0xCCCCCCCCu) >> 2);
  return x ^ 0xAAAAAAAAu;
}

// revcomp.canonized_k: x <= rcb128_broken(x, n), the broken reverse
// complement (in-byte swizzle of every limb, no byte or limb reversal,
// then a logical right shift by 128 - 2n bits), compared as u128.
__device__ __forceinline__ bool canonized(const uint32_t x[4], int n) {
  const uint64_t s_lo = (uint64_t)swizzle32(x[0]) |
                        ((uint64_t)swizzle32(x[1]) << 32);
  const uint64_t s_hi = (uint64_t)swizzle32(x[2]) |
                        ((uint64_t)swizzle32(x[3]) << 32);
  const int s = 128 - 2 * n;  // in [2, 128): n in [1, 63]
  uint64_t r_lo, r_hi;
  if (s >= 64) {
    r_lo = s_hi >> (s - 64);
    r_hi = 0;
  } else {
    r_lo = (s_lo >> s) | (s_hi << (64 - s));
    r_hi = s_hi >> s;
  }
  const uint64_t x_lo = (uint64_t)x[0] | ((uint64_t)x[1] << 32);
  const uint64_t x_hi = (uint64_t)x[2] | ((uint64_t)x[3] << 32);
  return x_hi != r_hi ? x_hi < r_hi : x_lo <= r_lo;
}

// revcomp.canonize64: min(x, rcb64(x, m)), rcb64 the true reverse
// complement of m <= 31 bases.
__device__ __forceinline__ uint64_t canonize64(uint64_t x, int m) {
  uint64_t r = __byte_perm((uint32_t)(x >> 32), 0, 0x0123) |
               ((uint64_t)__byte_perm((uint32_t)x, 0, 0x0123) << 32);
  r = ((r & 0x0F0F0F0F0F0F0F0Full) << 4) |
      ((r & 0xF0F0F0F0F0F0F0F0ull) >> 4);
  r = ((r & 0x3333333333333333ull) << 2) |
      ((r & 0xCCCCCCCCCCCCCCCCull) >> 2);
  r = (r ^ 0xAAAAAAAAAAAAAAAAull) >> (64 - 2 * m);
  return x < r ? x : r;
}

// hashing.mix_key: the Thomas-Wang style mixer, every step masked to 2m
// bits, in native uint64 wraparound (also the single-limb path of
// m <= 16, whose masked steps agree with it bit for bit).
__device__ __forceinline__ uint64_t mix_key(uint64_t key, uint64_t mask) {
  key = (~key + (key << 21)) & mask;
  key = key ^ (key >> 24);
  key = ((key + (key << 3)) + (key << 8)) & mask;
  key = key ^ (key >> 14);
  key = ((key + (key << 2)) + (key << 4)) & mask;
  key = key ^ (key >> 28);
  key = (key + (key << 31)) & mask;
  return key;
}

// decycling._compute_r: float64 sum of the m-mer's base coefficients from
// its last base upward, in the reference's order. Additions only.
__device__ __forceinline__ double compute_r(uint64_t s, int m,
                                            const double* coef) {
  double r = 0.0;
  for (int i = m - 1; i >= 1; --i) {
    r = __dadd_rn(r, coef[4 * i + (int)(s & 3u)]);
    s >>= 2;
  }
  return r;
}

// decycling.mem_double: 0 decycling set, 1 double set, 2 other.
__device__ __forceinline__ int64_t mem_double(uint64_t seq, int m,
                                              const double* coef) {
  const uint64_t rot = ((seq & 3u) << (2 * (m - 1))) + (seq >> 2);
  const double r = compute_r(seq, m, coef);
  const double r_rot = compute_r(rot, m, coef);
  const double eps = 1e-6;
  int64_t cls = 2;
  if (r > eps && r_rot < eps) cls = 0;
  if (r < -eps && r_rot > -eps) cls = 1;
  return cls;
}

__global__ void __launch_bounds__(kThreads)
rescan_kernel(const RescanArgs a, int64_t n, int L, int k_arg, int m) {
  __shared__ double coef[4 * kMaxM];
  const int W = k_arg - m + 1;
  const int clean_max = (64 - 2 * m) / 2;
  if (W - 1 > clean_max) {
    for (int j = threadIdx.x; j < 4 * m; j += blockDim.x)
      coef[j] = a.coef[j];
    __syncthreads();
  }
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int p = (int)(idx % L);

  uint32_t x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = (uint32_t)ld64(a.kmer[j] + idx);
  const bool canon = canonized(x, k_arg);
  const uint64_t trunc = (uint64_t)x[0] | ((uint64_t)x[1] << 32);
  const uint64_t mask = (1ull << (2 * m)) - 1;

  int64_t s_lo = ld64(a.c_lo + idx), s_hi = ld64(a.c_hi + idx);
  int64_t s_pos = 0;
  bool s_rev = ldb(a.scan_rev + idx);
  int64_t s_hv = ld64(a.heavy + idx), s_hh = ld64(a.hhi + idx),
          s_hl = ld64(a.hlo + idx);
  int64_t cnt = 1;
  for (int i = 1; i < W; ++i) {
    int64_t hv, hh, hl, c_lo, c_hi;
    bool rev_i;
    if (i <= clean_max) {
      if (p >= i) {
        const int64_t q = idx - i;
        hv = ld64(a.heavy + q);
        hh = ld64(a.hhi + q);
        hl = ld64(a.hlo + q);
        c_lo = ld64(a.c_lo + q);
        c_hi = ld64(a.c_hi + q);
        rev_i = ldb(a.scan_rev + q);
      } else {
        hv = hh = hl = c_lo = c_hi = 0;
        rev_i = false;
      }
    } else {
      const uint64_t mm = (2 * i >= 64 ? 0ull : trunc >> (2 * i)) & mask;
      const uint64_t c = canonize64(mm, m);
      const uint64_t key = mix_key(c, mask);
      c_lo = (int64_t)(c & 0xFFFFFFFFull);
      c_hi = (int64_t)(c >> 32);
      hv = mem_double(c, m, coef);
      hh = (int64_t)(key >> 32);
      hl = (int64_t)(key & 0xFFFFFFFFull);
      rev_i = c != mm;
    }
    const bool lt = hv != s_hv ? hv < s_hv
                               : (hh != s_hh ? hh < s_hh : hl < s_hl);
    const bool eq = hv == s_hv && hh == s_hh && hl == s_hl;
    const int64_t mirror = W - 1 - i;
    const bool take_closer = eq && mirror < s_pos;
    const bool take_strand = eq && mirror == s_pos && !canon;
    const bool take_hash = lt || take_closer;
    const bool take_any = take_hash || take_strand;
    cnt = lt ? 1 : (eq ? cnt + 1 : cnt);
    if (take_any) {
      s_lo = c_lo;
      s_hi = c_hi;
      s_pos = lt ? (int64_t)i : mirror;
    }
    s_rev = take_hash ? rev_i : (s_rev && !take_strand);
    if (take_hash) {
      s_hv = hv;
      s_hh = hh;
      s_hl = hl;
    }
  }
  a.o_lo[idx] = s_lo;
  a.o_hi[idx] = s_hi;
  a.o_pos[idx] = s_pos;
  a.o_rev[idx] = s_rev;
  a.o_heavy[idx] = s_hv;
  a.o_hhi[idx] = s_hh;
  a.o_hlo[idx] = s_hl;
  if (a.o_unique) a.o_unique[idx] = cnt == 1;
}

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
  if (m < 1 || m > kMaxM || k_arg < m || k_arg > 63 || L < 1 || R < 0)
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
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  rescan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a, n, L,
                                                             k_arg, m);
  return (int)cudaGetLastError();
}
