// Arithmetic of the enumerator's two kernels (state_scan.cu, rescan.cu):
// the packed values, the state machine's per-position step, the
// get_minimizer fold of one offset, and the candidate of a truncated
// offset (canonical form, mixed key, decycling class). Every function is
// __host__ __device__, so a host compiler can build this header alone
// (with plain C++ definitions of __host__, __device__ and
// __forceinline__; the two intrinsics used have host forms below) and
// check it against the plain PyTorch versions:
// tests/test_torch_enum_math.py does so.
//
// Packed values, as in the plain versions:
// * a hash triple (heavy, hi, lo) rides as ONE int64
//   h = (heavy - 2) * 2^62 + (hi << 32 | lo), formed in uint64 so that it
//   wraps like PyTorch's int64 on any input. While heavy is in {0, 1, 2}
//   and hi << 32 | lo < 2^62 (what position_pipeline gives: a key masked
//   to 2m <= 62 bits, a decycling class), h orders like the triple when
//   compared SIGNED, and h == h' exactly when the triples are equal;
// * a minimizer as lo | hi << 32 (< 2^62 for the same reason), so bit 63
//   is free to carry a strand flag ("word" below).

#pragma once

#include <cstdint>

#define BRISK_HD __host__ __device__ __forceinline__

namespace brisk {

constexpr int kMaxM = 31;  // 2m <= 62 bits: the packed hash's key
constexpr int64_t kKeyMask = (1ll << 62) - 1;
constexpr int64_t kM32 = 0xFFFFFFFFll;
// pack_hash(0, 0, 0): the zero-filled candidate before a row's start
constexpr int64_t kZeroHash = (int64_t)(1ull << 63);

// float64 addition rounded to nearest (IEEE on the host as well)
BRISK_HD double dadd_rn(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dadd_rn(a, b);
#else
  return a + b;
#endif
}

// the 4 bytes of x in reverse order
BRISK_HD uint32_t bswap32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __byte_perm(x, 0, 0x0123);
#else
  return (x >> 24) | ((x >> 8) & 0xFF00u) | ((x << 8) & 0xFF0000u) |
         (x << 24);
#endif
}

// hashing.pack_hash: (heavy - 2) * 2^62 + ((hi << 32) | lo), wrapping.
BRISK_HD int64_t pack_hash(int64_t heavy, int64_t hi, int64_t lo) {
  const uint64_t key = ((uint64_t)hi << 32) | (uint64_t)lo;
  return (int64_t)(((uint64_t)heavy - 2) * (1ull << 62) + key);
}

BRISK_HD int64_t pack_mini(int64_t lo, int64_t hi) {
  return (int64_t)((uint64_t)lo | ((uint64_t)hi << 32));
}

// a candidate minimizer with its strand flag in bit 63
BRISK_HD int64_t pack_word(int64_t lo, int64_t hi, bool rev) {
  return (int64_t)((uint64_t)pack_mini(lo, hi) | ((uint64_t)rev << 63));
}

BRISK_HD int64_t word_mini(int64_t w) { return w & ~(1ll << 63); }
BRISK_HD bool word_rev(int64_t w) { return w < 0; }

// hashing.unpack_hash: the inverse of pack_hash where heavy is in
// {0, 1, 2} and the key below 2^62.
BRISK_HD void unpack_hash(int64_t h, int64_t& heavy, int64_t& hi,
                          int64_t& lo) {
  const int64_t key = h & kKeyMask;
  heavy = (h >> 62) + 2;
  hi = key >> 32;
  lo = key & kM32;
}

// ---- the state machine (state_scan.cu) --------------------------------

struct ScanState {
  int64_t h;     // packed hash
  int64_t mini;  // packed minimizer
  int64_t pos;
  bool rev;
};

// One emitting position (reference Kmers.cpp:509-613): pos1 = pos + 1;
// expiry = pos1 > km takes the rescan's state (rh, rm, rp, rrev); else a
// candidate hash strictly below h (SIGNED compare) takes the candidate
// (ch, cm, pos 0, crc); else the minimizer ages. Returns expiry ||
// improve, the boundary before the fresh-lane suppression.
BRISK_HD bool scan_step(ScanState& s, int64_t ch, int64_t cm, bool crc,
                        int64_t rh, int64_t rm, int64_t rp, bool rrev,
                        int64_t km) {
  const int64_t pos1 = (int64_t)((uint64_t)s.pos + 1);
  const bool expiry = pos1 > km;
  const bool improve = !expiry && ch < s.h;
  s.mini = expiry ? rm : (improve ? cm : s.mini);
  s.pos = expiry ? rp : (improve ? 0 : pos1);
  s.rev = expiry ? rrev : (improve ? crc : s.rev);
  s.h = expiry ? rh : (improve ? ch : s.h);
  return expiry || improve;
}

// ---- the get_minimizer fold (rescan.cu) -------------------------------

struct FoldState {
  int64_t h;     // packed hash of the running minimum
  int64_t mini;  // packed minimizer
  int64_t pos;
  int64_t cnt;   // offsets tying the running minimum
  bool rev;
};

// The position's own candidate: offset 0.
BRISK_HD FoldState fold_start(int64_t h, int64_t word) {
  return FoldState{h, word_mini(word), 0, 1, word_rev(word)};
}

// Offset i of the window (mirror = W - 1 - i) with candidate (h, word):
// a strictly smaller hash takes the offset (pos i); an equal hash takes
// the mirror when it is closer to the edge than the current pos; at
// equal distance the strand rule clears rev unless the k-mer is
// canonized. `lt` and `eq` are one signed compare each: the packed
// hashes order as the triples do (see the top of this file).
BRISK_HD void fold_offset(FoldState& s, int64_t h, int64_t word, int i,
                          int mirror, bool canon) {
  const bool lt = h < s.h;
  const bool eq = h == s.h;
  const bool take_closer = eq && mirror < s.pos;
  const bool take_strand = eq && mirror == s.pos && !canon;
  const bool take_hash = lt || take_closer;
  const bool take_any = take_hash || take_strand;
  s.cnt = lt ? 1 : (eq ? s.cnt + 1 : s.cnt);
  if (take_any) {
    s.mini = word_mini(word);
    s.pos = lt ? i : mirror;
  }
  s.rev = take_hash ? word_rev(word) : (s.rev && !take_strand);
  if (take_hash) s.h = h;
}

// revcomp._swizzle_byte_local on 32 bits: reverse the 4 bases inside
// each byte, complement.
BRISK_HD uint32_t swizzle32(uint32_t x) {
  x = ((x & 0x0F0F0F0Fu) << 4) | ((x & 0xF0F0F0F0u) >> 4);
  x = ((x & 0x33333333u) << 2) | ((x & 0xCCCCCCCCu) >> 2);
  return x ^ 0xAAAAAAAAu;
}

// revcomp.canonized_k: x <= rcb128_broken(x, n), the broken reverse
// complement (in-byte swizzle of every limb, no byte or limb reversal,
// then a logical right shift by 128 - 2n bits), compared as u128.
BRISK_HD bool canonized(const uint32_t x[4], int n) {
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

// The true reverse complement of a 32-base word.
BRISK_HD uint64_t rc32(uint64_t x) {
  uint64_t r = bswap32((uint32_t)(x >> 32)) |
               ((uint64_t)bswap32((uint32_t)x) << 32);
  r = ((r & 0x0F0F0F0F0F0F0F0Full) << 4) |
      ((r & 0xF0F0F0F0F0F0F0F0ull) >> 4);
  r = ((r & 0x3333333333333333ull) << 2) |
      ((r & 0xCCCCCCCCCCCCCCCCull) >> 2);
  return r ^ 0xAAAAAAAAAAAAAAAAull;
}

// hashing.mix_key: the Thomas-Wang style mixer, every step masked to 2m
// bits, in native uint64 wraparound (also the single-limb path of
// m <= 16, whose masked steps agree with it bit for bit).
BRISK_HD uint64_t mix_key(uint64_t key, uint64_t mask) {
  key = (~key + (key << 21)) & mask;
  key = key ^ (key >> 24);
  key = ((key + (key << 3)) + (key << 8)) & mask;
  key = key ^ (key >> 14);
  key = ((key + (key << 2)) + (key << 4)) & mask;
  key = key ^ (key >> 28);
  key = (key + (key << 31)) & mask;
  return key;
}

// decycling.mem_double of an m-mer seq: 0 decycling set, 1 double set,
// 2 other. R(x) sums coef[4i + base at slot i of x] for i from
// M - 1 down to 1 (slot 0 the first base), in float64, in that order:
// the reference's (decycling._compute_r). The rotation rot =
// (seq & 3) << 2(M-1) | seq >> 2 holds at slot i >= 1 the base of seq
// at slot i - 1, so both sums read the digits of seq, with shifts that
// are constants once M is. Additions only: no multiply exists for FMA
// contraction to fuse, so -fmad cannot change a sum. Keep it so.
template <int M>
BRISK_HD int64_t mem_double(uint64_t seq, const double* coef) {
  double r = 0.0, r_rot = 0.0;
#pragma unroll
  for (int i = M - 1; i >= 1; --i) {
    const int d = (int)((seq >> (2 * (M - 1 - i))) & 3u);
    const int d_rot = (int)((seq >> (2 * (M - i))) & 3u);
    r = dadd_rn(r, coef[4 * i + d]);
    r_rot = dadd_rn(r_rot, coef[4 * i + d_rot]);
  }
  const double eps = 1e-6;
  int64_t cls = 2;
  if (r > eps && r_rot < eps) cls = 0;
  if (r < -eps && r_rot > -eps) cls = 1;
  return cls;
}

// The candidate of a canonical m-mer c whose forward form is mm: its
// packed hash (class, mixed key) and its word (c, rev = c != mm).
template <int M>
BRISK_HD void candidate(uint64_t c, uint64_t mm, const double* coef,
                        int64_t& h, int64_t& word) {
  const uint64_t mask = (1ull << (2 * M)) - 1;
  const uint64_t key = mix_key(c, mask);
  h = (int64_t)(((uint64_t)mem_double<M>(c, coef) - 2) * (1ull << 62) +
                key);
  word = (int64_t)(c | ((uint64_t)(c != mm) << 63));
}

// Truncated offset i, 32 - M < i < 32, of a position whose k-mer has the
// low 64 bits trunc (the reference truncates the k-mer, Kmers.cpp:371):
// the m-mer mm = trunc >> 2i holds the first 32 - i bases of trunc under
// pad = M + i - 32 zero bases (A). Its reverse complement is therefore
// the last 32 - i bases of rc_trunc = rc32(trunc) over pad complements
// of A (the code 2: complementing flips bit 1 of a base), which
// is revcomp.canonize64's rcb64(mm, M), and the canonical m-mer the
// smaller of the two.
template <int M>
BRISK_HD void truncated_candidate(uint64_t trunc, uint64_t rc_trunc, int i,
                                  const double* coef, int64_t& h,
                                  int64_t& word) {
  const int pad = M + i - 32;
  const uint64_t mm = trunc >> (2 * i);
  const uint64_t rc = ((rc_trunc & ((1ull << (2 * (32 - i))) - 1))
                       << (2 * pad)) |
                      (0xAAAAAAAAAAAAAAAAull & ((1ull << (2 * pad)) - 1));
  candidate<M>(mm < rc ? mm : rc, mm, coef, h, word);
}

// Offsets i >= 32: trunc >> 2i is 0, so the candidate is one constant:
// canonical 0 (rcb64(0) > 0), its class and key, rev false.
template <int M>
BRISK_HD void constant_candidate(const double* coef, int64_t& h,
                                 int64_t& word) {
  candidate<M>(0, 0, coef, h, word);
}

}  // namespace brisk
