// Arithmetic of the flush's three per-position and per-lane kernels
// (positions.cu, emit.cu, skl_rows.cu): the k- and m-base windows that
// end at a position and their candidate, the emitted k-mer with its
// hashed minimizer slice and bucket, and a super-k-mer row's
// contribution and meta. Every function is __host__ __device__ and keeps
// the plain PyTorch versions' integer contract bit for bit, so a host
// compiler builds this header too (with plain C++ definitions of the
// CUDA qualifiers): tests/test_torch_flush_math.py holds it to
// ops.minimizer.position_pipeline_torch, ops.enumerate._emit_torch and
// index.sklstore.rows_from_emissions_torch on the CPU.
//
// 128-bit values are unsigned __int128 (nvcc and g++ both have it); the
// plain versions' u32 limbs are its four 32-bit words, limb 0 lowest.
// Variable shifts follow ops.u128.shl_var / shr_var: a shift outside
// [0, 128) gives 0.

#pragma once

#include <cstdint>

#include "enum_math.cuh"

namespace brisk {

using u128 = unsigned __int128;

constexpr int kMaxNW = 6;  // u32 words of a super-k-mer row's nucleotides
constexpr int64_t kInvalid = kM32;  // the dead-row bucket

BRISK_HD u128 from_limbs(int64_t l0, int64_t l1, int64_t l2, int64_t l3) {
  return (u128)(uint32_t)l0 | ((u128)(uint32_t)l1 << 32) |
         ((u128)(uint32_t)l2 << 64) | ((u128)(uint32_t)l3 << 96);
}

BRISK_HD int64_t limb(u128 x, int i) {
  return (int64_t)(uint32_t)(x >> (32 * i));
}

// the low n bits set (n in [0, 128])
BRISK_HD u128 low_bits(int n) {
  return n >= 128 ? ~(u128)0 : (((u128)1 << n) - 1);
}

BRISK_HD u128 shl_var(u128 x, int64_t s) {
  return (s >= 0 && s < 128) ? x << s : (u128)0;
}

BRISK_HD u128 shr_var(u128 x, int64_t s) {
  return (s >= 0 && s < 128) ? x >> s : (u128)0;
}

// ---- the windows and the candidate of a position (positions.cu) ------

// codec.kmer_windows at one position p of a row: at[-u] is the code at
// p - u (u <= p), each in [0, 4). The forward n-mer ORs the code at p - u
// at bits 2u; the true reverse complement ORs its complement (code ^ 2)
// at bits 2(n - 1 - u). Positions before the row's start add nothing
// (codec._shift_right_axis zero-fills, also under the complement), so the
// windows of the first n - 1 positions are the plain version's too.
struct Windows {
  u128 fwd_k, rc_k;      // k bases, 4 limbs
  uint64_t fwd_m, rc_m;  // m bases, 2 limbs
};

BRISK_HD Windows windows(const uint8_t* at, int p, int k, int m) {
  Windows w{0, 0, 0, 0};
  const int n = k > m ? k : m;
  for (int u = 0; u < n && u <= p; ++u) {
    const uint64_t c = at[-u];
    const uint64_t cc = c ^ 2u;
    if (u < k) {
      w.fwd_k |= (u128)c << (2 * u);
      w.rc_k |= (u128)cc << (2 * (k - 1 - u));
    }
    if (u < m) {
      w.fwd_m |= c << (2 * u);
      w.rc_m |= cc << (2 * (m - 1 - u));
    }
  }
  return w;
}

// minimizer.position_pipeline past the windows: the canonical m-mer (the
// smaller of the two strands), its hash triple (hashing.bfc_hash: the
// decycling class, the 2m-bit mixed key as hi, lo) and the two strand
// flags.
struct Candidate {
  uint64_t canon;
  int64_t heavy, hhi, hlo;
  bool is_rc;     // canon == rc_m
  bool scan_rev;  // canon != fwd_m
};

template <int M>
BRISK_HD Candidate position_candidate(uint64_t fwd_m, uint64_t rc_m,
                                      const double* coef) {
  Candidate c;
  c.canon = fwd_m < rc_m ? fwd_m : rc_m;
  const uint64_t key = mix_key(c.canon, (1ull << (2 * M)) - 1);
  c.heavy = mem_double<M>(c.canon, coef);
  c.hhi = (int64_t)(key >> 32);
  c.hlo = (int64_t)(key & (uint64_t)kM32);
  c.is_rc = c.canon == rc_m;
  c.scan_rev = c.canon != fwd_m;
  return c;
}

// ---- the emission epilogue (emit.cu) ---------------------------------

// enumerate._emit_torch at one emitting position, from the state
// machine's outputs there (rev, pos, the packed minimizer and hash) and
// the position's two k-mer strands.
struct Emitted {
  int64_t mini_idx, mini_lo, mini_hi, hash_hi, hash_lo, bucket;
  u128 kmer, key;
};

BRISK_HD Emitted emit_position(bool rev, int64_t pos, int64_t mini,
                               int64_t h, u128 fwd, u128 rc, int km, int m,
                               int b) {
  Emitted e;
  e.mini_idx = rev ? (int64_t)km - pos : pos;
  e.mini_lo = mini & kM32;
  e.mini_hi = mini >> 32;
  const int64_t key = h & kKeyMask;  // hashing.unpack_hash, no heavy
  e.hash_hi = key >> 32;
  e.hash_lo = key & kM32;
  e.kmer = rev ? rc : fwd;
  // the slice at the minimizer's index of the EMITTED k-mer, mixed
  // (hash_kmer_minimizer_inplace, Kmers.cpp:191-200), written back over
  // its 2m-bit hole
  const int64_t shift = 2 * e.mini_idx;
  const u128 mask = low_bits(2 * m);
  const uint64_t slice = (uint64_t)(shr_var(e.kmer, shift) & mask);
  const uint64_t mixed = mix_key(slice, (uint64_t)mask);
  e.key = (e.kmer & ~shl_var(mask, shift)) | shl_var((u128)mixed, shift);
  // the reduced minimizer: drop (m - b + 1) / 2 suffix bases, keep 2b bits
  const int suffix_reduc = (m - b + 1) / 2;
  e.bucket = (int64_t)((mixed >> (2 * suffix_reduc)) &
                       ((1ull << (2 * b)) - 1));
  return e;
}

// ---- super-k-mer rows (skl_rows.cu) ----------------------------------

// ops.u128.shl_var on NW u32 words: (x << s) mod 2^(32 NW), 0 for a
// shift outside [0, 32 NW).
template <int NW>
BRISK_HD void shl_words(const uint32_t* x, int64_t s, uint32_t* out) {
  for (int i = 0; i < NW; ++i) out[i] = 0;
  if (s < 0 || s >= 32 * NW) return;
  const int w = (int)(s >> 5), bits = (int)(s & 31);
  for (int i = w; i < NW; ++i) {
    uint32_t v = x[i - w] << bits;
    if (bits && i - w >= 1) v |= x[i - w - 1] >> (32 - bits);
    out[i] = v;
  }
}

// A row starts where a valid emission follows a boundary or is its
// lane's first; past a split (2(k - m) + 1 > s_max) also every s_max-th
// valid position counted from the last natural start at or before p,
// first0 (0 if none).
BRISK_HD bool natural_start(bool valid, bool boundary, bool first_valid) {
  return valid && (boundary || first_valid);
}

BRISK_HD bool row_start(bool start0, bool valid, int64_t p, int64_t first0,
                        bool split, int s_max) {
  return start0 || (split && valid && ((p - first0) & (s_max - 1)) == 0);
}

// The position's disjoint bits of its row's nucleotide words: its
// compacted k-mer (the key with the 2b bucket bits at hole offset
// h = mini_idx + (m - b + 1) / 2 taken out), whole at the row's first
// position (j == 0), else one base; at bits 2d (d = last - p) forward,
// at the row's low end and then one base higher per position in reverse
// (use_rc). Zero where not valid.
template <int NW>
BRISK_HD void row_contrib(u128 key, int64_t mini_idx, bool use_rc,
                          bool valid, int64_t d, int64_t j, int k, int m,
                          int b, uint32_t* out) {
  for (int i = 0; i < NW; ++i) out[i] = 0;
  if (!valid) return;
  const int cs = k - b;
  const int64_t h = mini_idx + (m - b + 1) / 2;
  const u128 hi_part = shl_var(shr_var(key, 2 * (h + b)), 2 * h);
  const u128 lo_part = key & ~shl_var(~(u128)0, 2 * h);
  const u128 cmp = (hi_part | lo_part) & low_bits(2 * cs);
  uint32_t c[NW];
  for (int i = 0; i < NW; ++i) c[i] = i < 4 ? (uint32_t)(cmp >> (32 * i)) : 0;
  uint32_t base[NW];
  for (int i = 0; i < NW; ++i) base[i] = 0;
  if (use_rc) {
    if (j == 0) {
      for (int i = 0; i < NW; ++i) out[i] = c[i];
    } else {
      base[0] = (uint32_t)(cmp >> (2 * (cs - 1))) & 3u;
      shl_words<NW>(base, 2 * ((int64_t)cs - 1 + j), out);
    }
  } else if (j == 0) {
    shl_words<NW>(c, 2 * d, out);
  } else {
    base[0] = c[0] & 3u;
    shl_words<NW>(base, 2 * d, out);
  }
}

// meta = size | mini_last << 8: size d + 1 at a row's start, else 0;
// mini_last the row's largest hole offset (h, or h + d forward)
BRISK_HD int64_t row_meta(bool start, int64_t mini_idx, bool use_rc,
                          int64_t d, int m, int b) {
  const int64_t h = mini_idx + (m - b + 1) / 2;
  const int64_t size = start ? d + 1 : 0;
  const int64_t last = use_rc ? h : h + d;
  return size | (int64_t)((uint64_t)last << 8);
}

// The output slot of position p: a kept start (no overflow) goes to its
// rank among the lane's starts; any other position follows them in
// position order (the plain version's stable sort of where(keep, p,
// BIG)), so its slot is n_start + its rank among the others, or p in an
// overflowing lane, which keeps none.
BRISK_HD int64_t row_slot(bool start, bool overflow, int64_t rank,
                          int64_t n_start, int64_t p) {
  if (overflow) return p;
  return start ? rank : n_start + p - rank;
}

}  // namespace brisk
