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

// codec.kmer_windows at one position p of a row: the forward n-mer holds
// the code at p - u at bits 2u, the true reverse complement its
// complement (code ^ 2) at bits 2(n - 1 - u), n = k or m. Positions
// before the row's start add nothing (codec._shift_right_axis
// zero-fills, also under the complement), so the windows of the first
// n - 1 positions are the plain version's too.
struct Windows {
  u128 fwd_k, rc_k;      // k bases, 4 limbs
  uint64_t fwd_m, rc_m;  // m bases, 2 limbs
};

// The windows rolled one code at a time (positions.cu runs a thread
// over several positions): two registers hold the last 64 codes of a row,
// fwd the code at p - u at bits 2u, rc its complement at bits 126 - 2u.
// A roll step shifts each by one code, with constant shifts; the windows
// are the registers' low 2n (fwd) and high 2n (rc) bits, n = k or m, so
// every k, m <= 63 reads the same two registers. Both start at 0 at a
// row's start, so the codes before it read as 0 in both, uncomplemented:
// the zero fill of Windows above.
struct Roll {
  u128 fwd, rc;
};

BRISK_HD void roll(Roll& r, uint32_t code) {
  r.fwd = (r.fwd << 2) | (u128)code;
  r.rc = (r.rc >> 2) | ((u128)(code ^ 2u) << 126);
}

// the Windows of the position rolled in last (m <= 31)
BRISK_HD Windows rolled_windows(const Roll& r, int k, int m) {
  Windows w;
  w.fwd_k = r.fwd & low_bits(2 * k);
  w.rc_k = r.rc >> (128 - 2 * k);
  w.fwd_m = (uint64_t)r.fwd & ((1ull << (2 * m)) - 1);
  w.rc_m = (uint64_t)(r.rc >> (128 - 2 * m));
  return w;
}

// positions.cu's block: kPosThreads threads, each over a run of kPosRun
// consecutive positions of the flat (row, position) order.
constexpr int kPosThreads = 128;
constexpr int kPosRun = 8;

// One thread's run: `count` positions whose codes are at[0, count), the
// first at position p of its row of L. Rolls in the warm = min(p, n - 1)
// codes before it (at[-warm, 0), n = max(k, m): the same row's), then
// each position of the run, from zero again where the run enters the
// next row, and hands sink.put(i, registers) the registers at the run's
// position i.
template <class Sink>
BRISK_HD void roll_run(const uint8_t* at, int p, int warm, int count, int L,
                       Sink& sink) {
  Roll r{0, 0};
  for (int u = warm; u >= 1; --u) roll(r, at[-u]);
  for (int i = 0; i < count; ++i) {
    if (p == L) {
      p = 0;
      r = Roll{0, 0};
    }
    roll(r, at[i]);
    sink.put(i, r);
    ++p;
  }
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
// shift outside [0, 32 NW). Every word index is a constant once the
// loops unroll (a kernel keeps the words in registers): word j moves to
// word j + s / 32 and its high bits to the one above.
template <int NW>
BRISK_HD void shl_words(const uint32_t* x, int64_t s, uint32_t* out) {
  const int w = s >= 0 && s < 32 * NW ? (int)(s >> 5) : NW;
  const int bits = (int)(s & 31);
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint32_t v = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      if (j + w == i) v |= x[j] << bits;
      if (bits && j + w + 1 == i) v |= x[j] >> (32 - bits);
    }
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

// base (2 bits) << s on NW words, 0 outside them; s is even, so the base
// never straddles two words (shl_words of a one-base word).
template <int NW>
BRISK_HD void shl_base(uint32_t base, int64_t s, uint32_t* out) {
  const int w = s >= 0 && s < 32 * NW ? (int)(s >> 5) : NW;
#pragma unroll
  for (int i = 0; i < NW; ++i) out[i] = i == w ? base << (s & 31) : 0u;
}

// The position's disjoint bits of its row's nucleotide words: its
// compacted k-mer (the key with the 2b bucket bits at hole offset
// h = mini_idx + (m - b + 1) / 2 taken out), whole at the row's first
// position (j == 0), else one base; at bits 2d (d = last - p) forward,
// at the row's low end and then one base higher per position in reverse
// (use_rc). Zero where not valid. The one base is the compacted k-mer's
// last (forward) or first (reverse), its bit s read from the key's bit s
// below the hole (s < 2h, both even) or 2b higher above it.
template <int NW>
BRISK_HD void row_contrib(u128 key, int64_t mini_idx, bool use_rc,
                          bool valid, int64_t d, int64_t j, int k, int m,
                          int b, uint32_t* out) {
#pragma unroll
  for (int i = 0; i < NW; ++i) out[i] = 0;
  if (!valid) return;
  const int cs = k - b;
  const int64_t h = mini_idx + (m - b + 1) / 2;
  if (j != 0) {
    const int64_t s = use_rc ? 2 * ((int64_t)cs - 1) : 0;
    const uint32_t base =
        s < 2 * cs ? (uint32_t)shr_var(key, s < 2 * h ? s : s + 2 * b) & 3u
                   : 0u;
    shl_base<NW>(base, use_rc ? 2 * ((int64_t)cs - 1 + j) : 2 * d, out);
    return;
  }
  const u128 hi_part = shl_var(shr_var(key, 2 * (h + b)), 2 * h);
  const u128 lo_part = key & ~shl_var(~(u128)0, 2 * h);
  const u128 cmp = (hi_part | lo_part) & low_bits(2 * cs);
  uint32_t c[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) c[i] = i < 4 ? (uint32_t)(cmp >> (32 * i)) : 0;
  if (use_rc) {
#pragma unroll
    for (int i = 0; i < NW; ++i) out[i] = c[i];
  } else {
    shl_words<NW>(c, 2 * d, out);
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

// ---- skl_rows.cu's runs and scans --------------------------------------
//
// A block walks its lane in tiles of kRowThreads * kRowRun positions;
// each thread owns a run of kRowRun consecutive positions p0 + i. Per
// position a flags byte: bit 0 valid, bit 1 a natural start; the run
// reads kRowRun + 1 of them, the last its successor's (0 past the lane).
// Each scan is a sequential pass over the run, a warp scan of the runs'
// totals and a combine of the warps' totals; the run-local steps and the
// combine operators are here, so that a host build replays the kernel's
// order.
constexpr int kRowThreads = 256;
constexpr int kRowRun = 2;
constexpr int kRowTile = kRowThreads * kRowRun;
constexpr int kBigPos = 0x7FFFFFFF;  // no row last at or after p

constexpr uint8_t kValid = 1, kStart0 = 2;

// The run's last natural start (0 if none): its total of the running max
// that gives first0.
template <int P>
BRISK_HD int run_last_start0(const uint8_t* flags, int p0) {
  int last = 0;
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (flags[i] & kStart0) last = p0 + i;
  return last;
}

// Bit i: position p0 + i starts a row (i <= P: bit P is the successor's),
// from first0 before the run (the last natural start before p0, 0 if
// none).
template <int P>
BRISK_HD uint32_t run_starts(const uint8_t* flags, int p0, int first0,
                             bool split, int s_max) {
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i <= P; ++i) {
    const bool s0 = (flags[i] & kStart0) != 0;
    if (s0) first0 = p0 + i;
    if (row_start(s0, (flags[i] & kValid) != 0, p0 + i, first0, split,
                  s_max))
      bits |= 1u << i;
  }
  return bits;
}

// Bit i (i < P): position p0 + i is its row's last: valid, and the next
// position is not valid or starts a row.
template <int P>
BRISK_HD uint32_t run_lasts(const uint8_t* flags, uint32_t starts) {
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < P; ++i)
    if ((flags[i] & kValid) &&
        (!(flags[i + 1] & kValid) || (starts >> (i + 1) & 1u)))
      bits |= 1u << i;
  return bits;
}

// The run's totals of the (first_pos, rank) scan: its last start (0 if
// none) and its start count.
template <int P>
BRISK_HD void run_start_totals(uint32_t starts, int p0, int& last_start,
                               int& n_starts) {
  last_start = 0;
  n_starts = 0;
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (starts >> i & 1u) {
      last_start = p0 + i;
      ++n_starts;
    }
}

// first_pos (the last start at or before p) and rank (the starts before p)
// at each position, from their values before the run.
template <int P>
BRISK_HD void run_first_rank(uint32_t starts, int p0, int first_pos,
                             int rank, int* fp, int* rk) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const bool s = starts >> i & 1u;
    if (s) first_pos = p0 + i;
    fp[i] = first_pos;
    rk[i] = rank;
    rank += s;
  }
}

// The run's first row last (kBigPos if none): its total of the running
// min from the right.
template <int P>
BRISK_HD int run_first_last(uint32_t lasts, int p0) {
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (lasts >> i & 1u) return p0 + i;
  return kBigPos;
}

// last_pos (the first row last at or after p) at each position, from the
// value after the run.
template <int P>
BRISK_HD void run_last_pos(uint32_t lasts, int p0, int after, int* lp) {
#pragma unroll
  for (int i = P - 1; i >= 0; --i) {
    if (lasts >> i & 1u) after = p0 + i;
    lp[i] = after;
  }
}

// An element of the segmented suffix sum of the row words: the u32 sum of
// the contributions from a range's first position up to and including
// its first row last (all of the range if it holds none, `last` false).
// Inside [p, last_pos(p)] lie one row's positions (and invalid ones, which
// add 0), whose contributions take disjoint bits, so the u32 sum is the
// plain version's int64 suffix difference bit for bit; past a lane's last
// row it is 0.
template <int NW>
struct Seg {
  bool last;
  uint32_t w[NW];
};

// a's range just before b's
template <int NW>
BRISK_HD Seg<NW> seg_combine(const Seg<NW>& a, const Seg<NW>& b) {
  Seg<NW> s;
  s.last = a.last || b.last;
#pragma unroll
  for (int i = 0; i < NW; ++i) s.w[i] = a.w[i] + (a.last ? 0u : b.w[i]);
  return s;
}

// The run's sums from each position (agg[i], before the value after the
// run is added where `reach` bit i says the row runs on past the run) and
// its total for the scan (agg from p0).
template <int P, int NW>
BRISK_HD Seg<NW> run_seg(const uint32_t (*contrib)[NW], uint32_t lasts,
                         uint32_t (*agg)[NW], uint32_t& reach) {
  Seg<NW> acc;
  acc.last = false;
#pragma unroll
  for (int w = 0; w < NW; ++w) acc.w[w] = 0;
  reach = 0;
#pragma unroll
  for (int i = P - 1; i >= 0; --i) {
    if (lasts >> i & 1u) {
      acc.last = true;
#pragma unroll
      for (int w = 0; w < NW; ++w) acc.w[w] = 0;
    }
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      acc.w[w] += contrib[i][w];
      agg[i][w] = acc.w[w];
    }
    if (!acc.last) reach |= 1u << i;
  }
  return acc;
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
