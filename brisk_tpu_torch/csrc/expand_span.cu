// Span expansion kernel for Hopper (sm_90a): compacted super-k-mer rows
// -> per-slot packed k-mer keys, J-major or row-major.
//
// Replaces the TPU kernel brisk_tpu/index/sklstore.py
// _expand_span_jmajor_pallas (pl.pallas_call body _expand_j_words +
// store.make_key_words); the row-major layout is the function of the
// reference's _expand_span. Plain PyTorch versions beside it:
// brisk_tpu_torch.index.sklstore._expand_span_jmajor_torch and
// _expand_span_rowmajor_torch.
//
// For span row r and slot j < s_max: take 2(k-b) bits of the row's
// nucleotides at offset 2(size-1-j), re-insert the 2b bucket bits at hole
// h = mini - (size-1-j), and pack bucket | kmer | (h - suffix_reduc) into
// W big-endian u32 words, written at out[w][j*R + r] (J-major) or
// out[w][r*s_max + j] (row-major). A dead row (bucket 0xFFFFFFFF) or a
// slot j >= size gives all words 0xFFFFFFFF.
//
// What bounds it on this card. Memory: per row it reads 4*(2 + nw) bytes
// and writes 4*W*s_max (k=31: 16 B read, 96 B written), 0.94 GB at
// R = 2^23 rows, 0.28 ms at 3.35 TB/s. The first version redid about ten
// variable 128/192-bit shifts and masks for every slot (~330 SASS
// instructions in the per-slot loop), so it was bound by instruction
// issue at ~35% of that bound, while a fill_ of the same output runs at
// the bound. The design removes the per-slot arithmetic and widens the
// memory operations:
//
// * Per-row super-k-mer rebuild. For a REGULAR row (below) the kernel
//   re-inserts the bucket into the nucleotides once, at bit 2*mini:
//     S = (N mod 4^mini) | bucket << 2mini | (N div 4^mini) << (2mini+2b),
//   and every slot's k-mer is the 2k-bit window of S at offset 2d,
//   d = size-1-j. Why: with h = mini - d >= 0, S >> 2d holds in bits
//   [0, 2h) the bits [2d, 2mini) of N, i.e. the low 2h bits of the
//   window win = N >> 2d; at 2h the bucket; from 2h+2b on
//   (N >> 2mini) << (2h+2b) = (win >> 2h) << (2h+2b). That is exactly
//   low | mid | high of the per-slot code, before its final mask to 2k
//   bits. The per-slot code masks win to 2cs = 2(k-b) bits first; the
//   mask changes nothing when h <= cs (low takes only bits below
//   2h <= 2cs, and high's bits from 2cs on land at 2k or above, which
//   the final mask drops). So the k-mer of slot j is
//   (S >> 2d) mod 4^k whenever 0 <= mini - d <= cs for every live slot,
//   i.e. size - 1 <= mini <= cs. With K = S << 8, the packed key is
//     ((K >> 2d) & M) | bucket << (8+2k) | (h - suffix_reduc),
//   M the bits [8, 8+2k): per output word one funnel shift and one
//   three-input logic op, the mini field one add.
// * REGULAR means: live (bucket != 0xFFFFFFFF), bucket < 4^b,
//   1 <= size <= s_max and size - 1 <= mini <= cs. Every row the insert
//   writes is regular. Any other live row (garbage meta: shifts that wrap
//   the u32 hole offset or pass 128 bits) takes the per-slot code of the
//   first version, slot_word() below, on a per-row branch, so the kernel
//   matches its plain version bit for bit on any input.
// * 16-byte memory operations. A thread takes 4 consecutive rows: it
//   loads bucket, meta and each nucleotide plane as one uint4. J-major
//   writes one uint4 per (w, j) plane, 512 contiguous bytes per warp.
//   Row-major rows own s_max consecutive words of each plane, so a
//   thread's own 4 rows would be 128 contiguous bytes per thread and a
//   warp store would touch 32 lines at 16 B each; instead each plane
//   goes through a shared tile and the block writes its contiguous run
//   with consecutive threads on consecutive uint4 (emit_tiled). Stores
//   are evict-first (__stcs): the output is larger than the 50 MB L2
//   and never read back here. When R is not a multiple of 4 or a pointer
//   is not 16-byte aligned, the same code stores word by word.
// Tensor cores have no role in this bit manipulation.
//
// Shifts reproduce brisk_tpu.ops.u128.shl_var/shr_var exactly: a shift by
// the full width or more gives 0, and no C++ shift is ever by 0 across a
// word boundary or by 64 or more (undefined behaviour). All u32 offset
// arithmetic wraps like the reference's uint32 math.
//
// One library per s_max: the build passes -DBRISK_S_MAX=<s_max>
// (sklstore.skl_dims: min(2(k-m)+1, 8); 8 unless m >= k-3), and the
// library holds the two layouts at that s_max alone.

#include <cstdint>
#include <cuda_runtime.h>

#ifndef BRISK_S_MAX
#error "build with -DBRISK_S_MAX=<s_max>"
#endif
static_assert(BRISK_S_MAX >= 1 && BRISK_S_MAX <= 8,
              "s_max in [1, 8]: key_word's funnel shift is by 2d <= 14");

namespace {

constexpr int kSMax = BRISK_S_MAX;
constexpr uint32_t kInvalid = 0xFFFFFFFFu;
constexpr int kRows = 4;  // rows per thread (one uint4 of each column)
constexpr int kThreads = 256;

struct U128 {
  uint64_t lo, hi;
};

struct U192 {
  uint64_t w0, w1, w2;  // little-endian 64-bit words
};

struct Params {
  int R, k, m, b, nw, W, vec;
  uint32_t cs, suffix_reduc;
  uint32_t qc, rc;     // bucket position 8+2k as (word, bit)
  uint32_t mask[6];    // little-endian words of the bits [8, 8+2k)
};

__device__ __forceinline__ U128 shl128(U128 x, uint32_t s) {
  if (s >= 128u) return {0ull, 0ull};
  if (s >= 64u) return {0ull, x.lo << (s - 64u)};
  if (s == 0u) return x;
  return {x.lo << s, (x.hi << s) | (x.lo >> (64u - s))};
}

__device__ __forceinline__ U128 shr128(U128 x, uint32_t s) {
  if (s >= 128u) return {0ull, 0ull};
  if (s >= 64u) return {x.hi >> (s - 64u), 0ull};
  if (s == 0u) return x;
  return {(x.lo >> s) | (x.hi << (64u - s)), x.hi >> s};
}

__device__ __forceinline__ U128 mask128(U128 x, uint32_t bits) {
  if (bits >= 128u) return x;
  if (bits >= 64u) {
    uint32_t hb = bits - 64u;
    return {x.lo, hb ? (x.hi & ((1ull << hb) - 1ull)) : 0ull};
  }
  return {bits ? (x.lo & ((1ull << bits) - 1ull)) : 0ull, 0ull};
}

// low 128 bits of (x >> s) for a 192-bit x (nucleotide words, nw <= 6)
__device__ __forceinline__ U128 shr192_lo(U192 x, uint32_t s) {
  if (s >= 192u) return {0ull, 0ull};
  uint64_t a, b, c;  // x shifted by whole 64-bit words
  uint32_t q = s >> 6, r = s & 63u;
  if (q == 0u) {
    a = x.w0; b = x.w1; c = x.w2;
  } else if (q == 1u) {
    a = x.w1; b = x.w2; c = 0ull;
  } else {
    a = x.w2; b = 0ull; c = 0ull;
  }
  if (r == 0u) return {a, b};
  return {(a >> r) | (b << (64u - r)), (b >> r) | (c << (64u - r))};
}

// x |= (v << s) for a 192-bit accumulator, v a 128-bit value, s < 192
__device__ __forceinline__ void or_shl192(U192& x, U128 v, uint32_t s) {
  uint64_t a = v.lo, b = v.hi, c = 0ull;
  uint32_t q = s >> 6, r = s & 63u;
  if (r != 0u) {
    c = b >> (64u - r);
    b = (b << r) | (a >> (64u - r));
    a = a << r;
  }
  if (q == 0u) {
    x.w0 |= a; x.w1 |= b; x.w2 |= c;
  } else if (q == 1u) {
    x.w1 |= a; x.w2 |= b;
  } else if (q == 2u) {
    x.w2 |= a;
  }
}

// x << s over 192 bits (bits shifted past 192 are dropped), s < 192
__device__ __forceinline__ U192 shl192(U192 x, uint32_t s) {
  uint32_t q = s >> 6, r = s & 63u;
  uint64_t a = x.w0, b = x.w1, c = x.w2;
  if (r != 0u) {
    c = (c << r) | (b >> (64u - r));
    b = (b << r) | (a >> (64u - r));
    a = a << r;
  }
  if (q == 0u) return {a, b, c};
  if (q == 1u) return {0ull, a, b};
  return {0ull, 0ull, a};
}

// (x >> s) << s over 192 bits: x with its low s bits cleared, s < 192
__device__ __forceinline__ U192 clear_low192(U192 x, uint32_t s) {
  uint32_t q = s >> 6, r = s & 63u;
  uint64_t m = r ? (~0ull << r) : ~0ull;
  if (q == 0u) return {x.w0 & m, x.w1, x.w2};
  if (q == 1u) return {0ull, x.w1 & m, x.w2};
  return {0ull, 0ull, x.w2 & m};
}

__device__ __forceinline__ uint32_t word32(const U192& x, int i) {
  uint64_t w = (i < 2) ? x.w0 : ((i < 4) ? x.w1 : x.w2);
  return (uint32_t)(w >> ((i & 1) * 32));
}

// The per-slot code (the first version of this kernel): little-endian
// key word `w` of slot j of row r, exact for any row. It reads the row
// again from the inputs; only threads that hold a row that is not
// regular run it (slow_rows, slow_tile).
__device__ __forceinline__ uint32_t slot_word(const uint32_t* bucket,
                                              const uint32_t* meta,
                                              const uint32_t* nucs, int r,
                                              uint32_t J, int w,
                                              const Params& p) {
  const uint32_t bk = bucket[r];
  const uint32_t mt = meta[r];
  const uint32_t size = mt & 0xFFu;
  const uint32_t mini = (mt >> 8) & 0xFFu;
  if (bk == kInvalid || J >= size) return kInvalid;
  uint32_t nu[6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
    nu[i] = i < p.nw ? nucs[(size_t)i * p.R + r] : 0u;
  const U192 n192 = {(uint64_t)nu[0] | ((uint64_t)nu[1] << 32),
                     (uint64_t)nu[2] | ((uint64_t)nu[3] << 32),
                     (uint64_t)nu[4] | ((uint64_t)nu[5] << 32)};
  const uint32_t d = size - 1u - J;
  const U128 win = mask128(shr192_lo(n192, 2u * d), 2u * p.cs);
  const uint32_t h = mini - d;  // u32 wraparound
  const uint32_t sh_h = 2u * h;
  const U128 ones = {~0ull, ~0ull};
  const U128 mask = shl128(ones, sh_h);
  const U128 low = {win.lo & ~mask.lo, win.hi & ~mask.hi};
  const U128 high = shl128(shr128(win, sh_h), sh_h + 2u * (uint32_t)p.b);
  const U128 mid = shl128(U128{(uint64_t)bk, 0ull}, sh_h);
  const U128 kmer = mask128(
      U128{low.lo | high.lo | mid.lo, low.hi | high.hi | mid.hi},
      2u * (uint32_t)p.k);
  // bucket | kmer | mini_idx, little-endian over 192 bits
  U192 key = {(uint64_t)(h - p.suffix_reduc), 0ull, 0ull};
  or_shl192(key, kmer, 8u);
  or_shl192(key, U128{(uint64_t)bk, 0ull}, 8u + 2u * (uint32_t)p.k);
  return word32(key, w);
}

struct Span {  // the kernel's inputs and output
  const uint32_t* bucket;
  const uint32_t* meta;
  const uint32_t* nucs;
  uint32_t* out;
};

// Output word index of (row r, slot j) in one key-word plane.
template <int LAYOUT, int S_MAX>
__device__ __forceinline__ size_t slot_index(int r, int j, int R) {
  return LAYOUT == 0 ? (size_t)j * R + r : (size_t)r * S_MAX + j;
}

// A thread holding a row that is not regular writes all its rows with
// the per-slot code, word by word. Out of line: it runs only on garbage
// input, and keeps the fast path free of calls.
template <int LAYOUT, int S_MAX>
__device__ __noinline__ void slow_rows(const Span sp, int r0,
                                       const Params p) {
  for (int i = 0; i < kRows; ++i) {
    const int r = r0 + i;
    if (r >= p.R) break;
    for (int w = 0; w < p.W; ++w) {
      uint32_t* plane = sp.out + (size_t)(p.W - 1 - w) * S_MAX * p.R;
      for (int j = 0; j < S_MAX; ++j)
        plane[slot_index<LAYOUT, S_MAX>(r, j, p.R)] =
            slot_word(sp.bucket, sp.meta, sp.nucs, r, j, w, p);
    }
  }
}

// One row, ready to emit its slots.
struct Row {
  uint32_t kw[7];       // K = S << 8 as little-endian u32 words (regular)
  uint32_t c_lo, c_hi;  // bucket << rc, spilling into word qc + 1
  uint32_t fm0;         // mini field of slot 0: mini-(size-1)-suffix_reduc
  uint32_t size;        // live slots of a regular row; 0 if dead
  bool slow;            // live but not regular: per-slot code
};

__device__ __forceinline__ Row make_row(uint32_t bk, uint32_t mt,
                                        const uint32_t (&nu)[6],
                                        const Params& p, int S_MAX) {
  Row row;
  const uint32_t size = mt & 0xFFu;
  const uint32_t mini = (mt >> 8) & 0xFFu;
  const bool live = bk != kInvalid;
  const bool regular = live && (uint64_t)bk < (1ull << (2 * p.b)) &&
                       size >= 1u && size <= (uint32_t)S_MAX &&
                       mini + 1u >= size && mini <= p.cs;
  row.slow = live && !regular;
  row.size = regular ? size : 0u;
  row.fm0 = mini - (size - 1u) - p.suffix_reduc;
  row.c_lo = bk << p.rc;
  row.c_hi = p.rc ? (bk >> (32u - p.rc)) : 0u;
  const U192 n = {(uint64_t)nu[0] | ((uint64_t)nu[1] << 32),
                  (uint64_t)nu[2] | ((uint64_t)nu[3] << 32),
                  (uint64_t)nu[4] | ((uint64_t)nu[5] << 32)};
  const uint32_t s = regular ? 2u * mini : 0u;  // <= 2cs < 128
  const U192 hi = clear_low192(n, s);
  const U192 lo = {n.w0 ^ hi.w0, n.w1 ^ hi.w1, n.w2 ^ hi.w2};
  const U192 a = shl192(lo, 8u);
  const U192 c = shl192(hi, 8u + 2u * (uint32_t)p.b);
  const U192 bb = shl192(U192{(uint64_t)bk, 0ull, 0ull}, 8u + s);
  const U192 K = {a.w0 | c.w0 | bb.w0, a.w1 | c.w1 | bb.w1,
                  a.w2 | c.w2 | bb.w2};
#pragma unroll
  for (int i = 0; i < 6; ++i) row.kw[i] = word32(K, i);
  row.kw[6] = 0u;
  return row;
}

// Little-endian key word w (compile-time) of slot j of a regular or
// dead row.
template <int w>
__device__ __forceinline__ uint32_t key_word(const Row& row, uint32_t j,
                                             const Params& p) {
  if (j >= row.size) return kInvalid;
  const uint32_t sh = 2u * (row.size - 1u - j);  // 2d <= 14
  const uint32_t f = __funnelshift_r(row.kw[w], row.kw[w + 1], sh);
  const uint32_t c = ((uint32_t)w == p.qc) ? row.c_lo
                     : ((uint32_t)w == p.qc + 1u) ? row.c_hi : 0u;
  uint32_t v = (f & p.mask[w]) | c;
  if (w == 0) v |= row.fm0 + j;  // mini field: h - suffix_reduc
  return v;
}

// Plane w of the thread's 4 rows, straight to device memory: one uint4
// per slot in J-major (16-byte aligned when p.vec), word by word in
// row-major without p.vec.
template <int w, int LAYOUT, int S_MAX>
__device__ __forceinline__ void emit_direct(const Row (&rows)[kRows],
                                            const Span& sp, int r0,
                                            const Params& p) {
  if (w >= p.W) return;
  uint32_t* plane = sp.out + (size_t)(p.W - 1 - w) * S_MAX * p.R;
#pragma unroll
  for (int j = 0; j < S_MAX; ++j) {
    uint32_t v[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) v[i] = key_word<w>(rows[i], j, p);
    if (LAYOUT == 0 && p.vec) {
      __stcs(reinterpret_cast<uint4*>(plane + (size_t)j * p.R + r0),
             make_uint4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        if (r0 + i < p.R)
          __stcs(plane + slot_index<LAYOUT, S_MAX>(r0 + i, j, p.R), v[i]);
    }
  }
}

// Row-major, 16-byte aligned: the block's rows own one contiguous run of
// kThreads*4*S_MAX words in each plane. Each thread puts its 4*S_MAX
// words (S_MAX uint4 chunks) into a shared tile, chunk q of thread t at
// q*(kThreads+1) + t (the pad keeps both sides free of bank conflicts),
// then the block writes the run with consecutive threads on consecutive
// uint4: 512 contiguous bytes per warp store.
constexpr int kTilePitch = kThreads + 1;

template <int S_MAX>
__device__ __noinline__ void slow_tile(uint4* tile, const Span sp, int r0,
                                       int w, const Params p) {
  for (int q = 0; q < S_MAX; ++q) {
    uint32_t v[4];
    for (int e = 0; e < 4; ++e) {
      const int i = (4 * q + e) / S_MAX, j = (4 * q + e) % S_MAX;
      v[e] = r0 + i < p.R
                 ? slot_word(sp.bucket, sp.meta, sp.nucs, r0 + i, j, w, p)
                 : kInvalid;
    }
    tile[q * kTilePitch + threadIdx.x] = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

template <int w, int S_MAX>
__device__ __forceinline__ void emit_tiled(const Row (&rows)[kRows],
                                           bool slow, uint4* tile,
                                           const Span& sp, int r0,
                                           const Params& p) {
  if (w >= p.W) return;  // uniform: every thread of the block returns
  if (slow) {
    slow_tile<S_MAX>(tile, sp, r0, w, p);
  } else {
    uint32_t v[kRows * S_MAX];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < S_MAX; ++j)
        v[i * S_MAX + j] = key_word<w>(rows[i], j, p);
#pragma unroll
    for (int q = 0; q < S_MAX; ++q)
      tile[q * kTilePitch + threadIdx.x] =
          make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
  __syncthreads();
  const int row0 = blockIdx.x * kThreads * kRows;
  const int rows_here = min(kThreads * kRows, p.R - row0);
  const int chunks = rows_here * S_MAX / 4;  // p.R % 4 == 0 here
  uint4* run = reinterpret_cast<uint4*>(
      sp.out + (size_t)(p.W - 1 - w) * S_MAX * p.R + (size_t)row0 * S_MAX);
#pragma unroll
  for (int i = 0; i < S_MAX; ++i) {
    const int c = threadIdx.x + kThreads * i;
    if (c < chunks)
      __stcs(run + c, tile[(c % S_MAX) * kTilePitch + c / S_MAX]);
  }
  __syncthreads();
}

template <int LAYOUT, int S_MAX>
__global__ void __launch_bounds__(kThreads)
expand_span_kernel(const uint32_t* __restrict__ bucket,
                   const uint32_t* __restrict__ meta,
                   const uint32_t* __restrict__ nucs,
                   uint32_t* __restrict__ out, const Params p) {
  const int r0 = (blockIdx.x * kThreads + threadIdx.x) * kRows;
  const bool tiled = LAYOUT == 1 && p.vec;  // uniform over the grid
  if (r0 >= p.R && !tiled) return;  // ragged last block
  uint32_t bk[kRows], mt[kRows], nu[kRows][6];
  if (p.vec && r0 < p.R) {
    const uint4 b4 = __ldg(reinterpret_cast<const uint4*>(bucket + r0));
    const uint4 m4 = __ldg(reinterpret_cast<const uint4*>(meta + r0));
    bk[0] = b4.x; bk[1] = b4.y; bk[2] = b4.z; bk[3] = b4.w;
    mt[0] = m4.x; mt[1] = m4.y; mt[2] = m4.z; mt[3] = m4.w;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      uint4 n4 = make_uint4(0u, 0u, 0u, 0u);
      if (i < p.nw)
        n4 = __ldg(reinterpret_cast<const uint4*>(nucs + (size_t)i * p.R +
                                                  r0));
      nu[0][i] = n4.x; nu[1][i] = n4.y; nu[2][i] = n4.z; nu[3][i] = n4.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool in = r0 + r < p.R;
      bk[r] = in ? bucket[r0 + r] : kInvalid;
      mt[r] = in ? meta[r0 + r] : 0u;
#pragma unroll
      for (int i = 0; i < 6; ++i)
        nu[r][i] = (in && i < p.nw) ? nucs[(size_t)i * p.R + r0 + r] : 0u;
    }
  }
  Row rows[kRows];
  bool slow = false;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    rows[r] = make_row(bk[r], mt[r], nu[r], p, S_MAX);
    slow = slow || rows[r].slow;
  }
  const Span sp = {bucket, meta, nucs, out};
  if (tiled) {
    __shared__ uint4 tile[S_MAX * kTilePitch];
    emit_tiled<0, S_MAX>(rows, slow, tile, sp, r0, p);
    emit_tiled<1, S_MAX>(rows, slow, tile, sp, r0, p);
    emit_tiled<2, S_MAX>(rows, slow, tile, sp, r0, p);
    emit_tiled<3, S_MAX>(rows, slow, tile, sp, r0, p);
    emit_tiled<4, S_MAX>(rows, slow, tile, sp, r0, p);
    emit_tiled<5, S_MAX>(rows, slow, tile, sp, r0, p);
    return;
  }
  if (slow) {
    slow_rows<LAYOUT, S_MAX>(sp, r0, p);
    return;
  }
  emit_direct<0, LAYOUT, S_MAX>(rows, sp, r0, p);
  emit_direct<1, LAYOUT, S_MAX>(rows, sp, r0, p);
  emit_direct<2, LAYOUT, S_MAX>(rows, sp, r0, p);
  emit_direct<3, LAYOUT, S_MAX>(rows, sp, r0, p);
  emit_direct<4, LAYOUT, S_MAX>(rows, sp, r0, p);
  emit_direct<5, LAYOUT, S_MAX>(rows, sp, r0, p);
}

}  // namespace

// layout 0: J-major (slot j*R + r); 1: row-major (slot r*s_max + j).
// Returns a cudaError_t: the launch's, or cudaErrorInvalidValue for an
// unsupported shape (s_max other than this library's BRISK_S_MAX, nw or
// W outside [1, 6]).
extern "C" int brisk_expand_span(const void* bucket, const void* meta,
                                 const void* nucs, void* out, int R, int k,
                                 int m, int b, int s_max, int nw, int W,
                                 int layout, void* stream) {
  if (R <= 0) return 0;
  if (s_max != kSMax || nw < 1 || nw > 6 || W < 1 || W > 6 || layout < 0 ||
      layout > 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.R = R; p.k = k; p.m = m; p.b = b; p.nw = nw; p.W = W;
  p.cs = (uint32_t)(k - b);
  p.suffix_reduc = (uint32_t)((m - b + 1) / 2);
  const uint32_t bpos = 8u + 2u * (uint32_t)k;
  p.qc = bpos >> 5;
  p.rc = bpos & 31u;
  for (int i = 0; i < 6; ++i) {  // bits [8, 8 + 2k) of word i
    uint64_t lo = 32ull * i, hi = lo + 32ull;
    uint64_t a = lo > 8ull ? lo : 8ull, e = hi < bpos ? hi : bpos;
    uint32_t mk = 0u;
    if (a < e) {
      uint32_t width = (uint32_t)(e - a), shift = (uint32_t)(a - lo);
      mk = (width >= 32u ? 0xFFFFFFFFu : ((1u << width) - 1u)) << shift;
    }
    p.mask[i] = mk;
  }
  const uintptr_t align = (uintptr_t)bucket | (uintptr_t)meta |
                          (uintptr_t)nucs | (uintptr_t)out;
  p.vec = (R % kRows == 0) && (align % 16u == 0);
  const int groups = (R + kRows - 1) / kRows;
  const dim3 grid((groups + kThreads - 1) / kThreads);
  const cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* bb = (const uint32_t*)bucket;
  const uint32_t* mm = (const uint32_t*)meta;
  const uint32_t* nn = (const uint32_t*)nucs;
  uint32_t* oo = (uint32_t*)out;
  if (layout == 0)
    expand_span_kernel<0, kSMax><<<grid, kThreads, 0, st>>>(bb, mm, nn, oo, p);
  else
    expand_span_kernel<1, kSMax><<<grid, kThreads, 0, st>>>(bb, mm, nn, oo, p);
  return (int)cudaGetLastError();
}
