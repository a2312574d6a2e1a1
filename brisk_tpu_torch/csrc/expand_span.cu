// Span expansion kernel for Hopper (sm_90a): compacted super-k-mer rows
// -> per-slot packed k-mer keys, J-major.
//
// Replaces the TPU kernel brisk_tpu/index/sklstore.py
// _expand_span_jmajor_pallas (pl.pallas_call body _expand_j_words +
// store.make_key_words). Plain PyTorch version beside it:
// brisk_tpu_torch.index.sklstore._expand_span_jmajor_torch.
//
// For span row r and slot j < s_max: take 2(k-b) bits of the row's
// nucleotides at offset 2(size-1-j), re-insert the 2b bucket bits at hole
// h = mini - (size-1-j), and pack bucket | kmer | (h - suffix_reduc) into
// W big-endian u32 words, written at out[w][j*R + r]. A dead row (bucket
// 0xFFFFFFFF) or a slot j >= size gives all words 0xFFFFFFFF.
//
// What bounds it on this card: memory. Per row it reads 4*(2 + nw) bytes
// and writes 4*W*s_max (k=31: 16 B read, 96 B written), about 0.9 GB at
// R = 2^23 rows, so ~0.3 ms at 3.35 TB/s. The arithmetic (a few dozen
// 64-bit shifts per slot) is far below the card's integer rate. Design:
// one thread per row, a loop over j; for each (w, j) plane neighbouring
// threads write neighbouring addresses, so every store is coalesced. The
// 128- and 192-bit values stay in registers as uint64_t words.
//
// Shifts reproduce brisk_tpu.ops.u128.shl_var/shr_var exactly: a shift by
// the full width or more gives 0, and no C++ shift is ever by 0 across a
// word boundary or by 64 or more (undefined behaviour). All u32 offset
// arithmetic wraps like the reference's uint32 math.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kInvalid = 0xFFFFFFFFu;

struct U128 {
  uint64_t lo, hi;
};

struct U192 {
  uint64_t w0, w1, w2;  // little-endian 64-bit words
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

// low 128 bits of (x >> s) for a 192-bit x (nucleotide words, nw <= 5)
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

__device__ __forceinline__ uint32_t word32(const U192& x, int i) {
  uint64_t w = (i < 2) ? x.w0 : ((i < 4) ? x.w1 : x.w2);
  return (uint32_t)(w >> ((i & 1) * 32));
}

__global__ void expand_span_jmajor_kernel(
    const uint32_t* __restrict__ bucket, const uint32_t* __restrict__ meta,
    const uint32_t* __restrict__ nucs, uint32_t* __restrict__ out, int R,
    int k, int m, int b, int s_max, int nw, int W) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;  // ragged last block
  const uint32_t bk = bucket[r];
  const uint32_t mt = meta[r];
  uint32_t nu[6] = {0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 6; ++i)
    if (i < nw) nu[i] = nucs[(size_t)i * R + r];
  const U192 n192 = {(uint64_t)nu[0] | ((uint64_t)nu[1] << 32),
                     (uint64_t)nu[2] | ((uint64_t)nu[3] << 32),
                     (uint64_t)nu[4] | ((uint64_t)nu[5] << 32)};
  const uint32_t size = mt & 0xFFu;
  const uint32_t mini = (mt >> 8) & 0xFFu;
  const bool live = bk != kInvalid;
  const uint32_t cs2 = 2u * (uint32_t)(k - b);
  const uint32_t suffix_reduc = (uint32_t)((m - b + 1) / 2);
  const U128 ones = {~0ull, ~0ull};
  const size_t plane = (size_t)s_max * R;

  for (int j = 0; j < s_max; ++j) {
    const uint32_t J = (uint32_t)j;
    const bool ok = live && (J < size);
    const uint32_t d = ok ? (size - 1u - J) : 0u;
    const U128 win = mask128(shr192_lo(n192, 2u * d), cs2);
    const uint32_t h = ok ? (mini - d) : 0u;  // u32 wraparound
    const uint32_t sh_h = 2u * h;
    const U128 mask = shl128(ones, sh_h);
    const U128 low = {win.lo & ~mask.lo, win.hi & ~mask.hi};
    const U128 high = shl128(shr128(win, sh_h), sh_h + 2u * (uint32_t)b);
    const U128 mid = shl128(U128{(uint64_t)bk, 0ull}, sh_h);
    const U128 kmer = mask128(
        U128{low.lo | high.lo | mid.lo, low.hi | high.hi | mid.hi},
        2u * (uint32_t)k);
    const uint32_t full_mini = ok ? (h - suffix_reduc) : 0u;
    // bucket | kmer | mini_idx, little-endian over 192 bits
    U192 key = {(uint64_t)full_mini, 0ull, 0ull};
    or_shl192(key, kmer, 8u);
    or_shl192(key, U128{(uint64_t)(ok ? bk : kInvalid), 0ull},
              8u + 2u * (uint32_t)k);
    uint32_t* dst = out + (size_t)j * R + r;
#pragma unroll
    for (int w = 0; w < 6; ++w)
      if (w < W)
        dst[(size_t)w * plane] = ok ? word32(key, W - 1 - w) : kInvalid;
  }
}

}  // namespace

extern "C" int brisk_expand_span_jmajor(const void* bucket, const void* meta,
                                        const void* nucs, void* out, int R,
                                        int k, int m, int b, int s_max,
                                        int nw, int W, void* stream) {
  if (R <= 0) return 0;
  const int threads = 256;
  const int blocks = (R + threads - 1) / threads;
  expand_span_jmajor_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bucket, (const uint32_t*)meta,
      (const uint32_t*)nucs, (uint32_t*)out, R, k, m, b, s_max, nw, W);
  return (int)cudaGetLastError();
}
