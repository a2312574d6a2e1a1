// The enumerator's position pipeline for Hopper (sm_90a): at every
// position of every row, the k- and m-base windows that end there and
// the m-mer candidate, one thread per (row, position).
//
// Replaces the XLA fusion brisk_tpu/ops/minimizer.py position_pipeline
// (lines 54-64) over codec.kmer_windows (codec.py:103), hashing.bfc_hash
// (hashing.py:79) and decycling.mem_double (decycling.py:84), one fused
// elementwise pass in the reference. Plain PyTorch version beside it:
// brisk_tpu_torch.ops.minimizer.position_pipeline_torch, whose contract
// this kernel keeps bit for bit on 2-bit codes (values 0-3): the
// arithmetic is flush_math.cuh's (brisk::windows,
// brisk::position_candidate) over enum_math.cuh's mixer and decycling
// sums.
//
// Rows: n = R * L positions, row r's codes at codes + r * row_stride (the
// fresh-lane init reads the strided slice codes[:, :k-1] in place).
// Position p of a row reads the codes at p - u for u < max(k, m), none
// before the row's start (the plain version zero-fills there). Outputs:
// 17 int64 planes of n values (fwd_k 4 limbs, rc_k 4, fwd_m 2, rc_m 2,
// canon_m 2, the hash triple heavy, hi, lo), then 2 bool planes
// (cand_is_rc, scan_rev).
//
// What bounds it on this card: bytes. Per position it reads one int64
// code (its window's others come from shared memory) and writes 17 int64
// and 2 bool (8 + 138 = 146 B): 162 MB at the insert's batch (R 2048,
// L 542), 0.048 ms at 3.35 TB/s. The design: a block stages its 256
// positions' codes and the max(k, m) - 1 before them (the halo) in shared
// memory as bytes, once, coalesced; each thread then builds its windows from
// shared memory (at most 63 loads), its candidate with one decycling
// class (two sums of m - 1 float64 additions from the coefficient table
// in shared memory, the kernel instantiated per m as the rescan is), and
// writes its 19 outputs, neighbouring threads to neighbouring addresses.

#include <array>
#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

#include "flush_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHalo = 62;  // max(k, m) - 1 at k = 63

struct PosArgs {
  const int64_t* codes;
  int64_t* out64;  // 17 planes of n
  bool* out8;      // 2 planes of n
  const double* coef;
};

template <int M>
__global__ void __launch_bounds__(kThreads)
positions_kernel(const __grid_constant__ PosArgs a, int64_t n, int L,
                 int64_t row_stride, int k) {
  __shared__ uint8_t s_codes[kMaxHalo + kThreads];
  __shared__ double coef[4 * M];
  const int H = (k > M ? k : M) - 1;
  const int64_t q0 = (int64_t)blockIdx.x * kThreads;
  for (int j = threadIdx.x; j < H + kThreads; j += kThreads) {
    const int64_t q = q0 - H + j;
    if (q >= 0 && q < n) {
      const int64_t r = q / L;
      s_codes[j] = (uint8_t)__ldg(
          (const long long*)(a.codes + r * row_stride + (q - r * L)));
    }
  }
  for (int j = threadIdx.x; j < 4 * M; j += kThreads) coef[j] = a.coef[j];
  __syncthreads();
  const int64_t idx = q0 + threadIdx.x;
  if (idx >= n) return;
  const int p = (int)(idx % L);
  const brisk::Windows w =
      brisk::windows(s_codes + H + threadIdx.x, p, k, M);
  const brisk::Candidate c =
      brisk::position_candidate<M>(w.fwd_m, w.rc_m, coef);
  int64_t* o = a.out64 + idx;
  for (int i = 0; i < 4; ++i) {
    o[i * n] = brisk::limb(w.fwd_k, i);
    o[(4 + i) * n] = brisk::limb(w.rc_k, i);
  }
  o[8 * n] = (int64_t)(w.fwd_m & brisk::kM32);
  o[9 * n] = (int64_t)(w.fwd_m >> 32);
  o[10 * n] = (int64_t)(w.rc_m & brisk::kM32);
  o[11 * n] = (int64_t)(w.rc_m >> 32);
  o[12 * n] = (int64_t)(c.canon & brisk::kM32);
  o[13 * n] = (int64_t)(c.canon >> 32);
  o[14 * n] = c.heavy;
  o[15 * n] = c.hhi;
  o[16 * n] = c.hlo;
  a.out8[idx] = c.is_rc;
  a.out8[n + idx] = c.scan_rev;
}

using Launch = void (*)(const PosArgs&, int64_t, int, int64_t, int,
                        cudaStream_t);

template <int M>
void launch(const PosArgs& a, int64_t n, int L, int64_t row_stride, int k,
            cudaStream_t stream) {
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  positions_kernel<M><<<grid, kThreads, 0, stream>>>(a, n, L, row_stride,
                                                      k);
}

template <int... Ms>
constexpr std::array<Launch, sizeof...(Ms)> launches(
    std::integer_sequence<int, Ms...>) {
  return {&launch<Ms + 1>...};
}

// kLaunch[m - 1] for m in [1, 31]
constexpr auto kLaunch =
    launches(std::make_integer_sequence<int, brisk::kMaxM>{});

}  // namespace

// codes: (R, L) int64 rows, row r at codes + r * row_stride; out64: 17
// planes of R * L int64; out8: 2 planes of R * L bool; coef: the (4m,)
// float64 decycling table on the device. Returns a cudaError_t: the
// launch's, or cudaErrorInvalidValue for m outside [1, 31], k outside
// [1, 63], L < 1 or row_stride < L.
extern "C" int brisk_positions(const void* codes, void* out64, void* out8,
                               const void* coef, int R, int L,
                               long long row_stride, int k, int m,
                               void* stream) {
  if (m < 1 || m > brisk::kMaxM || k < 1 || k > 63 || L < 1 || R < 0 ||
      row_stride < L)
    return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)R * L;
  if (n == 0) return 0;
  PosArgs a;
  a.codes = (const int64_t*)codes;
  a.out64 = (int64_t*)out64;
  a.out8 = (bool*)out8;
  a.coef = (const double*)coef;
  kLaunch[m - 1](a, n, L, (int64_t)row_stride, k, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
