// The enumerator's position pipeline for Hopper (sm_90a): at every
// position of every row, the k- and m-base windows that end there and
// the m-mer candidate; each thread rolls the windows over a run of
// consecutive positions.
//
// Replaces the XLA fusion brisk_tpu/ops/minimizer.py position_pipeline
// (lines 54-64) over codec.kmer_windows (codec.py:103), hashing.bfc_hash
// (hashing.py:79) and decycling.mem_double (decycling.py:84), one fused
// elementwise pass in the reference. Plain PyTorch version beside it:
// brisk_tpu_torch.ops.minimizer.position_pipeline_torch, whose contract
// this kernel keeps bit for bit on 2-bit codes (values 0-3): the
// arithmetic is flush_math.cuh's (brisk::roll_run, rolled_windows,
// position_candidate) over enum_math.cuh's mixer and decycling sums.
//
// Rows: n = R * L positions, row r's codes at codes + r * row_stride (the
// fresh-lane init reads the strided slice codes[:, :k-1] in place).
// Position p of a row reads the codes at p - u for u < max(k, m), none
// before the row's start (the plain version zero-fills there). Outputs:
// 17 int64 planes of n values (fwd_k 4 limbs, rc_k 4, fwd_m 2, rc_m 2,
// canon_m 2, the hash triple heavy, hi, lo), then 2 bool planes
// (cand_is_rc, scan_rev).
//
// What bounds it on this card: the bytes, 146 a position (one int64 code
// in, 17 int64 and 2 bool out): 162 MB at the insert's batch (R 2048,
// L 542), 0.048 ms at 3.35 TB/s; 85.8 MB, 0.026 ms at the k=63 batch
// (R 1024, L 574). The previous design ran one thread per position and
// built both windows from scratch there: up to max(k, m) codes ORed in
// at variable 128-bit shifts, ~126 a position at k=63, so instructions
// bound it there (0.092 ms, 28% of its bound; 0.081 ms, 60%, at k=31).
//
// The design: a block of kPosThreads threads takes a tile of kPosThreads
// * kPosRun consecutive positions of the flat (row, position) order and
// stages their codes and the max(k, m) - 1 before the tile (the halo) in
// shared memory as bytes, once, coalesced. Phase 1: each thread rolls
// two 128-bit registers (brisk::Roll: the last 64 codes forward and
// complemented) over its run of kPosRun positions, one code a step with
// constant shifts, after rolling in the max(k, m) - 1 codes before the
// run (fewer at a row's start; from zero again where the run enters the
// next row), and parks the registers of each position in shared memory
// (8 u32 planes, one pad word per 32 slots so that the lanes, kPosRun
// slots apart, hit distinct banks). Phase 2: position s of the tile goes
// to thread s mod kPosThreads, which cuts both windows out of the
// registers (a mask and one shift each), computes the candidate (one
// decycling class: two sums of m - 1 float64 additions from the
// coefficient table in shared memory, the kernel instantiated per m as
// the rescan is) and writes the 19 outputs, neighbouring threads to
// neighbouring addresses. Per position the windows cost about
// (kPosRun + max(k, m) - 1) / kPosRun roll steps instead of max(k, m)
// variable shifts.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; bench_enumerate, device time):
// 0.059 ms at the insert's batch (82% of the bound), 0.033 ms at the
// k=63 batch (77%), 0.221 ms over reallocate's rekey rows (65536 x 63,
// m 23; 81% of 0.180 ms); the previous design took 0.080 / 0.091 /
// 0.566.
// A run of 4 positions, or blocks of 256, measured the same.

#include <array>
#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

#include "flush_math.cuh"

namespace {

constexpr int kThreads = brisk::kPosThreads;
constexpr int kRun = brisk::kPosRun;
constexpr int kTile = kThreads * kRun;
constexpr int kMaxHalo = 62;  // max(k, m) - 1 at k = 63
constexpr int kPlane = kTile + kTile / 32;  // a staging plane, padded

struct PosArgs {
  const int64_t* codes;
  int64_t* out64;  // 17 planes of n
  bool* out8;      // 2 planes of n
  const double* coef;
};

BRISK_HD int skew(int s) { return s + (s >> 5); }

// Parks a run's registers in the staging planes, at slot s0 + i.
struct Park {
  uint32_t (*planes)[kPlane];
  int s0;
  BRISK_HD void put(int i, const brisk::Roll& r) {
    const int j = skew(s0 + i);
    for (int w = 0; w < 4; ++w) {
      planes[w][j] = (uint32_t)(r.fwd >> (32 * w));
      planes[4 + w][j] = (uint32_t)(r.rc >> (32 * w));
    }
  }
};

template <int M>
__global__ void __launch_bounds__(kThreads)
positions_kernel(const __grid_constant__ PosArgs a, int64_t n, int L,
                 int64_t row_stride, int k) {
  __shared__ uint8_t s_codes[kMaxHalo + kTile];
  __shared__ double coef[4 * M];
  __shared__ uint32_t s_regs[8][kPlane];
  const int H = (k > M ? k : M) - 1;
  const int64_t q0 = (int64_t)blockIdx.x * kTile;
  // every code load issued before the first store (one round trip)
  constexpr int kLoads = (kMaxHalo + kTile + kThreads - 1) / kThreads;
  uint8_t code[kLoads];
#pragma unroll
  for (int r = 0; r < kLoads; ++r) {
    const int j = threadIdx.x + r * kThreads;
    const int64_t q = q0 - H + j;
    code[r] = 0;
    if (j < H + kTile && q >= 0 && q < n) {
      const int64_t off =
          row_stride == L ? q : (q / L) * row_stride + q % L;
      code[r] = (uint8_t)__ldg((const long long*)(a.codes + off));
    }
  }
#pragma unroll
  for (int r = 0; r < kLoads; ++r) {
    const int j = threadIdx.x + r * kThreads;
    if (j < H + kTile) s_codes[j] = code[r];
  }
  for (int j = threadIdx.x; j < 4 * M; j += kThreads) coef[j] = a.coef[j];
  __syncthreads();

  // phase 1: roll the run
  const int s0 = threadIdx.x * kRun;
  const int64_t q = q0 + s0;
  if (q < n) {
    const int p = (int)(q % L);
    const int64_t left = n - q;
    Park park{s_regs, s0};
    brisk::roll_run(s_codes + H + s0, p, p < H ? p : H,
                    left < kRun ? (int)left : kRun, L, park);
  }
  __syncthreads();

  // phase 2: the candidate and the outputs, coalesced
  for (int s = threadIdx.x; s < kTile; s += kThreads) {
    const int64_t idx = q0 + s;
    if (idx >= n) break;
    const int j = skew(s);
    brisk::Roll r;
    r.fwd = (brisk::u128)s_regs[0][j] | ((brisk::u128)s_regs[1][j] << 32) |
            ((brisk::u128)s_regs[2][j] << 64) |
            ((brisk::u128)s_regs[3][j] << 96);
    r.rc = (brisk::u128)s_regs[4][j] | ((brisk::u128)s_regs[5][j] << 32) |
           ((brisk::u128)s_regs[6][j] << 64) |
           ((brisk::u128)s_regs[7][j] << 96);
    const brisk::Windows w = brisk::rolled_windows(r, k, M);
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
}

using Launch = void (*)(const PosArgs&, int64_t, int, int64_t, int,
                        cudaStream_t);

template <int M>
void launch(const PosArgs& a, int64_t n, int L, int64_t row_stride, int k,
            cudaStream_t stream) {
  const dim3 grid((unsigned)((n + kTile - 1) / kTile));
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
