// Host build of brisk_tpu_torch/csrc/enum_math.cuh, the arithmetic of the
// enumerator's CUDA kernels, for tests/test_torch_enum_math.py: a shim
// gives the CUDA qualifiers that the header uses plain C++ meanings, and
// C entry points run the kernels' per-lane and per-position loops
// sequentially with the header's functions, on host memory laid out as
// the kernels' C entries take it.
//
//   g++ -O2 -std=c++17 -shared -fPIC -I brisk_tpu_torch/csrc \
//       tests/enum_math_host.cpp -o libenum_math_host.so

#include <cstdint>
#include <utility>

#define __host__
#define __device__
#define __forceinline__ inline

#include "enum_math.cuh"

namespace {

// get_minimizer at every position of (R, L) rows, as rescan.cu's threads
// compute it: M = 0 for k_arg <= 32, else M = m.
template <int M>
void rescan_rows(const void* const* in, void* const* out, const double* coef,
                 int R, int L, int k_arg, int m) {
  const int64_t* c_lo = (const int64_t*)in[0];
  const int64_t* c_hi = (const int64_t*)in[1];
  const int64_t* heavy = (const int64_t*)in[2];
  const int64_t* hhi = (const int64_t*)in[3];
  const int64_t* hlo = (const int64_t*)in[4];
  const bool* scan_rev = (const bool*)in[5];
  const int W = k_arg - m + 1;
  const int clean_max = 32 - m;
  const int H = W - 1 < clean_max ? W - 1 : clean_max;
  int64_t const_h = 0, const_w = 0;
  if (M > 0) brisk::constant_candidate<M>(coef, const_h, const_w);
  const int64_t n = (int64_t)R * L;
  for (int64_t idx = 0; idx < n; ++idx) {
    auto h_at = [&](int64_t q) {
      return brisk::pack_hash(heavy[q], hhi[q], hlo[q]);
    };
    auto w_at = [&](int64_t q) {
      return brisk::pack_word(c_lo[q], c_hi[q], scan_rev[q]);
    };
    const int p = (int)(idx % L);
    uint32_t x[4];
    for (int j = 0; j < 4; ++j)
      x[j] = (uint32_t)((const int64_t*)in[6 + j])[idx];
    const bool canon = brisk::canonized(x, k_arg);
    brisk::FoldState s = brisk::fold_start(h_at(idx), w_at(idx));
    for (int i = 1; i <= H; ++i) {
      const bool in_row = p >= i;
      brisk::fold_offset(s, in_row ? h_at(idx - i) : brisk::kZeroHash,
                         in_row ? w_at(idx - i) : 0, i, W - 1 - i, canon);
    }
    if (M > 0) {
      const uint64_t trunc = (uint64_t)x[0] | ((uint64_t)x[1] << 32);
      const uint64_t rc_trunc = brisk::rc32(trunc);
      for (int i = clean_max + 1; i <= W - 1 && i < 32; ++i) {
        int64_t h, w;
        brisk::truncated_candidate<M>(trunc, rc_trunc, i, coef, h, w);
        brisk::fold_offset(s, h, w, i, W - 1 - i, canon);
      }
      for (int i = 32; i < W; ++i)
        brisk::fold_offset(s, const_h, const_w, i, W - 1 - i, canon);
    }
    int64_t hv, hh, hl;
    brisk::unpack_hash(s.h, hv, hh, hl);
    ((int64_t*)out[0])[idx] = s.mini & brisk::kM32;
    ((int64_t*)out[1])[idx] = s.mini >> 32;
    ((int64_t*)out[2])[idx] = s.pos;
    ((bool*)out[3])[idx] = s.rev;
    ((int64_t*)out[4])[idx] = hv;
    ((int64_t*)out[5])[idx] = hh;
    ((int64_t*)out[6])[idx] = hl;
    if (out[7]) ((bool*)out[7])[idx] = s.cnt == 1;
  }
}

using Rows = void (*)(const void* const*, void* const*, const double*, int,
                      int, int, int);

template <int... Ms>
constexpr Rows pick(int M, std::integer_sequence<int, Ms...>) {
  constexpr Rows table[] = {&rescan_rows<Ms>...};
  return table[M];
}

}  // namespace

extern "C" {

// rescan.cu's brisk_rescan on host pointers (coef on the host)
int host_rescan(const void* const* in, void* const* out, const double* coef,
                int R, int L, int k_arg, int m) {
  if (m < 1 || m > brisk::kMaxM || k_arg < m || k_arg > 63 || L < 1)
    return 1;
  const int M = k_arg > 32 ? m : 0;
  pick(M, std::make_integer_sequence<int, brisk::kMaxM + 1>{})(
      in, out, coef, R, L, k_arg, m);
  return 0;
}

// state_scan.cu's brisk_state_scan on host pointers: per lane, the step
// over its positions, the fresh-lane suppression, the final state
int host_state_scan(const void* const* in, void* const* out, int B,
                    int L_buf, int margin, int km) {
  if (margin < 0 || margin > L_buf) return 1;
  auto i64 = [&](int j) { return (const int64_t*)in[j]; };
  auto o64 = [&](int j) { return (int64_t*)out[j]; };
  const bool* c_rc = (const bool*)in[5];
  const bool* r_rev = (const bool*)in[9];
  const int L_out = L_buf - margin;
  for (int64_t b = 0; b < B; ++b) {
    brisk::ScanState s{
        brisk::pack_hash(i64(17)[b], i64(18)[b], i64(19)[b]),
        brisk::pack_mini(i64(13)[b], i64(14)[b]), i64(15)[b],
        ((const bool*)in[16])[b]};
    const bool fresh = ((const bool*)in[20])[b];
    for (int t = 0; t < L_out; ++t) {
      const int64_t q = b * L_buf + margin + t;
      const bool bd =
          brisk::scan_step(
              s, brisk::pack_hash(i64(0)[q], i64(1)[q], i64(2)[q]),
              brisk::pack_mini(i64(3)[q], i64(4)[q]), c_rc[q],
              brisk::pack_hash(i64(10)[q], i64(11)[q], i64(12)[q]),
              brisk::pack_mini(i64(6)[q], i64(7)[q]), i64(8)[q], r_rev[q],
              km) &&
          !(t == 0 && fresh);
      const int64_t o = b * L_out + t;
      ((bool*)out[0])[o] = bd;
      ((bool*)out[1])[o] = s.rev;
      o64(2)[o] = s.pos;
      o64(3)[o] = s.mini;
      o64(4)[o] = s.h;
    }
    int64_t hv, hh, hl;
    brisk::unpack_hash(s.h, hv, hh, hl);
    o64(5)[b] = s.mini & brisk::kM32;
    o64(6)[b] = s.mini >> 32;
    o64(7)[b] = s.pos;
    ((bool*)out[8])[b] = s.rev;
    o64(9)[b] = hv;
    o64(10)[b] = hh;
    o64(11)[b] = hl;
  }
  return 0;
}

// brisk::pack_hash of n triples
void host_pack_hash(int64_t n, const int64_t* heavy, const int64_t* hi,
                    const int64_t* lo, int64_t* out) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = brisk::pack_hash(heavy[i], hi[i], lo[i]);
}

}  // extern "C"
