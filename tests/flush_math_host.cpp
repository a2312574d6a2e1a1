// Host build of brisk_tpu_torch/csrc/flush_math.cuh, the arithmetic of the
// flush's CUDA kernels (positions.cu, emit.cu, skl_rows.cu), for
// tests/test_torch_flush_math.py: a shim gives the CUDA qualifiers that
// the headers use plain C++ meanings, and C entry points run the kernels'
// per-position and per-lane loops sequentially with the header's
// functions, on host memory laid out as the kernels' C entries take it.
//
//   g++ -O2 -std=c++17 -shared -fPIC -I brisk_tpu_torch/csrc \
//       tests/flush_math_host.cpp -o libflush_math_host.so

#include <cstdint>
#include <utility>
#include <vector>

#define __host__
#define __device__
#define __forceinline__ inline

#include "flush_math.cuh"

namespace {

// positions.cu's threads: the windows of position p from the row's codes
// (as the bytes a block stages), the candidate from the windows.
template <int M>
void position_rows(const int64_t* codes, int64_t* out64, bool* out8,
                   const double* coef, int R, int L, int64_t row_stride,
                   int k) {
  const int64_t n = (int64_t)R * L;
  std::vector<uint8_t> row(L);
  for (int64_t r = 0; r < R; ++r) {
    for (int p = 0; p < L; ++p) row[p] = (uint8_t)codes[r * row_stride + p];
    for (int p = 0; p < L; ++p) {
      const int64_t idx = r * L + p;
      const brisk::Windows w = brisk::windows(row.data() + p, p, k, M);
      const brisk::Candidate c =
          brisk::position_candidate<M>(w.fwd_m, w.rc_m, coef);
      int64_t* o = out64 + idx;
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
      out8[idx] = c.is_rc;
      out8[n + idx] = c.scan_rev;
    }
  }
}

using PosRows = void (*)(const int64_t*, int64_t*, bool*, const double*, int,
                         int, int64_t, int);

template <int... Ms>
PosRows pick_positions(int m, std::integer_sequence<int, Ms...>) {
  constexpr PosRows table[] = {&position_rows<Ms + 1>...};
  return table[m - 1];
}

// skl_rows.cu's lane, sequentially: the running values forward, the row
// lasts and the segmented suffix sum backward, then each position's slot.
template <int NW>
void lane_rows(const void* const* in, int64_t* out, bool* overflow, int B,
               int L, int row_cap, int out_w, int k, int m, int b, int s_max,
               bool split) {
  const int64_t* key[4];
  for (int i = 0; i < 4; ++i) key[i] = (const int64_t*)in[i];
  const int64_t* bucket = (const int64_t*)in[4];
  const int64_t* mini = (const int64_t*)in[5];
  const bool* use_rc = (const bool*)in[6];
  const bool* valid = (const bool*)in[7];
  const bool* first_valid = (const bool*)in[8];
  const bool* boundary = (const bool*)in[9];
  const int64_t plane = (int64_t)B * out_w;
  std::vector<char> start(L + 1), last_flag(L);
  std::vector<int64_t> first_pos(L), rank(L), last(L + 1);
  std::vector<int64_t> agg((int64_t)(L + 1) * NW);
  for (int64_t lane = 0; lane < B; ++lane) {
    const int64_t base = lane * L;
    int64_t first0 = 0, fp = 0, n_start = 0;
    for (int p = 0; p < L; ++p) {
      const bool v = valid[base + p];
      const bool s0 = brisk::natural_start(v, boundary[base + p],
                                           first_valid[base + p]);
      if (s0) first0 = p;
      start[p] = brisk::row_start(s0, v, p, first0, split, s_max);
      if (start[p]) fp = p;
      first_pos[p] = fp;
      rank[p] = n_start;
      n_start += start[p];
    }
    start[L] = 0;
    for (int p = 0; p < L; ++p)
      last_flag[p] = valid[base + p] &&
                     (p + 1 == L || !valid[base + p + 1] || start[p + 1]);
    last[L] = 0x7FFFFFFF;
    for (int p = L - 1; p >= 0; --p)
      last[p] = last_flag[p] ? p : last[p + 1];
    const bool ovf = n_start > row_cap;
    overflow[lane] = ovf;
    for (int i = 0; i < NW; ++i) agg[(int64_t)L * NW + i] = 0;
    for (int p = L - 1; p >= 0; --p) {
      const int64_t q = base + p;
      const bool v = valid[q];
      const int64_t d = v ? last[p] - p : 0;
      const int64_t j = v ? p - first_pos[p] : 0;
      uint32_t c[NW];
      brisk::row_contrib<NW>(
          brisk::from_limbs(key[0][q], key[1][q], key[2][q], key[3][q]),
          mini[q], use_rc[q], v, d, j, k, m, b, c);
      for (int i = 0; i < NW; ++i)
        agg[(int64_t)p * NW + i] =
            c[i] + (last_flag[p] ? 0 : agg[(int64_t)(p + 1) * NW + i]);
      const int64_t slot = brisk::row_slot(start[p], ovf, rank[p], n_start,
                                           p);
      if (slot < out_w) {
        int64_t* o = out + lane * out_w + slot;
        o[0] = start[p] && !ovf ? bucket[q] : brisk::kInvalid;
        o[plane] = brisk::row_meta(start[p], mini[q], use_rc[q], d, m, b);
        for (int i = 0; i < NW; ++i)
          o[(2 + i) * plane] = agg[(int64_t)p * NW + i];
      }
    }
  }
}

using LaneRows = void (*)(const void* const*, int64_t*, bool*, int, int, int,
                          int, int, int, int, int, bool);

template <int... Ns>
LaneRows pick_rows(int nw, std::integer_sequence<int, Ns...>) {
  constexpr LaneRows table[] = {&lane_rows<Ns + 1>...};
  return table[nw - 1];
}

}  // namespace

extern "C" {

// positions.cu's brisk_positions on host pointers (coef on the host)
int host_positions(const int64_t* codes, int64_t* out64, bool* out8,
                   const double* coef, int R, int L, long long row_stride,
                   int k, int m) {
  if (m < 1 || m > brisk::kMaxM || k < 1 || k > 63 || L < 1 ||
      row_stride < L)
    return 1;
  pick_positions(m, std::make_integer_sequence<int, brisk::kMaxM>{})(
      codes, out64, out8, coef, R, L, row_stride, k);
  return 0;
}

// emit.cu's brisk_emit on host pointers
int host_emit(const void* const* in, int64_t* out, int B, int L_out,
              int L_buf, int km, int m, int b) {
  if (L_out < 1 || L_out > L_buf) return 1;
  const int64_t n = (int64_t)B * L_out;
  auto i64 = [&](int j) { return (const int64_t*)in[j]; };
  for (int64_t idx = 0; idx < n; ++idx) {
    const int64_t lane = idx / L_out;
    const int64_t q = lane * L_buf + (L_buf - L_out) + idx % L_out;
    const brisk::Emitted e = brisk::emit_position(
        ((const bool*)in[0])[idx], i64(1)[idx], i64(2)[idx], i64(3)[idx],
        brisk::from_limbs(i64(4)[q], i64(5)[q], i64(6)[q], i64(7)[q]),
        brisk::from_limbs(i64(8)[q], i64(9)[q], i64(10)[q], i64(11)[q]), km,
        m, b);
    int64_t* o = out + idx;
    o[0] = e.mini_idx;
    o[n] = e.mini_lo;
    o[2 * n] = e.mini_hi;
    o[3 * n] = e.hash_hi;
    o[4 * n] = e.hash_lo;
    for (int i = 0; i < 4; ++i) {
      o[(5 + i) * n] = brisk::limb(e.kmer, i);
      o[(9 + i) * n] = brisk::limb(e.key, i);
    }
    o[13 * n] = e.bucket;
  }
  return 0;
}

// skl_rows.cu's brisk_skl_rows on host pointers (no scratch)
int host_skl_rows(const void* const* in, int64_t* out, bool* overflow, int B,
                  int L, int row_cap, int out_w, int k, int m, int b,
                  int s_max, int split, int nw) {
  if (nw < 1 || nw > brisk::kMaxNW || L < 1 || out_w > L ||
      out_w > row_cap)
    return 1;
  pick_rows(nw, std::make_integer_sequence<int, brisk::kMaxNW>{})(
      in, out, overflow, B, L, row_cap, out_w, k, m, b, s_max, split != 0);
  return 0;
}

}  // extern "C"
