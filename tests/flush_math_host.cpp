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

// positions.cu's blocks in order: the tile's codes (and the halo before
// it) as the bytes a block stages, phase 1 (each thread's run through
// brisk::roll_run, the registers parked per position), then phase 2 (the
// windows and the candidate of each position from its registers).
struct HostPark {
  brisk::Roll* regs;
  void put(int i, const brisk::Roll& r) { regs[i] = r; }
};

template <int M>
void position_rows(const int64_t* codes, int64_t* out64, bool* out8,
                   const double* coef, int R, int L, int64_t row_stride,
                   int k) {
  constexpr int kTile = brisk::kPosThreads * brisk::kPosRun;
  const int64_t n = (int64_t)R * L;
  const int H = (k > M ? k : M) - 1;
  std::vector<uint8_t> tile(H + kTile);
  std::vector<brisk::Roll> regs(kTile);
  for (int64_t q0 = 0; q0 < n; q0 += kTile) {
    for (int j = 0; j < H + kTile; ++j) {
      const int64_t q = q0 - H + j;
      tile[j] = q >= 0 && q < n
                    ? (uint8_t)codes[(q / L) * row_stride + q % L]
                    : 0xFF;  // never read
    }
    for (int t = 0; t < brisk::kPosThreads; ++t) {
      const int s0 = t * brisk::kPosRun;
      const int64_t q = q0 + s0;
      if (q >= n) continue;
      const int p = (int)(q % L);
      const int64_t left = n - q;
      HostPark park{regs.data() + s0};
      brisk::roll_run(tile.data() + H + s0, p, p < H ? p : H,
                      left < brisk::kPosRun ? (int)left : brisk::kPosRun,
                      L, park);
    }
    for (int s = 0; s < kTile && q0 + s < n; ++s) {
      const int64_t idx = q0 + s;
      const brisk::Windows w = brisk::rolled_windows(regs[s], k, M);
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

// The windows of a row rolled from position `start` to the row's end in
// one run (brisk::roll_run); 12 planes of R * L: fwd_k 4 limbs, rc_k 4,
// fwd_m 2, rc_m 2; positions before `start` untouched.
struct WindowSink {
  int k, m;
  int64_t* o;  // the run's first position in plane 0
  int64_t n;
  void put(int i, const brisk::Roll& r) {
    const brisk::Windows w = brisk::rolled_windows(r, k, m);
    for (int l = 0; l < 4; ++l) {
      o[l * n + i] = brisk::limb(w.fwd_k, l);
      o[(4 + l) * n + i] = brisk::limb(w.rc_k, l);
    }
    o[8 * n + i] = (int64_t)(w.fwd_m & brisk::kM32);
    o[9 * n + i] = (int64_t)(w.fwd_m >> 32);
    o[10 * n + i] = (int64_t)(w.rc_m & brisk::kM32);
    o[11 * n + i] = (int64_t)(w.rc_m >> 32);
  }
};

using PosRows = void (*)(const int64_t*, int64_t*, bool*, const double*, int,
                         int, int64_t, int);

template <int... Ms>
PosRows pick_positions(int m, std::integer_sequence<int, Ms...>) {
  constexpr PosRows table[] = {&position_rows<Ms + 1>...};
  return table[m - 1];
}

// skl_rows.cu's block in the kernel's order: tiles of kRowTile positions,
// runs of kRowRun per thread through the header's run steps, and every
// warp scan as the shuffles take it (Kogge-Stone: at offset o, lane l
// combines its value with lane l - o's, or l + o's from the right, both of
// the step before; the lanes past the warp keep theirs), the exclusive
// value from the neighbouring lane, and the warps' totals combined in
// warp order.
constexpr int kT = brisk::kRowThreads, kP = brisk::kRowRun;
constexpr int kTileN = brisk::kRowTile, kW = kT / 32;

template <class T, class Op>
void warp_up(T* x, Op op) {
  for (int off = 1; off < 32; off <<= 1) {
    T prev[32];
    for (int l = 0; l < 32; ++l) prev[l] = x[l];
    for (int l = off; l < 32; ++l) x[l] = op(prev[l - off], prev[l]);
  }
}

template <class T, class Op>
void warp_down(T* x, Op op) {
  for (int off = 1; off < 32; off <<= 1) {
    T prev[32];
    for (int l = 0; l < 32; ++l) prev[l] = x[l];
    for (int l = 0; l + off < 32; ++l) x[l] = op(prev[l], prev[l + off]);
  }
}

struct Carry {
  int first0, first_pos, rank;
};

struct Run {
  uint32_t valid, starts, lasts;
  int fp[kP], rk[kP];
  int after;
};

struct Pair {
  int fp, rk;
};

struct Inputs {
  const int64_t* key[4];
  const int64_t* bucket;
  const int64_t* mini;
  const bool* use_rc;
  const bool* valid;
  const bool* first_valid;
  const bool* boundary;
};

// forward_tile for the block's kT threads; returns the tile's first last
int forward_tile(const Inputs& in, int64_t base, int c0, int L, bool split,
                 int s_max, Carry& carry, Run* run) {
  uint8_t flags[kTileN + 1];
  for (int j = 0; j <= kTileN; ++j) {
    const int p = c0 + j;
    uint8_t f = 0;
    if (p < L) {
      const int64_t q = base + p;
      const bool v = in.valid[q];
      f = (v ? brisk::kValid : 0) |
          (brisk::natural_start(v, in.boundary[q], in.first_valid[q])
               ? brisk::kStart0
               : 0);
    }
    flags[j] = f;
  }
  auto mx = [](int a, int b) { return a > b ? a : b; };
  auto mn = [](int a, int b) { return a < b ? a : b; };
  int f0[kT], f0_total[kW];
  for (int t = 0; t < kT; ++t)
    f0[t] = brisk::run_last_start0<kP>(flags + t * kP, c0 + t * kP);
  for (int w = 0; w < kW; ++w) {
    warp_up(f0 + 32 * w, mx);
    f0_total[w] = f0[32 * w + 31];
  }
  int tile_f0 = carry.first0;
  for (int w = 0; w < kW; ++w) tile_f0 = mx(tile_f0, f0_total[w]);
  Pair pr[kT];
  int lp[kT];
  for (int t = 0; t < kT; ++t) {
    const int lane = t & 31, warp = t >> 5, p0 = c0 + t * kP;
    int in_f0 = lane == 0 ? 0 : f0[t - 1];
    in_f0 = mx(in_f0, carry.first0);
    for (int w = 0; w < warp; ++w) in_f0 = mx(in_f0, f0_total[w]);
    const uint8_t* fl = flags + t * kP;
    Run& r = run[t];
    r.starts = brisk::run_starts<kP>(fl, p0, in_f0, split, s_max);
    r.lasts = brisk::run_lasts<kP>(fl, r.starts);
    r.valid = 0;
    for (int i = 0; i < kP; ++i)
      if (fl[i] & brisk::kValid) r.valid |= 1u << i;
    brisk::run_start_totals<kP>(r.starts, p0, pr[t].fp, pr[t].rk);
    lp[t] = brisk::run_first_last<kP>(r.lasts, p0);
  }
  Pair pr_total[kW];
  int lp_total[kW];
  for (int w = 0; w < kW; ++w) {
    warp_up(pr + 32 * w,
            [&](Pair a, Pair b) { return Pair{mx(a.fp, b.fp), a.rk + b.rk}; });
    warp_down(lp + 32 * w, mn);
    pr_total[w] = pr[32 * w + 31];
    lp_total[w] = lp[32 * w];
  }
  int tile_fp = carry.first_pos, tile_rk = 0, tile_lp = brisk::kBigPos;
  for (int w = 0; w < kW; ++w) {
    tile_fp = mx(tile_fp, pr_total[w].fp);
    tile_rk += pr_total[w].rk;
    tile_lp = mn(tile_lp, lp_total[w]);
  }
  for (int t = 0; t < kT; ++t) {
    const int lane = t & 31, warp = t >> 5;
    Pair in_pr = lane == 0 ? Pair{0, 0} : pr[t - 1];
    int in_lp = lane == 31 ? brisk::kBigPos : lp[t + 1];
    in_pr.fp = mx(in_pr.fp, carry.first_pos);
    in_pr.rk += carry.rank;
    for (int w = 0; w < kW; ++w) {
      if (w < warp) {
        in_pr.fp = mx(in_pr.fp, pr_total[w].fp);
        in_pr.rk += pr_total[w].rk;
      }
      if (w > warp) in_lp = mn(in_lp, lp_total[w]);
    }
    brisk::run_first_rank<kP>(run[t].starts, c0 + t * kP, in_pr.fp,
                              in_pr.rk, run[t].fp, run[t].rk);
    run[t].after = in_lp;
  }
  carry = Carry{tile_f0, tile_fp, carry.rank + tile_rk};
  return tile_lp;
}

template <int NW>
void rows_tile(const Inputs& in, int64_t* out, int64_t lane_id, int64_t base,
               int c0, int L, int out_w, int64_t plane, int k, int m, int b,
               const Run* run, int last_carry, int n_start, bool overflow,
               uint32_t* agg_next) {
  using Seg = brisk::Seg<NW>;
  static uint32_t words[kT][kP][NW];
  static int lp[kT][kP];
  uint32_t reach[kT];
  Seg seg[kT], excl[kT], total[kW];
  for (int t = 0; t < kT; ++t) {
    const int p0 = c0 + t * kP;
    const int after =
        run[t].after < last_carry ? run[t].after : last_carry;
    brisk::run_last_pos<kP>(run[t].lasts, p0, after, lp[t]);
    for (int i = 0; i < kP; ++i) {
      const int p = p0 + i;
      const bool v = run[t].valid >> i & 1u;
      const int64_t q = base + p;
      brisk::row_contrib<NW>(
          v ? brisk::from_limbs(in.key[0][q], in.key[1][q], in.key[2][q],
                                in.key[3][q])
            : (brisk::u128)0,
          v ? in.mini[q] : 0, v && in.use_rc[q], v, v ? lp[t][i] - p : 0,
          v ? p - run[t].fp[i] : 0, k, m, b, words[t][i]);
    }
    seg[t] = brisk::run_seg<kP, NW>(words[t], run[t].lasts, words[t],
                                    reach[t]);
  }
  for (int w = 0; w < kW; ++w) {
    warp_down(seg + 32 * w, [](const Seg& a, const Seg& b) {
      return brisk::seg_combine(a, b);
    });
    total[w] = seg[32 * w];
  }
  for (int t = 0; t < kT; ++t) {
    if ((t & 31) == 31) {
      excl[t].last = false;
      for (int w = 0; w < NW; ++w) excl[t].w[w] = 0;
    } else {
      excl[t] = seg[t + 1];
    }
  }
  Seg tile;
  tile.last = true;
  for (int w = 0; w < NW; ++w) tile.w[w] = agg_next[w];
  for (int w = kW - 1; w >= 0; --w) tile = brisk::seg_combine(total[w], tile);
  for (int t = 0; t < kT; ++t) {
    const int warp = t >> 5, p0 = c0 + t * kP;
    Seg acc;
    acc.last = true;
    for (int w = 0; w < NW; ++w) acc.w[w] = agg_next[w];
    for (int w = kW - 1; w > warp; --w) acc = brisk::seg_combine(total[w], acc);
    acc = brisk::seg_combine(excl[t], acc);
    for (int i = 0; i < kP; ++i) {
      const int p = p0 + i;
      if (p >= L) break;
      const bool start = run[t].starts >> i & 1u;
      const int64_t slot =
          brisk::row_slot(start, overflow, run[t].rk[i], n_start, p);
      if (slot >= out_w) continue;
      const bool v = run[t].valid >> i & 1u;
      const int64_t q = base + p;
      int64_t* o = out + lane_id * out_w + slot;
      o[0] = start && !overflow ? in.bucket[q] : brisk::kInvalid;
      o[plane] = brisk::row_meta(start, in.mini[q], in.use_rc[q],
                                 v ? lp[t][i] - p : 0, m, b);
      const bool on = reach[t] >> i & 1u;
      for (int w = 0; w < NW; ++w)
        o[(2 + w) * plane] = (int64_t)(words[t][i][w] + (on ? acc.w[w] : 0u));
    }
  }
  for (int w = 0; w < NW; ++w) agg_next[w] = tile.w[w];
}

template <int NW>
void lane_rows(const void* const* in_ptrs, int64_t* out, bool* overflow,
               int B, int L, int row_cap, int out_w, int k, int m, int b,
               int s_max, bool split) {
  Inputs in;
  for (int i = 0; i < 4; ++i) in.key[i] = (const int64_t*)in_ptrs[i];
  in.bucket = (const int64_t*)in_ptrs[4];
  in.mini = (const int64_t*)in_ptrs[5];
  in.use_rc = (const bool*)in_ptrs[6];
  in.valid = (const bool*)in_ptrs[7];
  in.first_valid = (const bool*)in_ptrs[8];
  in.boundary = (const bool*)in_ptrs[9];
  const int64_t plane = (int64_t)B * out_w;
  const int tiles = (L + kTileN - 1) / kTileN;
  std::vector<Carry> entry(tiles);
  static Run run[kT];
  for (int64_t lane = 0; lane < B; ++lane) {
    const int64_t base = lane * L;
    Carry c{0, 0, 0};
    int tile_last = brisk::kBigPos;
    for (int t = 0; t < tiles; ++t) {
      entry[t] = c;
      tile_last = forward_tile(in, base, t * kTileN, L, split, s_max, c, run);
    }
    const int n_start = c.rank;
    const bool ovf = n_start > row_cap;
    overflow[lane] = ovf;
    int last_carry = brisk::kBigPos;
    uint32_t agg_next[NW] = {};
    for (int t = tiles - 1; t >= 0; --t) {
      if (tiles > 1) {
        Carry e = entry[t];
        tile_last = forward_tile(in, base, t * kTileN, L, split, s_max, e, run);
      }
      rows_tile<NW>(in, out, lane, base, t * kTileN, L, out_w, plane, k, m, b,
                    run, last_carry, n_start, ovf, agg_next);
      if (tile_last < last_carry) last_carry = tile_last;
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

// The windows of every row rolled from `start` (out: 12 planes of R * L,
// positions before `start` untouched).
int host_roll_windows(const int64_t* codes, int64_t* out, int R, int L,
                      long long row_stride, int k, int m, int start) {
  if (m < 1 || m > brisk::kMaxM || k < 1 || k > 63 || L < 1 ||
      row_stride < L || start < 0 || start >= L)
    return 1;
  const int64_t n = (int64_t)R * L;
  const int H = (k > m ? k : m) - 1;
  std::vector<uint8_t> row(L);
  for (int64_t r = 0; r < R; ++r) {
    for (int p = 0; p < L; ++p) row[p] = (uint8_t)codes[r * row_stride + p];
    WindowSink sink{k, m, out + r * L + start, n};
    brisk::roll_run(row.data() + start, start, start < H ? start : H,
                    L - start, L, sink);
  }
  return 0;
}

// the kernels' compile-time geometry: positions.cu's run and block,
// skl_rows.cu's run and block
int host_geometry(int* out) {
  out[0] = brisk::kPosRun;
  out[1] = brisk::kPosThreads;
  out[2] = brisk::kRowRun;
  out[3] = brisk::kRowThreads;
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

// skl_rows.cu's brisk_skl_rows on host pointers (the tiles' entry values
// in a host vector)
int host_skl_rows(const void* const* in, int64_t* out, bool* overflow, int B,
                  int L, int row_cap, int out_w, int k, int m, int b,
                  int s_max, int split, int nw) {
  if (nw < 1 || nw > brisk::kMaxNW || L < 1 || L > 0x7FFFFFFF - kTileN ||
      out_w > L || out_w > row_cap)
    return 1;
  pick_rows(nw, std::make_integer_sequence<int, brisk::kMaxNW>{})(
      in, out, overflow, B, L, row_cap, out_w, k, m, b, s_max, split != 0);
  return 0;
}

}  // extern "C"
