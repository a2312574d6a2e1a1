// The enumerator's per-position minimizer state machine for Hopper
// (sm_90a).
//
// Replaces the XLA program brisk_tpu/ops/enumerate.py enumerate_batch
// `one_position` / `step` under jax.lax.scan (lines 149-188; reference
// Kmers.cpp:509-613). Plain PyTorch version beside it:
// brisk_tpu_torch.ops.enumerate._state_machine_torch, whose contract this
// kernel keeps bit for bit on any input (the step, the packing and the
// unpacking are enum_math.cuh's).
//
// For lane b and position t in [0, L_out), reading the inputs at column
// margin + t of their (B, L_buf) rows, brisk::scan_step advances the
// lane's state; the boundary is suppressed at t = 0 for a fresh lane
// (Kmers.cpp:590-592); boundary, rev, pos, mini and h are written at
// out[b*L_out + t]; the state after the last position is the lane's final
// state (the carry of the k > 32 streaming insert).
//
// What bounds it on this card. Per position it reads 11 int64 and 2 bool
// inputs and writes 3 int64 and 2 bool outputs (~130 B): ~122 MB at the
// bench geometry (B 2048, L_out 512), 0.036 ms at 3.35 TB/s. The scan is
// sequential in t, so each lane is one chain of dependent selects, and
// only B chains exist (2,048 threads for 132 SMs). The first version ran
// one thread per lane reading its own row: each warp-wide load touched
// 32 rows (a 32-byte sector for 8 useful bytes), and each position waited
// on its loads (~1,100 cycles a position, latency-bound at 11% of the
// bound).
//
// The design takes the loads off the chain. A block owns G lanes (G from
// B, so that >= 128 blocks exist: 16 at B 2048, 8 at B 1024) and walks
// their positions in tiles of kT = 32. Warp 0's first G threads scan;
// warps 1-7 produce, three steps a tile:
// * copy: cp.async into a ring of kStages raw tiles in shared memory, so
//   kStages - 1 tiles (~90 KB at G 16) are in flight while one is
//   scanned. A tile is G contiguous row segments per input; neighbouring
//   threads copy neighbouring positions, 16 bytes each where the segment
//   starts 16-byte aligned (every row at the bench geometries: the row
//   pitch L_buf x 8 and the margin x 8 are multiples of 16), else 8
//   bytes; the bool rows (L_buf bytes apart, no multiple of 4) as aligned
//   4-byte words, the row's byte skew kept. cp.async over TMA: the bool
//   rows and unaligned int64 rows rule TMA out, and 16-byte cp.async
//   already keeps the bytes in flight; halving the copy instructions
//   (16-byte over 8-byte) was what moved the time.
// * pack: once every producer's copies of the next tile have landed (a
//   barrier of the producers alone), each position goes into a packed
//   tile with the plain version's arithmetic (brisk::pack_hash for both
//   hash triples, brisk::pack_mini for both minimizers, r_pos, and the
//   two bools as one byte): 41 bytes where the raw tile holds 90, and the
//   scanning thread loads 6 values a position instead of 13 and packs
//   nothing.
// * store: the previous output tile goes to the (B, L_out) outputs as
//   contiguous row segments, 16 bytes a thread where aligned.
// The scanning thread reads packed tile j, steps, and writes output tile
// j (rows padded against bank conflicts) while the producers ready tile
// j + 1 and store tile j - 1; one block barrier a tile hands both over.

#include <cstdint>
#include <cuda_runtime.h>

#include "enum_math.cuh"

namespace {

constexpr int kThreads = 256;   // warp 0 scans, warps 1-7 produce
constexpr int kProducers = kThreads - 32;
constexpr int kT = 32;          // positions per tile
constexpr int kStages = 3;      // ring of raw input tiles
constexpr int kMaxLanes = 16;   // lanes per block (G <= 32: warp 0)
constexpr int kIn64 = 11;       // int64 inputs per position
constexpr int kPacked = 5;      // ch, cm, rh, rm, rp
constexpr int kOut64 = 3;       // pos, mini, h
constexpr int kRow = kT + 1;    // packed and output int64 row pitch: the
                                // scanning lanes read 2 banks apart
constexpr int kBRow = kT + 8;   // raw bool row pitch: skew <= 3, words
constexpr int kFRow = kT + 4;   // packed flag and output bool row pitch
constexpr int kMaxCards = 64;

struct ScanArgs {
  // (B, L_buf) inputs, read at columns [margin, L_buf): c_heavy, c_hhi,
  // c_hlo, c_lo, c_hi, r_lo, r_hi, r_pos, r_heavy, r_hhi, r_hlo
  const int64_t* in64[kIn64];
  const uint8_t* in8[2];  // c_rc, r_rev
  // (B,) initial state and fresh flags
  const int64_t* s_lo;
  const int64_t* s_hi;
  const int64_t* s_pos;
  const bool* s_rev;
  const int64_t* s_heavy;
  const int64_t* s_hhi;
  const int64_t* s_hlo;
  const bool* fresh;
  // (B, L_out) outputs: pos, mini, h; boundary, rev
  int64_t* out64[kOut64];
  uint8_t* out8[2];
  // (B,) final state
  int64_t* f_lo;
  int64_t* f_hi;
  int64_t* f_pos;
  bool* f_rev;
  int64_t* f_heavy;
  int64_t* f_hhi;
  int64_t* f_hlo;
};

// Shared memory of a block of G lanes, in this order: the raw int64 ring
// (kStages x [kIn64][G][kT]), the packed tiles (2 x [kPacked][G][kRow]),
// the output tiles (2 x [kOut64][G][kRow]), the raw bool ring (kStages x
// [2][G][kBRow]), the packed flags (2 x [G][kFRow]: c_rc | r_rev << 1),
// the output bools (2 x [2][G][kFRow]).
struct Smem {
  int64_t* raw64;
  int64_t* pk64;
  int64_t* out64;
  uint8_t* raw8;
  uint8_t* pk8;
  uint8_t* out8;
};

__host__ __device__ constexpr int smem_bytes(int G) {
  return 8 * G * (kStages * kIn64 * kT + 2 * (kPacked + kOut64) * kRow) +
         G * (kStages * 2 * kBRow + 2 * kFRow + 2 * 2 * kFRow);
}

__device__ __forceinline__ Smem carve(unsigned char* p, int G) {
  Smem m;
  m.raw64 = (int64_t*)p;
  m.pk64 = m.raw64 + kStages * kIn64 * G * kT;
  m.out64 = m.pk64 + 2 * kPacked * G * kRow;
  m.raw8 = (uint8_t*)(m.out64 + 2 * kOut64 * G * kRow);
  m.pk8 = m.raw8 + kStages * 2 * G * kBRow;
  m.out8 = m.pk8 + 2 * G * kFRow;
  return m;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the producers' own barrier (warps 1-7; barrier 0 is __syncthreads)
__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kProducers) : "memory");
}

// byte offset of row b's column `col` of a bool input inside its aligned
// 4-byte word
__device__ __forceinline__ int skew(const uint8_t* p, int64_t b, int L_buf,
                                    int col) {
  return (int)((uintptr_t)(p + b * L_buf + col) & 3u);
}

// The block's view: G lanes from b0, positions in tiles of kT.
struct Tiles {
  int b0, G, lg, B, L_buf, margin, L_out, n_tiles;
  __device__ int nt(int j) const { return min(kT, L_out - j * kT); }
  __device__ bool lane(int g) const { return b0 + g < B; }
};

// Producer p copies tile j into raw slot j % kStages: int64
// raw64[in][g][t], neighbouring producers on neighbouring positions of
// one row segment; bool words of raw8 rows [in][g] from the aligned word
// below the tile's first byte. One copy group per call.
__device__ __forceinline__ void copy_tile(const ScanArgs& a, const Smem& m,
                                          const Tiles& v, int p, int j) {
  if (j < v.n_tiles) {
    const int G = v.G, nt = v.nt(j), col0 = v.margin + j * kT;
    int64_t* st64 = m.raw64 + (j % kStages) * kIn64 * G * kT;
    uint8_t* st8 = m.raw8 + (j % kStages) * 2 * G * kBRow;
    for (int e = p; e < (kIn64 << v.lg) * (kT / 2); e += kProducers) {
      const int t = 2 * (e % (kT / 2)), seg = e / (kT / 2);
      const int g = seg & (G - 1), in = seg >> v.lg;
      if (t >= nt || !v.lane(g)) continue;
      const int64_t* src = a.in64[in] + (int64_t)(v.b0 + g) * v.L_buf + col0;
      int64_t* dst = st64 + (in * G + g) * kT;
      if (((uintptr_t)src & 15u) == 0 && t + 1 < nt) {
        cp_async16(dst + t, src + t);
      } else {
        cp_async8(dst + t, src + t);
        if (t + 1 < nt) cp_async8(dst + t + 1, src + t + 1);
      }
    }
    constexpr int kWords = kBRow / 4;
    for (int e = p; e < (2 << v.lg) * kWords; e += kProducers) {
      const int w = e % kWords, seg = e / kWords;
      const int g = seg & (G - 1), in = seg >> v.lg;
      if (!v.lane(g)) continue;
      const uint8_t* src = a.in8[in] + (int64_t)(v.b0 + g) * v.L_buf + col0;
      const int sk = (int)((uintptr_t)src & 3u);
      if (4 * w < sk + nt)
        cp_async4(st8 + (in * G + g) * kBRow + 4 * w, src - sk + 4 * w);
    }
  }
  cp_async_commit();  // empty past the end: one group per call
}

// Producer p packs raw tile j into packed tile j & 1, with the plain
// version's arithmetic: ch and rh by brisk::pack_hash, cm and rm by
// brisk::pack_mini, r_pos as it is, the two bools as one byte.
__device__ __forceinline__ void pack_tile(const ScanArgs& a, const Smem& m,
                                          const Tiles& v, int p, int j) {
  const int G = v.G, nt = v.nt(j), in_step = G * kT, pk_step = G * kRow;
  const int64_t* st64 = m.raw64 + (j % kStages) * kIn64 * G * kT;
  const uint8_t* st8 = m.raw8 + (j % kStages) * 2 * G * kBRow;
  int64_t* pk = m.pk64 + (j & 1) * kPacked * G * kRow;
  uint8_t* fl = m.pk8 + (j & 1) * G * kFRow;
  for (int e = p; e < G * kT; e += kProducers) {
    const int t = e % kT, g = e / kT;
    if (t >= nt || !v.lane(g)) continue;
    const int64_t* r = st64 + g * kT + t;
    const int64_t b = v.b0 + g;
    const uint8_t crc =
        st8[g * kBRow + skew(a.in8[0], b, v.L_buf, v.margin) + t];
    const uint8_t rrev =
        st8[(G + g) * kBRow + skew(a.in8[1], b, v.L_buf, v.margin) + t];
    int64_t* q = pk + g * kRow + t;
    q[0] = brisk::pack_hash(r[0], r[in_step], r[2 * in_step]);
    q[pk_step] = brisk::pack_mini(r[3 * in_step], r[4 * in_step]);
    q[2 * pk_step] = brisk::pack_hash(r[8 * in_step], r[9 * in_step],
                                      r[10 * in_step]);
    q[3 * pk_step] = brisk::pack_mini(r[5 * in_step], r[6 * in_step]);
    q[4 * pk_step] = r[7 * in_step];
    fl[g * kFRow + t] = (crc != 0) | (uint8_t)((rrev != 0) << 1);
  }
}

// Producer p stores output tile j (j & 1) as contiguous row segments of
// the (B, L_out) outputs.
__device__ __forceinline__ void store_tile(const ScanArgs& a, const Smem& m,
                                           const Tiles& v, int p, int j) {
  const int G = v.G, nt = v.nt(j), t0 = j * kT;
  const int64_t* o64 = m.out64 + (j & 1) * kOut64 * G * kRow;
  const uint8_t* o8 = m.out8 + (j & 1) * 2 * G * kFRow;
  for (int e = p; e < (kOut64 << v.lg) * (kT / 2); e += kProducers) {
    const int t = 2 * (e % (kT / 2)), seg = e / (kT / 2);
    const int g = seg & (G - 1), o = seg >> v.lg;
    if (t >= nt || !v.lane(g)) continue;
    int64_t* dst = a.out64[o] + (int64_t)(v.b0 + g) * v.L_out + t0 + t;
    const int64_t* src = o64 + (o * G + g) * kRow + t;
    if (((uintptr_t)dst & 15u) == 0 && t + 1 < nt) {
      *(longlong2*)dst = make_longlong2(src[0], src[1]);
    } else {
      dst[0] = src[0];
      if (t + 1 < nt) dst[1] = src[1];
    }
  }
  for (int e = p; e < (2 << v.lg) * kT; e += kProducers) {
    const int t = e % kT, seg = e / kT;
    const int g = seg & (G - 1), o = seg >> v.lg;
    if (t < nt && v.lane(g))
      a.out8[o][(int64_t)(v.b0 + g) * v.L_out + t0 + t] =
          o8[(o * G + g) * kFRow + t];
  }
}

// Producer p readies tile j for the scan: waits for its raw copies (tile
// j's group; kStages - 1 later groups may still be in flight), packs it
// once every producer's copies have landed, then refills the raw slot
// with tile j + kStages.
__device__ __forceinline__ void prepare(const ScanArgs& a, const Smem& m,
                                        const Tiles& v, int p, int j) {
  cp_async_wait<kStages - 1>();
  producers_sync();
  pack_tile(a, m, v, p, j);
  producers_sync();
  copy_tile(a, m, v, p, j + kStages);
}

__global__ void __launch_bounds__(kThreads)
state_scan_kernel(const __grid_constant__ ScanArgs a, int B, int L_buf,
                  int margin, int64_t km, int G, int lg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem m = carve(smem, G);
  Tiles v;
  v.b0 = blockIdx.x * G;
  v.G = G;
  v.lg = lg;
  v.B = B;
  v.L_buf = L_buf;
  v.margin = margin;
  v.L_out = L_buf - margin;
  v.n_tiles = (v.L_out + kT - 1) / kT;
  const int g = threadIdx.x, p = threadIdx.x - 32;
  const bool producer = threadIdx.x >= 32;
  const bool scans = g < G && v.lane(g);
  const int64_t b = v.b0 + g;

  brisk::ScanState s{};
  bool fresh = false;
  if (scans) {
    s.h = brisk::pack_hash(a.s_heavy[b], a.s_hhi[b], a.s_hlo[b]);
    s.mini = brisk::pack_mini(a.s_lo[b], a.s_hi[b]);
    s.pos = a.s_pos[b];
    s.rev = a.s_rev[b];
    fresh = a.fresh[b];
  }
  if (producer) {
    for (int j = 0; j < kStages; ++j) copy_tile(a, m, v, p, j);
    if (v.n_tiles > 0) prepare(a, m, v, p, 0);
  }
  __syncthreads();
  // Tile j: warp 0 scans packed tile j into output tile j while the
  // producers ready tile j + 1 and store output tile j - 1; one barrier.
  for (int j = 0; j < v.n_tiles; ++j) {
    if (scans) {
      const int t0 = j * kT, nt = v.nt(j), step = G * kRow;
      const int64_t* pk = m.pk64 + ((j & 1) * kPacked * G + g) * kRow;
      const uint8_t* fl = m.pk8 + ((j & 1) * G + g) * kFRow;
      int64_t* o64 = m.out64 + ((j & 1) * kOut64 * G + g) * kRow;
      uint8_t* o8 = m.out8 + ((j & 1) * 2 * G + g) * kFRow;
#pragma unroll 4
      for (int t = 0; t < nt; ++t) {
        const uint8_t f = fl[t];
        const bool bd = brisk::scan_step(s, pk[t], pk[step + t], f & 1,
                                         pk[2 * step + t], pk[3 * step + t],
                                         pk[4 * step + t], (f & 2) != 0,
                                         km) &&
                        !(t0 + t == 0 && fresh);
        o64[t] = s.pos;
        o64[step + t] = s.mini;
        o64[2 * step + t] = s.h;
        o8[t] = bd;
        o8[G * kFRow + t] = s.rev;
      }
    } else if (producer) {
      if (j + 1 < v.n_tiles) prepare(a, m, v, p, j + 1);
      if (j > 0) store_tile(a, m, v, p, j - 1);
    }
    __syncthreads();
  }
  if (producer) {
    if (v.n_tiles > 0) store_tile(a, m, v, p, v.n_tiles - 1);
    cp_async_wait<0>();  // no copy outlives the block
  }

  if (scans) {
    int64_t heavy, hhi, hlo;
    brisk::unpack_hash(s.h, heavy, hhi, hlo);
    a.f_lo[b] = s.mini & brisk::kM32;
    a.f_hi[b] = s.mini >> 32;
    a.f_pos[b] = s.pos;
    a.f_rev[b] = s.rev;
    a.f_heavy[b] = heavy;
    a.f_hhi[b] = hhi;
    a.f_hlo[b] = hlo;
  }
}

// lanes per block: the largest power of two <= B / 128, in [1, 16]
int lanes_per_block(int B) {
  int G = 1;
  while (G < kMaxLanes && 2 * G * 128 <= B) G *= 2;
  return G;
}

}  // namespace

// in: the 21 input pointers (13 per-position inputs c_heavy, c_hhi,
// c_hlo, c_lo, c_hi, c_rc, r_lo, r_hi, r_pos, r_rev, r_heavy, r_hhi,
// r_hlo; the 7 initial-state fields; fresh); out: the 12 output pointers
// (boundary, rev, pos, mini, h; the 7 final-state fields). Returns a
// cudaError_t: the launch's, or cudaErrorInvalidValue for margin outside
// [0, L_buf].
extern "C" int brisk_state_scan(const void* const* in, void* const* out,
                                int B, int L_buf, int margin, int km,
                                void* stream) {
  if (margin < 0 || margin > L_buf) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  ScanArgs a;
  const int order64[kIn64] = {0, 1, 2, 3, 4, 6, 7, 8, 10, 11, 12};
  for (int i = 0; i < kIn64; ++i) a.in64[i] = (const int64_t*)in[order64[i]];
  a.in8[0] = (const uint8_t*)in[5];
  a.in8[1] = (const uint8_t*)in[9];
  a.s_lo = (const int64_t*)in[13];
  a.s_hi = (const int64_t*)in[14];
  a.s_pos = (const int64_t*)in[15];
  a.s_rev = (const bool*)in[16];
  a.s_heavy = (const int64_t*)in[17];
  a.s_hhi = (const int64_t*)in[18];
  a.s_hlo = (const int64_t*)in[19];
  a.fresh = (const bool*)in[20];
  a.out8[0] = (uint8_t*)out[0];
  a.out8[1] = (uint8_t*)out[1];
  a.out64[0] = (int64_t*)out[2];
  a.out64[1] = (int64_t*)out[3];
  a.out64[2] = (int64_t*)out[4];
  a.f_lo = (int64_t*)out[5];
  a.f_hi = (int64_t*)out[6];
  a.f_pos = (int64_t*)out[7];
  a.f_rev = (bool*)out[8];
  a.f_heavy = (int64_t*)out[9];
  a.f_hhi = (int64_t*)out[10];
  a.f_hlo = (int64_t*)out[11];
  const int G = lanes_per_block(B);
  int lg = 0;
  while ((1 << lg) < G) ++lg;
  // the opt-in above 48 KB of shared memory is the kernel's on a card:
  // set once per card, at its first launch (not inside a CUDA graph's
  // capture of later launches)
  static bool opted_in[kMaxCards] = {};
  int card = 0;
  cudaError_t rc = cudaGetDevice(&card);
  if (rc != cudaSuccess) return (int)rc;
  if (card < 0 || card >= kMaxCards) return (int)cudaErrorInvalidDevice;
  if (!opted_in[card]) {
    rc = cudaFuncSetAttribute(state_scan_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes(kMaxLanes));
    if (rc != cudaSuccess) return (int)rc;
    opted_in[card] = true;
  }
  const int bytes = smem_bytes(G);
  const dim3 grid((B + G - 1) / G);
  state_scan_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      a, B, L_buf, margin, (int64_t)km, G, lg);
  return (int)cudaGetLastError();
}
