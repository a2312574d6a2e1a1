// The enumerator's per-position minimizer state machine for Hopper
// (sm_90a): one thread per record lane, sequential over the lane's
// emitting positions.
//
// Replaces the XLA program brisk_tpu/ops/enumerate.py enumerate_batch
// `one_position` / `step` under jax.lax.scan (lines 149-188; reference
// Kmers.cpp:509-613). Plain PyTorch version beside it:
// brisk_tpu_torch.ops.enumerate._state_machine_torch, whose contract this
// kernel keeps bit for bit.
//
// For lane b and position t in [0, L_out), reading the inputs at column
// margin + t of their (B, L_buf) rows:
//   pos1 = pos + 1; expiry = pos1 > k - m;
//   improve = !expiry && cand_h[t] < h          (signed int64 compare)
//   state = expiry ? rescan[t] : improve ? (candidate, pos 0) : (state,
//   pos1); boundary = expiry || improve, suppressed at t = 0 for a fresh
//   lane (Kmers.cpp:590-592);
// and writes boundary, rev, pos, mini and h at out[b*L_out + t]; the
// state after the last position is the lane's final state (the carry of
// the k > 32 streaming insert).
//
// Packed values, as in the plain version: a hash triple (heavy, hi, lo)
// rides as ONE int64 h = (heavy - 2) * 2^62 + (hi << 32 | lo), which
// orders like the reference's uint64 hash when compared SIGNED (heavy
// class 2 is the largest; an unsigned compare sorts it first); a
// minimizer as lo | hi << 32. Both are formed in uint64 so that they
// wrap like PyTorch's int64 on any input.
//
// What bounds it on this card. Memory: per position it reads 11 int64
// and 2 bool inputs and writes 3 int64 and 2 bool outputs (~130 B), so
// ~140 MB at the bench geometry (B 2048, L_out 512), ~0.04 ms at
// 3.35 TB/s. But the scan is sequential in t, so a lane is one chain of
// dependent selects (~10 instructions a position) and only B threads are
// in flight: 2048 lanes fill 64 warps on 132 SMs. The kernel is bound by
// the latency of that chain and of its loads, not by bytes. What the
// design does about it: the inputs do not depend on the state, so the
// loop is unrolled and their loads issue ahead of the chain; blocks of 32
// threads spread the lanes over the SMs; the inputs are read in place
// from their (B, L_buf) rows (no transposes) and the outputs are written
// in the (B, L_out) layout that their consumers read.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;  // lanes per block: spread B lanes over SMs

struct ScanArgs {
  // (B, L_buf) inputs, read at columns [margin, L_buf)
  const int64_t* c_heavy;
  const int64_t* c_hhi;
  const int64_t* c_hlo;
  const int64_t* c_lo;
  const int64_t* c_hi;
  const bool* c_rc;
  const int64_t* r_lo;
  const int64_t* r_hi;
  const int64_t* r_pos;
  const bool* r_rev;
  const int64_t* r_heavy;
  const int64_t* r_hhi;
  const int64_t* r_hlo;
  // (B,) initial state and fresh flags
  const int64_t* s_lo;
  const int64_t* s_hi;
  const int64_t* s_pos;
  const bool* s_rev;
  const int64_t* s_heavy;
  const int64_t* s_hhi;
  const int64_t* s_hlo;
  const bool* fresh;
  // (B, L_out) outputs
  bool* o_bd;
  bool* o_rev;
  int64_t* o_pos;
  int64_t* o_mini;
  int64_t* o_h;
  // (B,) final state
  int64_t* f_lo;
  int64_t* f_hi;
  int64_t* f_pos;
  bool* f_rev;
  int64_t* f_heavy;
  int64_t* f_hhi;
  int64_t* f_hlo;
};

// hashing.pack_hash: (heavy - 2) * 2^62 + ((hi << 32) | lo), wrapping.
__device__ __forceinline__ int64_t pack_hash(int64_t heavy, int64_t hi,
                                             int64_t lo) {
  const uint64_t key = ((uint64_t)hi << 32) | (uint64_t)lo;
  return (int64_t)(((uint64_t)heavy - 2) * (1ull << 62) + key);
}

__device__ __forceinline__ int64_t pack_mini(int64_t lo, int64_t hi) {
  return (int64_t)((uint64_t)lo | ((uint64_t)hi << 32));
}

// read-only loads through the non-coherent cache
__device__ __forceinline__ int64_t ld64(const int64_t* p) {
  return (int64_t)__ldg((const long long*)p);
}

__device__ __forceinline__ bool ldb(const bool* p) {
  return __ldg((const unsigned char*)p) != 0;
}

__global__ void __launch_bounds__(kThreads)
state_scan_kernel(const ScanArgs a, int B, int L_buf, int margin,
                  int64_t km) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int L_out = L_buf - margin;
  int64_t h = pack_hash(a.s_heavy[b], a.s_hhi[b], a.s_hlo[b]);
  int64_t mini = pack_mini(a.s_lo[b], a.s_hi[b]);
  int64_t pos = a.s_pos[b];
  bool rev = a.s_rev[b];
  const bool fresh = a.fresh[b];
  const int64_t in0 = (int64_t)b * L_buf + margin;
  const int64_t out0 = (int64_t)b * L_out;
#pragma unroll 8
  for (int t = 0; t < L_out; ++t) {
    const int64_t i = in0 + t;
    // loads that do not depend on the state (hoisted by the unroll)
    const int64_t ch = pack_hash(ld64(a.c_heavy + i), ld64(a.c_hhi + i),
                                 ld64(a.c_hlo + i));
    const int64_t cm = pack_mini(ld64(a.c_lo + i), ld64(a.c_hi + i));
    const bool crc = ldb(a.c_rc + i);
    const int64_t rh = pack_hash(ld64(a.r_heavy + i), ld64(a.r_hhi + i),
                                 ld64(a.r_hlo + i));
    const int64_t rm = pack_mini(ld64(a.r_lo + i), ld64(a.r_hi + i));
    const int64_t rp = ld64(a.r_pos + i);
    const bool rrev = ldb(a.r_rev + i);

    const int64_t pos1 = (int64_t)((uint64_t)pos + 1);
    const bool expiry = pos1 > km;
    const bool improve = !expiry && ch < h;
    mini = expiry ? rm : (improve ? cm : mini);
    pos = expiry ? rp : (improve ? 0 : pos1);
    rev = expiry ? rrev : (improve ? crc : rev);
    h = expiry ? rh : (improve ? ch : h);
    const bool boundary = (expiry || improve) && !(t == 0 && fresh);

    const int64_t o = out0 + t;
    a.o_bd[o] = boundary;
    a.o_rev[o] = rev;
    a.o_pos[o] = pos;
    a.o_mini[o] = mini;
    a.o_h[o] = h;
  }
  // hashing.unpack_hash and the minimizer's limbs
  const int64_t key = h & ((1ll << 62) - 1);
  a.f_lo[b] = mini & 0xFFFFFFFFll;
  a.f_hi[b] = mini >> 32;
  a.f_pos[b] = pos;
  a.f_rev[b] = rev;
  a.f_heavy[b] = (h >> 62) + 2;
  a.f_hhi[b] = key >> 32;
  a.f_hlo[b] = key & 0xFFFFFFFFll;
}

}  // namespace

// in: the 21 input pointers in ScanArgs order (13 per-position inputs,
// the 7 initial-state fields, fresh); out: the 12 output pointers (5
// per-position outputs, the 7 final-state fields). Returns a cudaError_t:
// the launch's, or cudaErrorInvalidValue for margin outside [0, L_buf].
extern "C" int brisk_state_scan(const void* const* in, void* const* out,
                                int B, int L_buf, int margin, int km,
                                void* stream) {
  if (margin < 0 || margin > L_buf) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  ScanArgs a;
  a.c_heavy = (const int64_t*)in[0];
  a.c_hhi = (const int64_t*)in[1];
  a.c_hlo = (const int64_t*)in[2];
  a.c_lo = (const int64_t*)in[3];
  a.c_hi = (const int64_t*)in[4];
  a.c_rc = (const bool*)in[5];
  a.r_lo = (const int64_t*)in[6];
  a.r_hi = (const int64_t*)in[7];
  a.r_pos = (const int64_t*)in[8];
  a.r_rev = (const bool*)in[9];
  a.r_heavy = (const int64_t*)in[10];
  a.r_hhi = (const int64_t*)in[11];
  a.r_hlo = (const int64_t*)in[12];
  a.s_lo = (const int64_t*)in[13];
  a.s_hi = (const int64_t*)in[14];
  a.s_pos = (const int64_t*)in[15];
  a.s_rev = (const bool*)in[16];
  a.s_heavy = (const int64_t*)in[17];
  a.s_hhi = (const int64_t*)in[18];
  a.s_hlo = (const int64_t*)in[19];
  a.fresh = (const bool*)in[20];
  a.o_bd = (bool*)out[0];
  a.o_rev = (bool*)out[1];
  a.o_pos = (int64_t*)out[2];
  a.o_mini = (int64_t*)out[3];
  a.o_h = (int64_t*)out[4];
  a.f_lo = (int64_t*)out[5];
  a.f_hi = (int64_t*)out[6];
  a.f_pos = (int64_t*)out[7];
  a.f_rev = (bool*)out[8];
  a.f_heavy = (int64_t*)out[9];
  a.f_hhi = (int64_t*)out[10];
  a.f_hlo = (int64_t*)out[11];
  const dim3 grid((B + kThreads - 1) / kThreads);
  state_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      a, B, L_buf, margin, (int64_t)km);
  return (int)cudaGetLastError();
}
