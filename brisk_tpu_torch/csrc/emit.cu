// The enumerator's emission epilogue for Hopper (sm_90a): at every
// emitting position, the emitted k-mer, its stored key (the minimizer
// slice replaced by its mixed hash), its bucket and the unpacked
// minimizer and hash, one thread per (lane, position).
//
// Replaces the XLA fusion after the scan in brisk_tpu/ops/enumerate.py
// enumerate_batch (lines 197-272) with _hash_slice_replace (:275-285) and
// _bucket_id (:288-296). Plain PyTorch version beside it:
// brisk_tpu_torch.ops.enumerate._emit_torch, whose contract this kernel
// keeps bit for bit: the arithmetic is flush_math.cuh's
// (brisk::emit_position) over enum_math.cuh's mixer.
//
// Inputs: the state machine's (B, L_out) rows rev (bool), pos, mini
// (lo | hi << 32) and h (hashing.pack_hash), and the position pipeline's
// 4-limb fwd_k and rc_k, (B, L_buf) each, read at column margin + t
// (margin = L_buf - L_out). Outputs: 14 int64 planes of B * L_out values:
// mini_idx, mini_lo, mini_hi, hash_hi, hash_lo, the emitted k-mer's 4
// limbs, the key's 4 limbs, bucket.
//
// What bounds it on this card: bytes. Per position it reads 3 int64 and
// one bool of the state machine and the 4 int64 limbs of the orientation
// rev selects, and writes 14 int64 (169 B): 177 MB at the insert's batch
// (B 2048, L_out 512), 0.053 ms at 3.35 TB/s; its arithmetic (two
// variable 128-bit shifts, the 7-step mixer) is a few dozen integer
// operations a position. The design is the plain one: a thread per
// position, its loads and stores coalesced across neighbouring positions
// of a lane (rev is the minimizer's orientation, so it holds along a
// super-k-mer and a warp mostly reads one of fwd_k and rc_k); the 128-bit
// shifts are unsigned __int128 shifts guarded to [0, 128).

#include <cstdint>
#include <cuda_runtime.h>

#include "flush_math.cuh"

namespace {

constexpr int kThreads = 256;

struct EmitArgs {
  const bool* rev;       // (B, L_out)
  const int64_t* pos;
  const int64_t* mini;
  const int64_t* h;
  const int64_t* fwd[4];  // (B, L_buf)
  const int64_t* rc[4];
  int64_t* out;          // 14 planes of B * L_out
};

__device__ __forceinline__ int64_t ld64(const int64_t* p) {
  return (int64_t)__ldg((const long long*)p);
}

__global__ void __launch_bounds__(kThreads)
emit_kernel(const __grid_constant__ EmitArgs a, int64_t n, int L_out,
            int L_buf, int km, int m, int b) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  const int64_t lane = idx / L_out;
  const int64_t q = lane * L_buf + (L_buf - L_out) + (idx - lane * L_out);
  // only the orientation that rev selects is read
  const bool rev = __ldg((const unsigned char*)a.rev + idx) != 0;
  int64_t limbs[4];
  for (int i = 0; i < 4; ++i) limbs[i] = ld64((rev ? a.rc[i] : a.fwd[i]) + q);
  const brisk::u128 kmer =
      brisk::from_limbs(limbs[0], limbs[1], limbs[2], limbs[3]);
  const brisk::Emitted e =
      brisk::emit_position(rev, ld64(a.pos + idx), ld64(a.mini + idx),
                           ld64(a.h + idx), kmer, kmer, km, m, b);
  int64_t* o = a.out + idx;
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

}  // namespace

// in: the 12 input pointers in EmitArgs order (rev, pos, mini, h, the 4
// fwd_k limbs, the 4 rc_k limbs); out: 14 planes of B * L_out int64.
// Returns a cudaError_t: the launch's, or cudaErrorInvalidValue for
// L_out outside [1, L_buf], m outside [1, 31], b outside [0, 15] or km
// < 0.
extern "C" int brisk_emit(const void* const* in, void* out, int B,
                          int L_out, int L_buf, int km, int m, int b,
                          void* stream) {
  if (L_out < 1 || L_out > L_buf || m < 1 || m > brisk::kMaxM || b < 0 ||
      b > 15 || km < 0 || B < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)B * L_out;
  if (n == 0) return 0;
  EmitArgs a;
  a.rev = (const bool*)in[0];
  a.pos = (const int64_t*)in[1];
  a.mini = (const int64_t*)in[2];
  a.h = (const int64_t*)in[3];
  for (int i = 0; i < 4; ++i) {
    a.fwd[i] = (const int64_t*)in[4 + i];
    a.rc[i] = (const int64_t*)in[8 + i];
  }
  a.out = (int64_t*)out;
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  emit_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a, n, L_out,
                                                           L_buf, km, m, b);
  return (int)cudaGetLastError();
}
