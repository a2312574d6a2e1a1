"""Per-position minimizer pipeline and the vectorized get_minimizer
rescan (port of brisk_tpu.ops.minimizer).

position_pipeline computes every position's k- and m-base windows and
its candidate m-mer, with its hash, at once: on a CUDA tensor one
hand-written kernel (kernels.positions, csrc/positions.cu: one thread
per position), on the CPU the plain version (`position_pipeline_torch`).

get_minimizer (reference Kmers.cpp:367-408) is evaluated for EVERY
position at once. On a CUDA tensor one hand-written kernel does it
(kernels.rescan, csrc/rescan.cu: one thread per position over the
window's offsets); on the CPU the plain version
(`windowed_get_minimizer_torch`), a loop over window offsets i, applies
the literal branch logic (strict improvement; equal-hash closer-to-edge
mirror rule; equal-distance strand rule) as selects over (..., L)
tensors.

Replicated quirk (Kmers.cpp:371): the reference truncates the k-mer to
its low 64 bits before scanning, so for k > 32 offsets with
2*(i+m) > 64 recompute the masked m-mer's canonical form, class and hash.
"""

from typing import NamedTuple

import torch

from brisk_tpu_torch import kernels
from brisk_tpu_torch.ops import codec, decycling, hashing, revcomp, u128


class PositionArrays(NamedTuple):
    fwd_k: u128.Limbs       # 4-limb forward k-mer
    rc_k: u128.Limbs        # 4-limb true-RC k-mer
    fwd_m: u128.Limbs       # 2-limb forward m-mer
    rc_m: u128.Limbs        # 2-limb true-RC m-mer
    canon_m: u128.Limbs     # 2-limb canonical m-mer (rolling candidate)
    cand_hash: tuple        # (heavy, hi, lo) hash of canon_m
    cand_is_rc: torch.Tensor  # canon_m == rc_m (rolling `reversed`)
    scan_rev: torch.Tensor    # canon_m != fwd_m (get_minimizer `reversed`)


class MinimizerState(NamedTuple):
    """get_minimizer result / enumerator state, per element."""
    mini_lo: torch.Tensor
    mini_hi: torch.Tensor
    pos: torch.Tensor       # min_position (distance from the suffix end)
    rev: torch.Tensor       # bool
    heavy: torch.Tensor
    hash_hi: torch.Tensor
    hash_lo: torch.Tensor


def position_pipeline(codes: torch.Tensor, k: int, m: int) -> PositionArrays:
    """Window values and candidates at every position of int64 (R, L)
    2-bit codes (rows may be strided slices). On a CUDA tensor one
    kernel (kernels.positions), on the CPU the plain version."""
    if codes.device.type != "cuda":
        return position_pipeline_torch(codes, k, m)
    if codes.stride(-1) != 1:
        codes = codes.contiguous()
    return PositionArrays(*kernels.positions(
        codes, decycling.coef_table(m, codes.device), k, m))


def position_pipeline_torch(codes: torch.Tensor, k: int, m: int
                            ) -> PositionArrays:
    """The plain version of position_pipeline: the reference's fused pass
    as elementwise torch ops over whole (R, L) tensors."""
    fwd_k, rc_k, fwd_m, rc_m = codec.kmer_windows(codes, k, m)
    canon_m = u128.minimum(fwd_m, rc_m)
    cand_hash = hashing.bfc_hash(canon_m[0], canon_m[1], m)
    cand_is_rc = u128.eq(canon_m, rc_m)
    scan_rev = ~u128.eq(canon_m, fwd_m)
    return PositionArrays(fwd_k, rc_k, fwd_m, rc_m, canon_m, cand_hash,
                          cand_is_rc, scan_rev)


def windowed_get_minimizer(pa: PositionArrays, kmer4: u128.Limbs,
                           k_arg: int, m: int, with_unique: bool = False):
    """Literal replication of get_minimizer over every position; kmer4
    holds the k_arg-base window ending at each position. On a CUDA tensor
    the kernel (kernels.rescan), on the CPU the plain version.

    with_unique: also return a bool tensor marking positions whose window
    minimum hash is attained by exactly one offset (the windowed packer's
    re-sync certificate; meaningful for k_arg <= 32 only)."""
    if pa.scan_rev.device.type != "cuda":
        return windowed_get_minimizer_torch(pa, kmer4, k_arg, m,
                                            with_unique)
    def dense(ts):  # k-mer limbs can be strided slices of a padded pack
        return tuple(t.contiguous() for t in ts)

    out = kernels.rescan(
        dense(pa.canon_m), dense(pa.cand_hash), pa.scan_rev.contiguous(),
        dense(kmer4), decycling.coef_table(m, pa.scan_rev.device), k_arg, m,
        with_unique)
    if with_unique:
        return MinimizerState(*out[0]), out[1]
    return MinimizerState(*out)


def windowed_get_minimizer_torch(pa: PositionArrays, kmer4: u128.Limbs,
                                 k_arg: int, m: int,
                                 with_unique: bool = False):
    """The plain version of windowed_get_minimizer: a loop over the
    window's offsets of selects over whole (..., L) tensors."""
    W = k_arg - m + 1
    canonized = revcomp.canonized_k(kmer4, k_arg)
    heavy, hhi, hlo = pa.cand_hash
    clean_max = (64 - 2 * m) // 2  # offsets i <= clean_max are untruncated
    trunc = (kmer4[0], kmer4[1])   # uint64_t cur_seq = seq

    state = MinimizerState(pa.canon_m[0], pa.canon_m[1],
                           torch.zeros_like(hlo), pa.scan_rev,
                           heavy, hhi, hlo)
    cnt = torch.ones_like(hlo)  # offsets attaining the running min hash
    scan_rev64 = pa.scan_rev.to(torch.int64)
    sh = codec._shift_right_axis
    for i in range(1, W):
        if i <= clean_max:
            hv, hh, hl = sh(heavy, i), sh(hhi, i), sh(hlo, i)
            c_lo, c_hi = sh(pa.canon_m[0], i), sh(pa.canon_m[1], i)
            rev_i = sh(scan_rev64, i) != 0
        else:
            mm = u128.mask_bits(u128.shr(trunc, 2 * i), 2 * m)
            c_lo, c_hi = revcomp.canonize64(mm[0], mm[1], m)
            hv, hh, hl = hashing.bfc_hash(c_lo, c_hi, m)
            rev_i = ~((c_lo == mm[0]) & (c_hi == mm[1]))
        h = (hv, hh, hl)
        cur = (state.heavy, state.hash_hi, state.hash_lo)
        lt = hashing.hash_lt(h, cur)
        eq = hashing.hash_eq(h, cur)
        mirror = W - 1 - i
        take_closer = eq & (mirror < state.pos)
        take_strand = eq & (mirror == state.pos) & (~canonized)
        take_hash = lt | take_closer
        take_any = take_hash | take_strand
        new_pos = torch.where(lt, i, mirror)
        cnt = torch.where(lt, 1, torch.where(eq, cnt + 1, cnt))
        state = MinimizerState(
            mini_lo=torch.where(take_any, c_lo, state.mini_lo),
            mini_hi=torch.where(take_any, c_hi, state.mini_hi),
            pos=torch.where(take_any, new_pos, state.pos),
            rev=torch.where(take_hash, rev_i, state.rev & ~take_strand),
            heavy=torch.where(take_hash, hv, state.heavy),
            hash_hi=torch.where(take_hash, hh, state.hash_hi),
            hash_lo=torch.where(take_hash, hl, state.hash_lo))
    if with_unique:
        return state, cnt == 1
    return state
