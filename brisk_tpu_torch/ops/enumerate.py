"""Batched streaming super-k-mer enumerator (port of
brisk_tpu.ops.enumerate).

A batch of B record lanes advances in lock-step over L positions. The
heavy per-position math (window values, candidate hashes, full
get_minimizer rescans) is computed up front over whole (B, L) tensors;
the per-position state machine that remains replicates the reference's
control flow literally (Kmers.cpp:509-613):

    mini_pos += 1
    if mini_pos > k-m:        state = get_minimizer(kmer)      (expiry)
    elif cand_hash < hash:    state = rolling candidate        (new mini)
    emit k-mer in fwd or RC orientation per state.reversed

`_state_machine` runs it on a CUDA tensor as one hand-written kernel
(kernels.state_scan, csrc/state_scan.cu: one thread per lane over its
positions, the port of the reference's lax.scan) and on the CPU as its
plain version, a Python loop over positions on (B,) tensors
(`_state_machine_torch`); the hash triple and the minimizer each ride as
ONE int64 so a step is a dozen elementwise ops. The epilogue after it
(the emitted k-mer, its key and bucket: `_emit`) is one kernel on a CUDA
tensor (kernels.emit, csrc/emit.cu) and `_emit_torch` on the CPU.

Layout contract for a (B, L_buf) codes buffer with margin = k-1 is the
reference's: fresh lanes start at index 0; continuing lanes hold their
previous k-1 bases in [0, margin); emissions are at positions
[margin, L_buf) and valid while p < valid_end (and p >= valid_start in
windowed mode).
"""

from typing import NamedTuple, Tuple

import torch

from brisk_tpu_torch import kernels
from brisk_tpu_torch._u32 import M32
from brisk_tpu_torch.ops import hashing, minimizer, u128
from brisk_tpu_torch.ops.minimizer import MinimizerState


class Emissions(NamedTuple):
    """Per-position emission records, tensors shaped (B, L_out)."""
    valid: torch.Tensor     # bool: real k-mer emitted here
    boundary: torch.Tensor  # bool: a super-k-mer ended just before this
    use_rc: torch.Tensor    # bool: emitted in RC orientation
    mini_idx: torch.Tensor  # minimizer_idx (suffix length)
    mini_lo: torch.Tensor   # canonical minimizer value (2 limbs)
    mini_hi: torch.Tensor
    hash_hi: torch.Tensor   # mixed 2m-bit minimizer hash (no heavy)
    hash_lo: torch.Tensor
    kmer: torch.Tensor      # (4, B, L_out): emitted (oriented) k-mer
    key: torch.Tensor       # (4, B, L_out): hashed k-mer (slice replaced)
    bucket: torch.Tensor    # reduced-minimizer bucket id
    cert: torch.Tensor      # (B,) bool: warm-up re-sync certificate
    replay: MinimizerState  # (B,) state at valid_start-1 (windowed mode)


def zero_carry(batch: int, device="cpu") -> MinimizerState:
    z = torch.zeros(batch, dtype=torch.int64, device=device)
    return MinimizerState(z, z, z, torch.zeros(batch, dtype=torch.bool,
                                               device=device), z, z, z)


def _cols(x: torch.Tensor, margin: int) -> torch.Tensor:
    """(B, L_buf) -> (L_out, B) contiguous over the emitting positions."""
    return x[:, margin:].t().contiguous()


def _state_machine(state0: MinimizerState, pa, rescan, fresh, km: int,
                   margin: int):
    """Run the per-position machine; returns per-position (B, L_out)
    outputs [boundary, rev, pos, mini, h] and the final state. On a CUDA
    tensor the kernel (kernels.state_scan), on the CPU the plain
    version."""
    if fresh.device.type != "cuda":
        return _state_machine_torch(state0, pa, rescan, fresh, km, margin)
    cand = tuple(pa.cand_hash) + tuple(pa.canon_m) + (pa.cand_is_rc,)
    rows, final = kernels.state_scan(
        *(tuple(t.contiguous() for t in ts)
          for ts in (cand, rescan, state0)), fresh.contiguous(), km, margin)
    return rows, MinimizerState(*final)


def _state_machine_torch(state0: MinimizerState, pa, rescan, fresh,
                         km: int, margin: int):
    """The plain version of _state_machine: a Python loop over positions
    on (B,) tensors."""
    c_h = _cols(hashing.pack_hash(*pa.cand_hash), margin)
    c_mini = _cols(pa.canon_m[0] | (pa.canon_m[1] << 32), margin)
    c_rc = _cols(pa.cand_is_rc, margin)
    r_h = _cols(hashing.pack_hash(rescan.heavy, rescan.hash_hi,
                                  rescan.hash_lo), margin)
    r_mini = _cols(rescan.mini_lo | (rescan.mini_hi << 32), margin)
    r_pos = _cols(rescan.pos, margin)
    r_rev = _cols(rescan.rev, margin)

    h = hashing.pack_hash(state0.heavy, state0.hash_hi, state0.hash_lo)
    mini = state0.mini_lo | (state0.mini_hi << 32)
    pos, rev = state0.pos, state0.rev
    o_bd, o_rev, o_pos, o_mini, o_h = [], [], [], [], []
    for t in range(c_h.shape[0]):
        pos1 = pos + 1
        expiry = pos1 > km
        improve = (c_h[t] < h) & ~expiry
        mini = torch.where(expiry, r_mini[t],
                           torch.where(improve, c_mini[t], mini))
        pos = torch.where(expiry, r_pos[t], torch.where(improve, 0, pos1))
        rev = torch.where(expiry, r_rev[t],
                          torch.where(improve, c_rc[t], rev))
        h = torch.where(expiry, r_h[t], torch.where(improve, c_h[t], h))
        boundary = expiry | improve
        if t == 0:
            boundary = boundary & ~fresh  # Kmers.cpp:590-592
        o_bd.append(boundary)
        o_rev.append(rev)
        o_pos.append(pos)
        o_mini.append(mini)
        o_h.append(h)
    heavy, hh, hl = hashing.unpack_hash(h)
    final = MinimizerState(mini & M32, mini >> 32, pos, rev, heavy, hh, hl)
    rows = [torch.stack(o, dim=1) for o in (o_bd, o_rev, o_pos, o_mini,
                                             o_h)]
    return rows, final


def enumerate_batch(codes: torch.Tensor, fresh: torch.Tensor,
                    valid_end: torch.Tensor, carry: MinimizerState,
                    k: int, m: int, b: int,
                    valid_start: torch.Tensor = None
                    ) -> Tuple[Emissions, MinimizerState]:
    """codes: (B, L_buf) 2-bit codes (any int dtype). Returns emissions
    for positions [margin, L_buf) and the next carry. valid_start ((B,),
    optional) switches on windowed mode: the warm-up replay region before
    it is masked and certified (see io.windows)."""
    margin = k - 1
    B, L_buf = codes.shape
    L_out = L_buf - margin
    codes = codes.to(torch.int64)
    device = codes.device
    windowed = valid_start is not None
    with_unique = windowed and k <= 32

    pa = minimizer.position_pipeline(codes, k, m)
    rescan_out = minimizer.windowed_get_minimizer(
        pa, pa.fwd_k, k, m, with_unique=with_unique)
    rescan, unique = rescan_out if with_unique else (rescan_out, None)

    # fresh lanes: get_minimizer over the (k-1)-mer ending at margin-1
    pa_init = minimizer.position_pipeline(codes[:, :margin], k - 1, m)
    init_full = minimizer.windowed_get_minimizer(
        pa_init, pa_init.fwd_k, k - 1, m)
    init = MinimizerState(*(x[:, -1] for x in init_full))
    state0 = MinimizerState(
        *(torch.where(fresh, i, c) for i, c in zip(init, carry)))

    km = k - m
    (boundary, use_rc, pos_o, mini_o, h_o), final_state = _state_machine(
        state0, pa, rescan, fresh, km, margin)
    mini_idx, mini_lo, mini_hi, hash_hi, hash_lo, kmer, key, bucket = _emit(
        use_rc, pos_o, mini_o, h_o, pa.fwd_k, pa.rc_k, k, m, b)

    pos_idx = torch.arange(margin, L_buf, device=device)[None, :]
    valid = pos_idx < valid_end[:, None]
    if windowed:
        vs = valid_start.to(torch.int64)
        valid = valid & (pos_idx >= vs[:, None])
        in_replay = pos_idx < vs[:, None]
        cert = vs == margin
        if unique is not None:
            cert = cert | torch.any(unique[:, margin:] & in_replay, dim=1)

        # full machine state at the replay boundary (valid_start-1);
        # lanes whose boundary lies outside the buffer read 0 / False
        ridx = vs - margin - 1
        inr = (ridx >= 0) & (ridx < L_out)
        gidx = ridx.clamp(0, L_out - 1)[:, None]

        def take(a2d):
            return torch.where(inr, torch.gather(a2d, 1, gidx)[:, 0], 0)

        replay = MinimizerState(
            mini_lo=take(mini_lo), mini_hi=take(mini_hi), pos=take(pos_o),
            rev=inr & torch.gather(use_rc, 1, gidx)[:, 0],
            heavy=take(hashing.unpack_hash(h_o)[0]), hash_hi=take(hash_hi),
            hash_lo=take(hash_lo))
    else:
        cert = torch.ones(B, dtype=torch.bool, device=device)
        replay = final_state

    em = Emissions(
        valid=valid, boundary=boundary, use_rc=use_rc, mini_idx=mini_idx,
        mini_lo=mini_lo, mini_hi=mini_hi, hash_hi=hash_hi, hash_lo=hash_lo,
        kmer=kmer, key=key, bucket=bucket, cert=cert, replay=replay)
    return em, final_state


def _emit(use_rc, pos_o, mini_o, h_o, fwd_k: u128.Limbs, rc_k: u128.Limbs,
          k: int, m: int, b: int):
    """The epilogue after the state machine, at every emitting position:
    from its (B, L_out) rows use_rc, pos, mini and h and the position
    pipeline's (B, L_buf) k-mer limbs (read at columns [margin, L_buf)),
    returns (mini_idx, mini_lo, mini_hi, hash_hi, hash_lo, kmer (4, B,
    L_out), key (4, B, L_out), bucket). On a CUDA tensor one kernel
    (kernels.emit), on the CPU the plain version."""
    if use_rc.device.type != "cuda":
        return _emit_torch(use_rc, pos_o, mini_o, h_o, fwd_k, rc_k, k, m, b)

    def dense(ts):
        return tuple(t.contiguous() for t in ts)

    return kernels.emit(*dense((use_rc, pos_o, mini_o, h_o)), dense(fwd_k),
                        dense(rc_k), k, m, b)


def _emit_torch(use_rc, pos_o, mini_o, h_o, fwd_k: u128.Limbs,
                rc_k: u128.Limbs, k: int, m: int, b: int):
    """The plain version of _emit: elementwise torch ops over (B, L_out)
    tensors."""
    margin = fwd_k[0].shape[1] - use_rc.shape[1]
    mini_idx = torch.where(use_rc, (k - m) - pos_o, pos_o)
    mini_lo, mini_hi = mini_o & M32, mini_o >> 32
    _, hash_hi, hash_lo = hashing.unpack_hash(h_o)
    fwd = tuple(l[:, margin:] for l in fwd_k)
    rc = tuple(l[:, margin:] for l in rc_k)
    kmer = u128.select(use_rc, rc, fwd)

    # the stored key replaces the minimizer slice of the emitted k-mer by
    # the hash of the ACTUAL slice (hash_kmer_minimizer_inplace,
    # Kmers.cpp:191-200), which can differ from the tracked minimizer
    slice_mm = u128.mask_bits(u128.shr_var(kmer, mini_idx * 2), 2 * m)
    slice_hi, slice_lo = hashing.mix_key(slice_mm[0], slice_mm[1], m)
    key = _hash_slice_replace(kmer, mini_idx, slice_hi, slice_lo, m)
    bucket = _bucket_id(slice_hi, slice_lo, m, b)
    return (mini_idx, mini_lo, mini_hi, hash_hi, hash_lo, u128.stack(kmer),
            u128.stack(key), bucket)


def _hash_slice_replace(kmer: u128.Limbs, mini_idx: torch.Tensor,
                        hash_hi: torch.Tensor, hash_lo: torch.Tensor,
                        m: int) -> u128.Limbs:
    """Replace the minimizer slice inside the k-mer by the low 2m bits of
    its hash (reference hash_kmer_minimizer_inplace, Kmers.cpp:191-200)."""
    shift = mini_idx * 2
    zeros = torch.zeros_like(hash_lo)
    ones = torch.full_like(hash_lo, M32)
    m_mask4 = u128.mask_bits((ones, ones, ones, ones), 2 * m)
    hole = u128.bnot(u128.shl_var(m_mask4, shift))
    slice4 = u128.mask_bits((hash_lo, hash_hi, zeros, zeros), 2 * m)
    return u128.bor(u128.band(kmer, hole), u128.shl_var(slice4, shift))


def _bucket_id(hash_hi: torch.Tensor, hash_lo: torch.Tensor, m: int, b: int
               ) -> torch.Tensor:
    """Reduced minimizer: drop (m_reduc+1)/2 suffix bases from the hashed
    minimizer, keep 2b bits (reference Brisk.hpp:135-137). b <= 15."""
    suffix_reduc = (m - b + 1) // 2
    small = u128.shr(u128.mask_bits((hash_lo, hash_hi), 2 * m),
                     2 * suffix_reduc)
    return small[0] & ((1 << (2 * b)) - 1)
