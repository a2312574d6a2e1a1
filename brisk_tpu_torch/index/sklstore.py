"""Compacted super-k-mer storage — the SKL arena (port of
brisk_tpu.index.sklstore, the subset the single-device Brisk and the
sharded facade run).

Each super-k-mer is stored ONCE as fixed-width columns:

    bucket: u32          reduced-minimizer bucket id (0xFFFFFFFF = dead)
    meta:   u32          size (kmers, bits 0-7) | mini_idx (bits 8-15)
    nucs:   (NW, ) u32   compacted super-k-mer value, 2 bits/base, the
                         LAST base in the low bits (str2num convention)

in hashed-minimizer space exactly like the reference's storage: k-mer j
of a row is recovered by windowing 2*(k-b) bits at offset 2*(size-1-j)
and re-inserting the 2b bucket bits at hole offset mini_idx-(size-1-j).
Columns are int32 tensors holding the u32 bit pattern.

`finalize_device` consolidates duplicate k-mer counts of the fresh rows
by EXPANDING them to per-k-mer packed keys (the CUDA kernel of
`brisk_tpu_torch.kernels` on the card, `_expand_span_jmajor_torch` on
the CPU), sorting in chunks and writing run totals back in a padded
layout: row r's counts live at data[offs[r] + j] with offs[r] = r*s_max.
Duplicates split across chunks keep partial counts; every reader sums
per key, so totals stay exact. `consolidate_all` re-consolidates the
whole arena with the counts carried (merging duplicates across
segments onto one slot, dropping dead rows); `from_entries` rebuilds an
arena of size-1 rows from a per-k-mer state (after reallocate). Reads:
`probe` (one bucket's rows expanded row-major on the arena's device),
`probe_np` (the same from a host copy), and the sort-merge joins
`query_join_total` (against a query arena) and `query_join_keys_total`
(against query packed keys).
"""

from typing import NamedTuple, Tuple

import numpy as np
import torch

from brisk_tpu_torch import kernels, spans
from brisk_tpu_torch._u32 import (INVALID, M32, from_np, lexsort, to_i32,
                                  to_np, to_u32)
from brisk_tpu_torch.index import store
from brisk_tpu_torch.index.store import _first_of_runs, _reverse_cummin
from brisk_tpu_torch.ops import u128

# Max k-mers per stored row; longer runs are split into several rows
# (k-mer content and counts are unaffected). Power of two.
SKL_SIZE_CAP = 8
_BIG = 0x7FFFFFFF


def skl_dims(k: int, m: int, b: int) -> Tuple[int, int, int, int]:
    """(compacted_size, max kmers/skl, max nucleotides, nuc words)."""
    cs = k - b
    s_max = min(2 * (k - m) + 1, SKL_SIZE_CAP)
    nt_max = cs + s_max - 1
    return cs, s_max, nt_max, -(-(2 * nt_max) // 32)


class SklState(NamedTuple):
    bucket: torch.Tensor   # (rcap,) int32
    meta: torch.Tensor     # (rcap,) int32: size | mini_idx << 8
    nucs: torch.Tensor     # (NW, rcap) int32
    data: torch.Tensor     # (kcap,) int32 per-slot counts of finalized rows
    offs: torch.Tensor     # (rcap,) int32 data offset per finalized row
    n_rows: torch.Tensor   # () int64: raw rows used
    n_fin_rows: torch.Tensor   # () int64 rows covered by data/offs
    n_fin_kmers: torch.Tensor  # () int64 slots covered by data


def _scalar(v, device) -> torch.Tensor:
    return torch.tensor(int(v), dtype=torch.int64, device=device)


def empty(row_cap: int, kmer_cap: int, nw: int, device="cpu") -> SklState:
    with spans.span("alloc"):
        z = _scalar(0, device)
        return SklState(
            bucket=torch.full((row_cap,), -1, dtype=torch.int32,
                              device=device),
            meta=torch.zeros(row_cap, dtype=torch.int32, device=device),
            nucs=torch.zeros((nw, row_cap), dtype=torch.int32,
                             device=device),
            data=torch.zeros(kmer_cap, dtype=torch.int32, device=device),
            offs=torch.zeros(row_cap, dtype=torch.int32, device=device),
            n_rows=z, n_fin_rows=z.clone(), n_fin_kmers=z.clone())


def grow(state: SklState, row_cap: int, kmer_cap: int) -> SklState:
    rpad = row_cap - state.bucket.shape[0]
    kpad = kmer_cap - state.data.shape[0]
    assert rpad >= 0 and kpad >= 0

    def pad(x, n, value=0):
        if n == 0:
            return x
        tail = torch.full(x.shape[:-1] + (n,), value, dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, tail], dim=-1)

    with spans.span("alloc"):
        return state._replace(
            bucket=pad(state.bucket, rpad, -1), meta=pad(state.meta, rpad),
            nucs=pad(state.nucs, rpad), data=pad(state.data, kpad),
            offs=pad(state.offs, rpad))


def ensure_room(state: SklState, n_rows_incoming: int) -> SklState:
    rcap = state.bucket.shape[0]
    target = rcap
    while int(state.n_rows) + n_rows_incoming > target:
        target *= 2
    if target != rcap:
        state = grow(state, target, state.data.shape[0])
    return state


def append(state: SklState, bucket: torch.Tensor, meta: torch.Tensor,
           nucs: torch.Tensor) -> SklState:
    """Append (N,) int32 rows at the raw log tail, in place. Caller
    enforces capacity (ensure_room)."""
    n0 = int(state.n_rows)
    n = bucket.shape[0]
    state.bucket[n0:n0 + n] = bucket
    state.meta[n0:n0 + n] = meta
    state.nucs[:, n0:n0 + n] = nucs
    return state._replace(n_rows=state.n_rows + n)


def append_n(state: SklState, bucket: torch.Tensor, meta: torch.Tensor,
             nucs: torch.Tensor, n_live: torch.Tensor,
             iota: torch.Tensor = None) -> SklState:
    """DENSE append at the DEVICE row offset n_rows, in place: write the
    full fixed-width int32 block (live rows first) but advance n_rows by
    only the live count, so the block's dead tail is overwritten by the
    next append. No host read of n_rows; the caller guarantees
    n_rows + block_width <= rcap (host upper bound). iota: arange(block
    width) on the device, when the caller appends several blocks."""
    if iota is None:
        iota = torch.arange(bucket.shape[0], device=bucket.device)
    idx = state.n_rows + iota
    state.bucket.index_copy_(0, idx, bucket)
    state.meta.index_copy_(0, idx, meta)
    state.nucs.index_copy_(1, idx, nucs)
    return state._replace(n_rows=state.n_rows + n_live)


# -- emission batch -> skl rows -------------------------------------------

def _ones_mask_var(nbits: torch.Tensor, n_limbs: int) -> u128.Limbs:
    """(1 << nbits) - 1 as limbs (variable nbits)."""
    ones = tuple(torch.full_like(nbits, M32) for _ in range(n_limbs))
    return u128.bnot(u128.shl_var(ones, nbits))


def rows_from_emissions(key: torch.Tensor, bucket: torch.Tensor,
                        mini_idx: torch.Tensor, use_rc: torch.Tensor,
                        valid: torch.Tensor, first_valid: torch.Tensor,
                        boundary: torch.Tensor, k: int, m: int, b: int,
                        row_cap: int):
    """Assemble compacted super-k-mer rows from one emission batch.

    key (4, B, L) hashed k-mer limbs; bucket, mini_idx (B, L);
    use_rc/valid/first_valid/boundary (B, L) bool. Lanes with more than
    row_cap segments are reported in `overflow` and contribute no rows.
    Returns (row_bucket (B, row_cap) u32 with INVALID padding, row_meta,
    row_nucs (NW, B, row_cap), overflow (B,) bool), all int64 u32. On a
    CUDA tensor one kernel (kernels.skl_rows, csrc/skl_rows.cu: one block
    per lane), on the CPU the plain version."""
    if bucket.device.type != "cuda":
        return rows_from_emissions_torch(key, bucket, mini_idx, use_rc,
                                         valid, first_valid, boundary, k, m,
                                         b, row_cap)
    _, s_max, _, nw = skl_dims(k, m, b)
    return kernels.skl_rows(*(t.contiguous() for t in (
        key, bucket, mini_idx, use_rc, valid, first_valid, boundary)),
        k, m, b, row_cap, s_max, nw, 2 * (k - m) + 1 > s_max)


def rows_from_emissions_torch(key: torch.Tensor, bucket: torch.Tensor,
                              mini_idx: torch.Tensor, use_rc: torch.Tensor,
                              valid: torch.Tensor, first_valid: torch.Tensor,
                              boundary: torch.Tensor, k: int, m: int,
                              b: int, row_cap: int):
    """The plain version of rows_from_emissions, on whole (B, L) tensors.

    The variable-length nucleotide assembly ORs per-position bit
    contributions over each segment. The contributions of one segment
    occupy disjoint bits, so the segmented suffix-OR is a segmented
    suffix SUM per limb: a reverse cumsum minus its value past the
    segment's last position."""
    suffix_reduc = (m - b + 1) // 2
    cs, s_max, nt_max, nw = skl_dims(k, m, b)
    B, L = bucket.shape
    dev = bucket.device
    key4 = u128.unstack(key)

    seg_start = valid & (boundary | first_valid)
    pos = torch.arange(L, device=dev).expand(B, L)

    def nxt(x):
        return torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1)

    if 2 * (k - m) + 1 > s_max:
        # split runs longer than s_max into several rows
        first0 = torch.cummax(torch.where(seg_start, pos, 0), 1).values
        j0 = torch.where(valid, pos - first0, 0)
        seg_start = seg_start | (valid & ((j0 & (s_max - 1)) == 0))
    is_last = valid & (~nxt(valid) | nxt(seg_start))
    last_pos = _reverse_cummin(torch.where(is_last, pos, _BIG), 1)
    first_pos = torch.cummax(torch.where(seg_start, pos, 0), 1).values
    d = torch.where(valid, last_pos - pos, 0)
    j = torch.where(valid, pos - first_pos, 0)

    h = mini_idx + suffix_reduc  # hole offset (reference kmer_mini_idx)
    hi_part = u128.shl_var(u128.shr_var(key4, 2 * (h + b)), 2 * h)
    lo_part = u128.band(key4, _ones_mask_var(2 * h, 4))
    cmp4 = u128.mask_bits(u128.bor(hi_part, lo_part), 2 * cs)

    zero = torch.zeros_like(bucket)
    cN = tuple(cmp4[i] if i < 4 else zero for i in range(nw))
    last_base = tuple((cN[0] & 3) if i == 0 else zero for i in range(nw))
    first_base_val = (cmp4[(2 * (cs - 1)) // 32]
                      >> ((2 * (cs - 1)) % 32)) & 3
    first_base = tuple(first_base_val if i == 0 else zero
                       for i in range(nw))
    fwd_contrib = u128.shl_var(u128.select(j == 0, cN, last_base), 2 * d)
    rev_contrib = u128.select(
        j == 0, cN, u128.shl_var(first_base, 2 * (cs - 1 + j)))
    contrib = u128.select(use_rc, rev_contrib, fwd_contrib)

    # segmented suffix sum; positions with no last at/after them read
    # the zero past the lane's end
    end = torch.clamp(last_pos + 1, max=L)
    agg = []
    for c in contrib:
        c = torch.where(valid, c, 0)
        rc = torch.flip(torch.cumsum(torch.flip(c, [1]), 1), [1])
        rc = torch.cat([rc, torch.zeros_like(rc[:, :1])], dim=1)
        agg.append(rc[:, :L] - torch.gather(rc, 1, end))

    size = torch.where(seg_start, d + 1, 0)
    mini_last = torch.where(use_rc, h, h + d)  # max hole offset in segment
    meta = size | (mini_last << 8)

    # per-lane compression: segment starts to the front, in order
    n_seg = seg_start.sum(dim=1)
    overflow = n_seg > row_cap
    keep = seg_start & ~overflow[:, None]
    order = torch.sort(torch.where(keep, pos, _BIG), dim=1,
                       stable=True).indices[:, :row_cap]
    row_bucket = torch.gather(torch.where(keep, bucket, INVALID), 1, order)
    row_meta = torch.gather(meta, 1, order)
    row_nucs = torch.stack([torch.gather(a, 1, order) for a in agg])
    return row_bucket, row_meta, row_nucs, overflow


# -- finalize: consolidate duplicate k-mer counts -------------------------

def _shape_family(n: int, floor: int = 1 << 12) -> int:
    """Smallest of {2^p, 3*2^(p-1)} >= n (bounded shape set, <= 33%
    waste)."""
    n = max(n, floor)
    p2 = 1 << (n - 1).bit_length()
    if (3 * p2) // 4 >= n:
        return (3 * p2) // 4
    return p2


def _chunk_width(S2: int, cap: int = 1 << 18) -> int:
    """Largest power-of-two chunk width <= cap that divides S2."""
    return min(cap, S2 & -S2, S2)


def _consolidate_chunked(keys: torch.Tensor, cnt, S2: int,
                         cw_cap: int = 1 << 18) -> torch.Tensor:
    """Chunked consolidation: per-chunk stable key sort, run totals at
    run firsts, scattered back to the ORIGINAL slot order. keys (W, S2)
    int32; cnt (S2,) int64 u32 per-slot counts (0 on dead slots) or None
    (fresh span: every live slot counts 1). Returns (S2,) int64 u32
    totals (dead slots 0). The running sum wraps mod 2^32 like the
    reference's u32 cumsum."""
    W = keys.shape[0]
    CW = _chunk_width(S2, cw_cap)
    C = S2 // CW
    k2 = [to_u32(keys[i]).reshape(C, CW) for i in range(W)]
    perm = lexsort(k2, dim=1)
    out = torch.stack([torch.gather(x, 1, perm) for x in k2])
    if cnt is None:
        s_cnt = torch.where(torch.all(out == INVALID, dim=0), 0, 1)
    else:
        s_cnt = torch.gather(cnt.reshape(C, CW), 1, perm)
    first = _first_of_runs(out)
    csum = torch.cumsum(s_cnt, 1) & M32
    is_last = torch.ones_like(first)
    is_last[:, :-1] = first[:, 1:]
    last_csum = _reverse_cummin(torch.where(is_last, csum, M32), 1)
    totals = torch.where(first, (last_csum - csum + s_cnt) & M32, 0)
    return torch.empty_like(totals).scatter_(1, perm, totals).reshape(S2)


def _nucs_tuple(bucket: torch.Tensor, nucs: torch.Tensor) -> u128.Limbs:
    zero = torch.zeros_like(bucket)
    nw = nucs.shape[0]
    return tuple(nucs[i] if i < nw else zero for i in range(max(nw, 4)))


def _expand_j_words(bucket, meta, nucs_t, J: int, k: int, m: int, b: int):
    """Big-endian packed-key word list (W int64 u32 tensors) for k-mer
    index J of each row; dead slots have every word INVALID. Pure
    elementwise u32 math (variable shifts and masks)."""
    suffix_reduc = (m - b + 1) // 2
    cs = k - b
    size = meta & 0xFF
    mini = (meta >> 8) & 0xFF
    live = bucket != INVALID
    zero = torch.zeros_like(bucket)
    ok = live & (J < size)
    sh = 2 * torch.where(ok, size - 1 - J, 0)
    shifted = u128.shr_var(nucs_t, sh)
    win = u128.mask_bits(tuple(shifted[:4]), 2 * cs)
    # u32 wraparound as in the reference (garbage meta gives huge shifts,
    # and a shift of 128 or more gives 0)
    h = torch.where(ok, (mini - (size - 1 - J)) & M32, 0)
    sh_h = (2 * h) & M32
    low = u128.band(win, _ones_mask_var(sh_h, 4))
    high = u128.shl_var(u128.shr_var(win, sh_h), (sh_h + 2 * b) & M32)
    mid = u128.shl_var((bucket, zero, zero, zero), sh_h)
    kmer = u128.mask_bits(u128.bor(u128.bor(low, high), mid), 2 * k)
    full_mini_idx = torch.where(ok, (h - suffix_reduc) & M32, 0)
    words = store.make_key_words(torch.where(ok, bucket, INVALID),
                                 kmer, full_mini_idx, k, b)
    return [torch.where(ok, w, INVALID) for w in words]


def _expand_span_jmajor_torch(sb: torch.Tensor, sm: torch.Tensor,
                              sn: torch.Tensor, k: int, m: int, b: int,
                              s_max: int) -> torch.Tensor:
    """Plain version of the span expansion kernel, J-MAJOR output:
    int32 rows (sb, sm (R,), sn (nw, R)) -> keys (W, s_max*R) int32 with
    slot j*R + r (port of _expand_span_jmajor_lax)."""
    bucket, meta = to_u32(sb), to_u32(sm)
    nucs_t = _nucs_tuple(bucket, to_u32(sn))
    planes = []
    for j in range(s_max):
        words = _expand_j_words(bucket, meta, nucs_t, j, k, m, b)
        planes.append(to_i32(torch.stack(words)))
    return torch.stack(planes, dim=1).reshape(len(planes[0]), -1)


def _expand_span_rowmajor_torch(sb: torch.Tensor, sm: torch.Tensor,
                                sn: torch.Tensor, k: int, m: int, b: int,
                                s_max: int) -> torch.Tensor:
    """Plain version of the span expansion, ROW-MAJOR output (slot
    r*s_max + j; the function of the reference's _expand_span): the
    J-major plain version and one transpose."""
    return _jmajor_to_rowmajor(
        _expand_span_jmajor_torch(sb, sm, sn, k, m, b, s_max), s_max)


def _jmajor_to_rowmajor(keys: torch.Tensor, s_max: int) -> torch.Tensor:
    """J-major keys (slot j*R + r) -> row-major (slot r*s_max + j), one
    transpose copy."""
    W = keys.shape[0]
    return keys.reshape(W, s_max, -1).transpose(1, 2).reshape(W, -1)


def _expand_span_jmajor(sb, sm, sn, k: int, m: int, b: int, s_max: int):
    """J-major span expansion: the CUDA kernel for tensors on the card,
    the plain version for tensors on the CPU."""
    if sb.device.type == "cpu":
        return _expand_span_jmajor_torch(sb, sm, sn, k, m, b, s_max)
    return kernels.expand_span_jmajor(sb, sm, sn, k, m, b, s_max)


def _expand_span(sb, sm, sn, k: int, m: int, b: int, s_max: int):
    """ROW-MAJOR per-slot keys (W, R*s_max) int32 (slot r*s_max + j) and
    live mask: the kernel's row-major layout for tensors on the card (no
    J-major intermediate, no transpose), the plain version for tensors
    on the CPU. A live key's top word is never INVALID (reserved top
    bit)."""
    if sb.device.type == "cpu":
        keys = _expand_span_rowmajor_torch(sb, sm, sn, k, m, b, s_max)
    else:
        keys = kernels.expand_span(sb, sm, sn, k, m, b, s_max,
                                   layout="rowmajor")
    return keys, keys[0] != -1


def _finalize_span_fused(state: SklState, f: int, R_pad: int,
                         k: int, m: int, b: int, s_max: int,
                         carry_counts: bool = False,
                         drop_dead: bool = False):
    """Finalize rows [f, n_rows) (span width R_pad >= n_rows - f) in
    place: bucket-group the span's rows (stable), expand to per-slot
    packed keys, consolidate duplicate counts in chunks, write rows +
    padded counts + offs back at [f, f+R_pad).

    carry_counts: span rows may already be finalized; their padded count
    columns ride the row sort and feed the consolidation (the
    consolidate_all path). False: every span row is fresh (count 1 per
    live slot). The carry path runs ROW-MAJOR at the full 2^18 chunk
    width, so all slots of neighbouring rows meet in one chunk and
    duplicates merge onto one slot; that merge decides which rows
    drop_dead removes. drop_dead (with carry_counts): rows whose every
    slot total is zero move behind the live rows (stable live-first
    partition) and die.

    Returns (n_live_rows, total_k_span) as device scalars."""
    S2 = R_pad * s_max
    dev = state.bucket.device
    iota = torch.arange(R_pad, device=dev)
    in_span = iota < (state.n_rows - f)
    b_t = torch.where(in_span, to_u32(state.bucket[f:f + R_pad]), INVALID)
    order = torch.sort(b_t, stable=True).indices  # (bucket, iota) order
    sb = b_t[order]
    sm = to_u32(state.meta[f:f + R_pad])[order]
    sn = state.nucs[:, f:f + R_pad][:, order]
    n_live = (sb != INVALID).sum()
    sb32, sm32 = to_i32(sb), to_i32(sm)

    if carry_counts:
        keys, ok = _expand_span(sb32, sm32, sn, k, m, b, s_max)
        d_t = to_u32(state.data[f * s_max:f * s_max + S2])
        scnt = torch.where(ok, d_t.reshape(R_pad, s_max)[order].reshape(S2),
                           0)
        totals = _consolidate_chunked(keys, scnt, S2)
    else:
        keys_jm = _expand_span_jmajor(sb32, sm32, sn, k, m, b, s_max)
        # fresh spans: small chunks; split counts are exact under sum
        # semantics, so within-span merge quality does not matter here
        totals_jm = _consolidate_chunked(keys_jm, None, S2, cw_cap=1 << 12)
        # back to row-major slots r*s_max + j (the reference's
        # _interleave_cols)
        totals = totals_jm.reshape(s_max, R_pad).t().reshape(S2)

    if drop_dead:
        tcols = totals.reshape(R_pad, s_max)
        row_alive = (sb != INVALID) & (tcols > 0).any(dim=1)
        part = torch.sort(torch.where(row_alive, iota, INVALID),
                          stable=True).indices
        alive_s = row_alive[part]
        sb = torch.where(alive_s, sb[part], INVALID)
        sm = sm[part]
        sn = sn[:, part]
        totals = torch.where(alive_s[:, None], tcols[part], 0).reshape(S2)
        n_live = alive_s.sum()
        sb32, sm32 = to_i32(sb), to_i32(sm)

    sizes = torch.where(sb != INVALID, sm & 0xFF, 0)
    total_k = sizes.sum()
    state.bucket[f:f + R_pad] = sb32
    state.meta[f:f + R_pad] = sm32
    state.nucs[:, f:f + R_pad] = sn
    state.offs[f:f + R_pad] = to_i32((f + iota) * s_max)
    state.data[f * s_max:f * s_max + S2] = to_i32(totals)
    return n_live, total_k


def _ensure_span_caps(state: SklState, f: int, R_pad: int, s_max: int
                      ) -> SklState:
    """Grow the arena so rows [f, f+R_pad) and data slots
    [f*s_max, (f+R_pad)*s_max) exist, in family-shaped capacities."""
    need_r = f + R_pad
    need_d = need_r * s_max
    rcap = state.bucket.shape[0]
    dcap = state.data.shape[0]
    new_r = rcap
    while new_r < need_r:
        new_r *= 2
    new_d = dcap if dcap >= need_d else _shape_family(need_d)
    if new_r != rcap or new_d != dcap:
        state = grow(state, new_r, new_d)
    return state


def finalize_span_dispatch(state: SklState, F: int, span_ub: int,
                           k: int, m: int, b: int):
    """Finalize rows [F, n_rows) with a span width from the host upper
    bound span_ub >= n_rows. Returns (state, n_live_dev, total_k_dev) —
    n_rows/n_fin are NOT yet updated — or None when span_ub <= F."""
    cs, s_max, nt_max, nw = skl_dims(k, m, b)
    if span_ub <= F:
        return None
    R_pad = _shape_family(span_ub - F, floor=1 << 10)
    assert (F + R_pad) * s_max < (1 << 32) - 1, "offs overflow"
    state = _ensure_span_caps(state, F, R_pad, s_max)
    n_live, total_k = _finalize_span_fused(state, F, R_pad, k, m, b, s_max)
    return state, n_live, total_k


def finalize_device(state: SklState, k: int, m: int, b: int) -> SklState:
    """Span finalize of the fresh tail [F, N) into a new bucket-grouped
    segment; the finalized prefix is untouched. Counts of k-mers
    duplicated ACROSS segments stay split (sum semantics)."""
    cs, s_max, nt_max, nw = skl_dims(k, m, b)
    dev = state.bucket.device
    with spans.span("finalize"):
        F, N = int(state.n_fin_rows), int(state.n_rows)
        if N == 0:
            return empty(state.bucket.shape[0], state.data.shape[0], nw, dev)
        if N == F:
            return state
        state, n_live, total_k = finalize_span_dispatch(
            state, F, N, k, m, b)
        nl, tk = int(n_live), int(total_k)
        return state._replace(n_rows=_scalar(F + nl, dev),
                              n_fin_rows=_scalar(F + nl, dev),
                              n_fin_kmers=state.n_fin_kmers + tk)


def consolidate_all(state: SklState, k: int, m: int, b: int) -> SklState:
    """Whole-arena maintenance: re-consolidates EVERY row into one
    bucket-grouped segment, merges cross-segment duplicate counts onto
    one slot and drops dead rows. O(N) memory."""
    cs, s_max, nt_max, nw = skl_dims(k, m, b)
    dev = state.bucket.device
    F, N = int(state.n_fin_rows), int(state.n_rows)
    if N == 0:
        return empty(state.bucket.shape[0], state.data.shape[0], nw, dev)
    if F != N:
        state = finalize_device(state, k, m, b)
        N = int(state.n_rows)
    R_pad = _shape_family(N, floor=1 << 10)
    state = _ensure_span_caps(state, 0, R_pad, s_max)
    n_live, total_k = _finalize_span_fused(state, 0, R_pad, k, m, b, s_max,
                                           carry_counts=True, drop_dead=True)
    nl, tk = int(n_live), int(total_k)
    return state._replace(n_rows=_scalar(nl, dev), n_fin_rows=_scalar(nl, dev),
                          n_fin_kmers=_scalar(tk, dev))


def expand_device(state: SklState, k: int, m: int, b: int):
    """Whole finalized arena -> (keys (W, S2) int32 row-major, INVALID
    padded; counts (S2,) int64). Sort-free under the padded layout."""
    cs, s_max, _, nw = skl_dims(k, m, b)
    F = int(state.n_fin_rows)
    R_pad = _shape_family(max(F, 1), floor=1 << 8)
    state = _ensure_span_caps(state, 0, R_pad, s_max)
    iota = torch.arange(R_pad, device=state.bucket.device)
    bucket_c = torch.where(iota < F, state.bucket[:R_pad], -1)
    keys, ok = _expand_span(bucket_c, state.meta[:R_pad],
                            state.nucs[:, :R_pad].contiguous(), k, m, b,
                            s_max)
    cnt = torch.where(ok, to_u32(state.data[:R_pad * s_max]), 0)
    return keys, cnt


def distinct_count(state: SklState, k: int, m: int, b: int) -> int:
    """EXACT number of distinct stored keys (a global key sort, off the
    hot path)."""
    if int(state.n_fin_rows) == 0:
        return 0
    keys, _ = expand_device(state, k, m, b)
    words = [to_u32(keys[i]) for i in range(keys.shape[0])]
    perm = lexsort(words)
    out = torch.stack([w[perm] for w in words])
    dead = torch.all(out == INVALID, dim=0)
    return int((_first_of_runs(out) & ~dead).sum())


def expanded_state(state: SklState, k: int, m: int, b: int
                   ) -> store.IndexState:
    """TRANSIENT sorted per-k-mer view of the finalized arena (working
    memory for read-out, not resident state)."""
    keys, counts = expand_device(state, k, m, b)
    st = store.IndexState(keys=keys, data=counts, n_sorted=0,
                          n_used=keys.shape[1])
    return store.compact_fast(st)


def fetch_rows(arr: torch.Tensor, start: int, n: int) -> np.ndarray:
    """arr[..., start:start+n] (last axis) as a host uint32 array."""
    if n <= 0:
        return np.zeros(arr.shape[:-1] + (0,), dtype=np.uint32)
    return to_np(arr[..., start:start + n])


# -- serving lookups from the finalized arena on its device ---------------

def runs_from_bucket(bucket_col: np.ndarray, n_fin_rows: int) -> list:
    """The bucket-sorted runs [(lo, hi)] of a finalized arena's first
    `n_fin_rows` rows, rebuilt from its host bucket column (uint32): a
    run starts at row 0 and wherever the bucket id drops. Every finalize
    writes one sorted run of live rows, so each maximal non-decreasing
    stretch is sorted and a binary search over it is exact; two runs
    that meet without a drop form one stretch, which is still sorted.
    This is how a checkpoint without its run list (the sharded `.npz`
    files of either package) gets its runs back on load."""
    if n_fin_rows <= 0:
        return []
    col = np.asarray(bucket_col[:n_fin_rows], dtype=np.uint32)
    starts = (np.flatnonzero(col[1:] < col[:-1]) + 1).tolist()
    bounds = [0] + starts + [n_fin_rows]
    return list(zip(bounds[:-1], bounds[1:]))


def bucket_slice(state: SklState, bucket_id: int, segments=None,
                 bucket_col: np.ndarray = None):
    """Row ranges [(lo, hi)] of one bucket across the arena's
    bucket-grouped segments (host binary search on the bucket column).
    `segments` lists the (lo, hi) row ranges that are each bucket-sorted
    (one per finalize); None means one segment over every finalized row.
    `bucket_col` is an optional host copy of the bucket column; without
    it every call copies the column from the device."""
    n = int(state.n_fin_rows)
    if segments is None:
        segments = [(0, n)]
    if bucket_col is None:
        bucket_col = fetch_rows(state.bucket, 0, n)
    needle = np.uint32(bucket_id)  # see probe_np
    out = []
    for lo, hi in segments:
        seg = bucket_col[lo:hi]
        l = lo + int(np.searchsorted(seg, needle, side="left"))
        h = lo + int(np.searchsorted(seg, needle, side="right"))
        if h > l:
            out.append((l, h))
    return out


def probe(state: SklState, packed_cols: np.ndarray, bucket_id: int,
          k: int, m: int, b: int, segments=None,
          bucket_col: np.ndarray = None):
    """Count lookup for a few packed keys known to live in one bucket
    (reference find_kmer, buckets.hpp:499-519): expand just that bucket's
    rows (every segment) with the row-major span expansion on the
    arena's device (the CUDA kernel on the card) and sum the counts of
    the matching slots. The matching slots' counts partition a key's
    true count, so summing is exact. packed_cols (W, Q) uint32. Returns
    (found (Q,) bool, counts (Q,) uint32)."""
    cs, s_max, _, nw = skl_dims(k, m, b)
    ranges = bucket_slice(state, bucket_id, segments, bucket_col)
    Q = packed_cols.shape[1]
    found = np.zeros(Q, bool)
    counts = np.zeros(Q, np.uint64)
    if not ranges:
        return found, counts.astype(np.uint32)
    dev = state.bucket.device
    q = from_np(packed_cols, dev)
    for lo, hi in ranges:
        R = hi - lo
        Rp = 1 << max(4, (R - 1).bit_length())  # pad to a few shapes
        sb = torch.full((Rp,), -1, dtype=torch.int32, device=dev)
        sm = torch.zeros(Rp, dtype=torch.int32, device=dev)
        sn = torch.zeros((nw, Rp), dtype=torch.int32, device=dev)
        sb[:R] = state.bucket[lo:hi]
        sm[:R] = state.meta[lo:hi]
        sn[:, :R] = state.nucs[:, lo:hi]
        # row-major slot r*s_max + j; dead slots INVALID, so ok is the
        # reference's per-slot validity
        keys, ok = _expand_span(sb, sm, sn, k, m, b, s_max)
        idx = (to_u32(state.offs[lo:hi])[:, None]
               + torch.arange(s_max, device=dev)).clamp_(
                   max=state.data.shape[0] - 1)
        cnt = torch.zeros((Rp, s_max), dtype=torch.int64, device=dev)
        cnt[:R] = to_u32(state.data[idx])
        cnt = torch.where(ok, cnt.reshape(-1), 0)
        eq = ok[None, :].expand(Q, -1).clone()
        for i in range(keys.shape[0]):
            eq &= keys[i][None, :] == q[i][:, None]
        hit = torch.stack([eq.any(1).to(torch.int64),
                           (eq * cnt[None, :]).sum(1)]).cpu().numpy()
        found |= hit[0].astype(bool)
        counts += hit[1].astype(np.uint64)
    return found, counts.astype(np.uint32)


# -- serving lookups from a host copy of the finalized arena --------------

def host_cache(state: SklState) -> dict:
    """One-time host copy of the finalized arena columns for probe_np."""
    n = int(state.n_fin_rows)
    offs = fetch_rows(state.offs, 0, n)
    need = (int(offs[-1]) + 64) if n else 64
    return dict(
        bucket=fetch_rows(state.bucket, 0, n),
        meta=fetch_rows(state.meta, 0, n),
        nucs=fetch_rows(state.nucs, 0, n),
        offs=offs,
        data=fetch_rows(state.data, 0, min(need, state.data.shape[0])),
        n_fin_rows=n)


def _expand_rows_np(bucket, meta, nucs, k: int, m: int, b: int):
    """Numpy expansion of a small row slice to per-slot packed keys —
    the host-side mirror of _expand_j_words over all J (u64-pair u128
    math). Returns (keys (W, R*s_max) big-endian words, ok (R*s_max,)
    row-major J-minor slot order: slot r*s_max+j)."""
    U64 = np.uint64
    m_reduc = m - b
    suffix_reduc = (m_reduc + 1) // 2
    cs, s_max, _, nw = skl_dims(k, m, b)
    R = bucket.shape[0]
    size = (meta & 0xFF).astype(np.int64)
    mini = ((meta >> 8) & 0xFF).astype(np.int64)
    live = bucket != 0xFFFFFFFF
    nu = nucs.astype(U64)
    lo = nu[0] | (nu[1] << U64(32)) if nw >= 2 else nu[0]
    hi = np.zeros(R, dtype=U64)
    if nw >= 3:
        hi = nu[2]
    if nw >= 4:
        hi |= nu[3] << U64(32)

    def shr128(h, l, s):
        s = s.astype(U64)
        with np.errstate(over="ignore"):
            big = s >= U64(64)
            s1 = np.where(big, s - U64(64), s)
            nl = np.where(big, h >> s1,
                          np.where(s1 == 0, l,
                                   (l >> s1) | (h << (U64(64) - s1))))
            nh = np.where(big, U64(0), np.where(s1 == 0, h, h >> s1))
            return nh, nl

    def shl128(h, l, s):
        s = s.astype(U64)
        with np.errstate(over="ignore"):
            big = s >= U64(64)
            s1 = np.where(big, s - U64(64), s)
            nh = np.where(big, l << s1,
                          np.where(s1 == 0, h,
                                   (h << s1) | (l >> (U64(64) - s1))))
            nl = np.where(big, U64(0), np.where(s1 == 0, l, l << s1))
            return nh, nl

    def mask128(h, l, bits):
        if bits >= 128:
            return h, l
        if bits >= 64:
            return h & U64((1 << (bits - 64)) - 1), l
        return np.zeros_like(h), l & U64((1 << bits) - 1)

    W = store.key_words(k, b)
    keys = np.full((W, R * s_max), 0xFFFFFFFF, dtype=np.uint32)
    ok_all = np.zeros(R * s_max, dtype=bool)
    ones = U64(0xFFFFFFFFFFFFFFFF)
    for jj in range(s_max):
        ok = live & (jj < size)
        sh = 2 * np.where(ok, size - 1 - jj, 0)
        wh, wl = shr128(hi, lo, sh)
        wh, wl = mask128(wh, wl, 2 * cs)
        h_off = np.where(ok, mini - (size - 1 - jj), 0)
        sh_h = 2 * h_off
        mh, ml = shl128(np.full(R, ones), np.full(R, ones),
                        np.asarray(sh_h))
        lh, ll = wh & ~mh, wl & ~ml
        th, tl = shr128(wh, wl, np.asarray(sh_h))
        hh, hl = shl128(th, tl, np.asarray(sh_h + 2 * b))
        bh, bl = shl128(np.zeros(R, U64), bucket.astype(U64),
                        np.asarray(sh_h))
        kh = lh | hh | bh
        kl = ll | hl | bl
        kh, kl = mask128(kh, kl, 2 * k)
        full_mini = np.where(ok, h_off - suffix_reduc, 0).astype(U64)
        le = [np.zeros(R, dtype=np.uint32) for _ in range(W)]

        def deposit(val, bitpos, width):
            with np.errstate(over="ignore"):
                for w in range(W):
                    base = 32 * w
                    if base + 32 <= bitpos or base >= bitpos + width:
                        continue
                    if base >= bitpos:
                        word = val >> U64(base - bitpos)
                    else:
                        word = val << U64(bitpos - base)
                    le[w] |= (word & U64(0xFFFFFFFF)).astype(np.uint32)

        deposit(full_mini, 0, 8)
        deposit(kl, 8, min(64, 2 * k))
        if 2 * k > 64:
            deposit(kh, 72, 2 * k - 64)
        deposit(bucket.astype(U64), 8 + 2 * k, 2 * b)
        col = np.stack(le[::-1])
        keys[:, jj::s_max] = np.where(ok[None, :], col, 0xFFFFFFFF)
        ok_all[jj::s_max] = ok
    return keys, ok_all


def probe_np(cache: dict, packed_cols: np.ndarray, bucket_id: int,
             k: int, m: int, b: int, segments=None):
    """Serving lookup from a host arena cache (host_cache): binary
    search the bucket's row runs, numpy-expand them, compare (reference
    find_kmer, buckets.hpp:499-519). Returns (found (Q,) bool, counts
    (Q,) u32 raw sums)."""
    cs, s_max, _, nw = skl_dims(k, m, b)
    n = cache["n_fin_rows"]
    if segments is None:
        segments = [(0, n)]
    Q = packed_cols.shape[1]
    found = np.zeros(Q, bool)
    counts = np.zeros(Q, np.uint64)
    bcol = cache["bucket"]
    # a uint32 needle: a Python int would make numpy cast the whole
    # bucket column to int64 on every search (~20 ms at 8M rows)
    needle = np.uint32(bucket_id)
    for lo_s, hi_s in segments:
        seg = bcol[lo_s:hi_s]
        l = lo_s + int(np.searchsorted(seg, needle, side="left"))
        h = lo_s + int(np.searchsorted(seg, needle, side="right"))
        if h <= l:
            continue
        keys, ok = _expand_rows_np(cache["bucket"][l:h],
                                   cache["meta"][l:h],
                                   cache["nucs"][:, l:h], k, m, b)
        offs = cache["offs"][l:h].astype(np.int64)
        sizes = (cache["meta"][l:h] & 0xFF).astype(np.int64)
        slot_data = np.zeros((h - l) * s_max, np.uint32)
        for jj in range(s_max):
            sel = jj < sizes
            slot_data[jj::s_max][sel] = cache["data"][(offs + jj)[sel]]
        eq = np.ones((Q, keys.shape[1]), bool)
        for i in range(keys.shape[0]):
            eq &= keys[i][None, :] == packed_cols[i][:, None]
        eq &= ok[None, :]
        found |= eq.any(axis=1)
        counts += (eq * slot_data[None, :].astype(np.uint64)).sum(axis=1)
    return found, counts.astype(np.uint32)


# -- batch query: sort-merge join against a transient expansion -----------

def _expand_join_strided(bucket_c, meta_c, nucs_c, k: int, m: int, b: int,
                         s_max: int):
    """(keys (W, R*s_max) int32 J-major, live (R*s_max,) int64) of a
    FRESH arena for the query join: the span expansion itself."""
    keys = _expand_span_jmajor(bucket_c, meta_c, nucs_c, k, m, b, s_max)
    return keys, (keys[0] != -1).to(torch.int64)


def expand_for_join(state: SklState, k: int, m: int, b: int):
    """(keys (W, S) int32, counts (S,) int64) of an arena for the query
    join: fully finalized (positional counts) or fully fresh (1 per live
    slot)."""
    cs, s_max, _, nw = skl_dims(k, m, b)
    F = int(state.n_fin_rows)
    N = int(state.n_rows)
    if F == N:
        return expand_device(state, k, m, b)
    assert F == 0, "join expansion needs a fully fresh or finalized arena"
    R_pad = _shape_family(max(N, 1), floor=1 << 8)
    if R_pad > state.bucket.shape[0]:
        state = grow(state, 1 << (R_pad - 1).bit_length(),
                     state.data.shape[0])
    return _expand_join_strided(state.bucket[:R_pad], state.meta[:R_pad],
                                state.nucs[:, :R_pad].contiguous(),
                                k, m, b, s_max)


def _query_join_partials(ikeys: torch.Tensor, icnt: torch.Tensor,
                         qkeys: torch.Tensor, qlive: torch.Tensor
                         ) -> torch.Tensor:
    """Sum of index counts over a batch of query slots via ONE sort-merge
    join. The side tag rides as the shifted-in LSB of the packed key (the
    layout reserves spare top bits, so key << 1 is lossless); index slots
    (tag 0) sort before query slots (tag 1) of the same key and a
    segmented cumsum of index counts hands each query slot its key's
    total. Returns (256,) int64 partial sums of (count mod 256) per live
    query slot. The sort is torch's (_u32.lexsort); the scan after it is
    one CUDA kernel on the card (kernels.join_scan, csrc/run_scan.cu),
    its plain version _join_scan_torch on the CPU."""
    W = ikeys.shape[0]

    def shifted(keys, tagbit):
        out = []
        for i in range(W):
            w = (to_u32(keys[i]) << 1) & M32
            w = w | ((to_u32(keys[i + 1]) >> 31) if i + 1 < W else tagbit)
            out.append(w)
        return out

    ik_s, qk_s = shifted(ikeys, 0), shifted(qkeys, 1)
    keys = [torch.cat([ik_s[i], qk_s[i]]) for i in range(W)]
    payload = torch.cat([icnt.to(torch.int64), qlive.to(torch.int64)])
    perm = lexsort(keys)
    out = torch.stack([x[perm] for x in keys])
    s_pay = payload[perm]
    if out.device.type != "cuda":
        return _join_scan_torch(out, s_pay)
    return kernels.join_scan(out, s_pay)


def _join_scan_torch(out: torch.Tensor, s_pay: torch.Tensor
                     ) -> torch.Tensor:
    """The join's scan after its sort (plain version of kernels.join_scan,
    csrc/run_scan.cu): out (W, S) int64 sorted u32 words, the side tag in
    bit 0 of out[W - 1]; s_pay (S,) int64. Each query slot with liveness
    1 takes its key's index count so far, mod 256; returns (256,) int64
    partial sums, partial p over the slots [p * L, (p + 1) * L), L =
    ceil(S / 256)."""
    W = out.shape[0]
    is_q = (out[W - 1] & 1) == 1
    # ignore the tag bit when detecting key runs
    first = _first_of_runs(torch.cat([out[:W - 1], (out[W - 1] & ~1)[None]]))
    contrib = torch.where(is_q, 0, s_pay)
    c = torch.cumsum(contrib, 0)
    # csum at each run's start, propagated forward (csum is monotone)
    base = torch.cummax(torch.where(first, c - contrib, 0), 0).values
    vals = torch.where(is_q & (s_pay == 1), (c - base) % 256, 0)
    pad = (-vals.shape[0]) % 256
    vals = torch.cat([vals, vals.new_zeros(pad)]).reshape(256, -1)
    return vals.sum(dim=1)


def query_join_total(state: SklState, qstate_box: list,
                     k: int, m: int, b: int) -> int:
    """Total stored count over every k-mer emission of a QUERY arena
    (un-finalized: one cnt=1 slot per emission) against a FINALIZED
    index arena. qstate_box: single-element list holding the query
    SklState; the callee takes ownership and frees it after expansion.
    Chunked over the query slots to bound peak device memory."""
    with spans.span("join.expand"):
        ik, icnt = expand_for_join(state, k, m, b)
    qstate = qstate_box.pop()
    with spans.span("join.expand"):
        qk, qcnt = expand_for_join(qstate, k, m, b)
    del qstate
    Sq = qk.shape[1]
    CQ = min(Sq, 1 << 26)
    total = 0
    for start in range(0, Sq, CQ):
        with spans.span("join.merge"):
            qc = qk[:, start:start + CQ]
            ql = qcnt[start:start + CQ]
            pad = CQ - qc.shape[1]
            if pad:
                qc = torch.cat([qc, qc.new_full((qc.shape[0], pad), -1)], 1)
                ql = torch.cat([ql, ql.new_zeros(pad)])
            total += int(_query_join_partials(ik, icnt, qc, ql).sum())
    return total


def query_join_keys_total(state: SklState, qk: torch.Tensor,
                          qlive: torch.Tensor, k: int, m: int, b: int,
                          chunk: int = 1 << 26, regroup=None) -> int:
    """Total stored count over a batch of query PACKED KEYS against a
    FINALIZED arena — the shadow-index-free query: the caller enumerates
    the query straight to packed keys, no second arena is built. qk (W,
    Sq) int32 (u32 bit patterns) on the arena's device, qlive (Sq,) bool.
    Chunked over the query slots at a bounded set of widths, each chunk
    padded with INVALID keys, to bound peak device memory. regroup, if
    given, maps the arena's expansion (keys, counts) to the entries to
    join instead (equal keys among them are summed before the wrap)."""
    with spans.span("join.expand"):
        ik, icnt = expand_for_join(state, k, m, b)
        if regroup is not None:
            ik, icnt = regroup(ik, icnt)
    Sq = qk.shape[1]
    CQ = min(_shape_family(max(Sq, 1)), chunk)
    total = 0
    for start in range(0, Sq, CQ):
        with spans.span("join.merge"):
            qc = qk[:, start:start + CQ]
            ql = qlive[start:start + CQ].to(torch.int64)
            pad = CQ - qc.shape[1]
            if pad:
                qc = torch.cat([qc, qc.new_full((qc.shape[0], pad), -1)], 1)
                ql = torch.cat([ql, ql.new_zeros(pad)])
            total += int(_query_join_partials(ik, icnt, qc, ql).sum())
    return total


def _rows_from_keys(keys: torch.Tensor, k: int, m: int, b: int):
    """Packed per-k-mer keys (W, N) -> size-1 rows (bucket, meta, nucs)
    as int64 u32."""
    suffix_reduc = (m - b + 1) // 2
    cs, _, _, nw = skl_dims(k, m, b)
    W = keys.shape[0]
    le = tuple(to_u32(keys[W - 1 - i]) for i in range(W))
    mini_full = le[0] & 0xFF
    kmer_all = u128.shr(le, 8)
    zero = torch.zeros_like(le[0])
    kmer4 = u128.mask_bits(tuple(kmer_all[i] if i < len(kmer_all) else zero
                                 for i in range(4)), 2 * k)
    bucket = u128.shr(le, 8 + 2 * k)[0] & ((1 << (2 * b)) - 1)

    h = mini_full + suffix_reduc
    sh_h = 2 * h
    hi_part = u128.shl_var(u128.shr_var(kmer4, sh_h + 2 * b), sh_h)
    lo_part = u128.band(kmer4, _ones_mask_var(sh_h, 4))
    cmp4 = u128.mask_bits(u128.bor(hi_part, lo_part), 2 * cs)
    nucs = torch.stack([cmp4[i] if i < 4 else zero for i in range(nw)])
    meta = 1 | ((h << 8) & M32)
    return bucket, meta, nucs


def from_entries(state: store.IndexState, k: int, m: int, b: int,
                 chunk: int = 1 << 20) -> SklState:
    """Rebuild a finalized arena of size-1 rows from a compacted
    per-k-mer IndexState on the same device (after reallocate, whose new
    minimizer decomposition invalidates the old super-k-mer groupings).
    Rows come out in packed-key order, so the arena is bucket-grouped."""
    cs, s_max, nt_max, nw = skl_dims(k, m, b)
    dev = state.keys.device
    n = int(state.n_sorted)
    counts = state.data[:n]
    live = counts != 0
    keys = state.keys[:, :n][:, live]
    counts = counts[live]
    n_live = keys.shape[1]
    rcap = max(1024, 1 << max(0, (max(n_live, 1) - 1).bit_length()))
    out = empty(rcap, _shape_family(max(1024, rcap * s_max)), nw, dev)
    for start in range(0, n_live, chunk):
        end = min(start + chunk, n_live)
        bb, mm, nn = _rows_from_keys(keys[:, start:end], k, m, b)
        out.bucket[start:end] = to_i32(bb)
        out.meta[start:end] = to_i32(mm)
        out.nucs[:, start:end] = to_i32(nn)
    # padded data layout: row r's counts at data[r*s_max + j]
    out.data[0:n_live * s_max:s_max] = to_i32(counts)
    out.offs.copy_(to_i32(torch.arange(rcap, device=dev) * s_max))
    nl = _scalar(n_live, dev)
    return out._replace(n_rows=nl, n_fin_rows=nl.clone(),
                        n_fin_kmers=nl.clone())


def stats(state: SklState, k: int, m: int, b: int) -> dict:
    n = int(state.n_fin_rows)
    nk = int(state.n_fin_kmers)
    cs, s_max, _, nw = skl_dims(k, m, b)
    live_counts = distinct_count(state, k, m, b)
    resident = (8 + 4 * nw) * max(n, 1) + n * s_max
    return dict(nb_superkmer_rows=n, nb_slots=nk,
                nb_live_kmers=live_counts,
                avg_kmers_per_skl=(nk / n) if n else 0.0,
                resident_bytes=resident,
                bytes_per_kmer=(resident / live_counts) if live_counts
                else 0.0)


# -- carrying a state across frameworks -----------------------------------

def from_numpy(arrays: dict, device="cpu") -> SklState:
    """SklState from numpy uint32 columns (`bucket`, `meta`, `nucs`,
    `data`, `offs`) and the ints `n_rows`, `n_fin_rows`, `n_fin_kmers` —
    e.g. the arrays of the JAX package's SklState."""
    return SklState(
        bucket=from_np(arrays["bucket"], device),
        meta=from_np(arrays["meta"], device),
        nucs=from_np(arrays["nucs"], device),
        data=from_np(arrays["data"], device),
        offs=from_np(arrays["offs"], device),
        n_rows=_scalar(arrays["n_rows"], device),
        n_fin_rows=_scalar(arrays["n_fin_rows"], device),
        n_fin_kmers=_scalar(arrays["n_fin_kmers"], device))


def to_numpy(state: SklState) -> dict:
    """Inverse of from_numpy: numpy uint32 columns + int counters."""
    return dict(bucket=to_np(state.bucket), meta=to_np(state.meta),
                nucs=to_np(state.nucs), data=to_np(state.data),
                offs=to_np(state.offs), n_rows=int(state.n_rows),
                n_fin_rows=int(state.n_fin_rows),
                n_fin_kmers=int(state.n_fin_kmers))
