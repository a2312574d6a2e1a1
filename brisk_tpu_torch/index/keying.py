"""Serving-grade vectorized query keying (VERDICT r4 item 5a).

`Brisk.get()` keyed every call through the pure-Python oracle: a fresh
big-int minimizer scan + bfc mix per lookup — milliseconds per k-mer.
This module is the same math (reference str2kmer Kmers.cpp:257-268 +
get_minimizer Kmers.cpp:367-408 + hash_kmer_minimizer_inplace
Kmers.cpp:191-200 + bucket keying Brisk.hpp:107-137) restated in
vectorized numpy uint64 over a BATCH of query k-mers, including every
tie-break and the k > 32 truncation quirk. float64 is native on host, so
the decycling classification is bit-identical to the reference (no
compensated-f32 machinery needed here).

Output: (bucket (Q,) u32, packed key columns (W, Q) u32) — exactly the
store.make_keys layout the arena probes/joins consume. Validated
entry-for-entry against the pyref oracle in tests/test_api.py.
"""

import functools

import numpy as np

from brisk_tpu_torch.index import store

U64 = np.uint64
_M64 = U64(0xFFFFFFFFFFFFFFFF)


def strs_to_codes(kmers) -> np.ndarray:
    """ACGT strings (equal length) -> (Q, k) uint8 codes ((c>>1)&3)."""
    raw = np.frombuffer("".join(kmers).encode(), dtype=np.uint8)
    return ((raw >> 1) & 3).reshape(len(kmers), -1)


def codes_to_u128(codes: np.ndarray):
    """(Q, k) codes -> (hi, lo) u64 pairs, first base in the HIGHEST
    bits (str2num convention: num = (num << 2) | code)."""
    Q, k = codes.shape
    hi = np.zeros(Q, dtype=U64)
    lo = np.zeros(Q, dtype=U64)
    with np.errstate(over="ignore"):
        for j in range(k):
            hi = ((hi << U64(2)) | (lo >> U64(62))) & _M64
            lo = ((lo << U64(2)) | codes[:, j].astype(U64)) & _M64
    return hi, lo


def _rcb64_np(x: np.ndarray, n: int) -> np.ndarray:
    """True reverse complement of n<=32 bases (reference rcbc,
    Kmers.cpp:320-332), vectorized."""
    with np.errstate(over="ignore"):
        res = (x ^ U64(0xAAAAAAAAAAAAAAAA)).byteswap()
        c1 = U64(0x0F0F0F0F0F0F0F0F)
        c2 = U64(0x3333333333333333)
        res = ((res & c1) << U64(4)) | ((res & (c1 << U64(4))) >> U64(4))
        res = ((res & c2) << U64(2)) | ((res & (c2 << U64(2))) >> U64(2))
        return res >> U64(64 - 2 * n)


def _rcb128_broken_np(hi: np.ndarray, lo: np.ndarray, n: int):
    """The reference's broken 128-bit RC (Kmers.cpp:293-316): nucleotide
    reversal only within each byte, complement, then realign-shift."""
    c1 = U64(0x0F0F0F0F0F0F0F0F)
    c2 = U64(0x3333333333333333)

    def half(v):
        with np.errstate(over="ignore"):
            v = ((v & c1) << U64(4)) | ((v & (c1 << U64(4))) >> U64(4))
            v = ((v & c2) << U64(2)) | ((v & (c2 << U64(2))) >> U64(2))
            return v ^ U64(0xAAAAAAAAAAAAAAAA)

    chi, clo = half(hi), half(lo)
    s = 128 - 2 * n
    with np.errstate(over="ignore"):
        if s == 0:
            return chi, clo
        if s < 64:
            out_lo = (clo >> U64(s)) | (chi << U64(64 - s))
            out_hi = chi >> U64(s)
        else:
            out_lo = chi >> U64(s - 64)
            out_hi = np.zeros_like(chi)
        return out_hi, out_lo


def _u128_le(a_hi, a_lo, b_hi, b_lo):
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo <= b_lo))


@functools.lru_cache(maxsize=None)
def _coef_table(m: int) -> np.ndarray:
    """(m, 4) float64: coef[4*i + v] laid out per slot i (reference
    Decycling.cpp coef construction, incl. the 3*s float64 rounding)."""
    import math
    unit = 2 * math.pi / m
    t = np.zeros((m, 4), dtype=np.float64)
    for i in range(1, m):
        s = math.sin(unit * i)
        t[i, 1] = s
        t[i, 2] = 2 * s
        t[i, 3] = 3 * s
    return t


def _mem_double_np(seq: np.ndarray, m: int) -> np.ndarray:
    """Vectorized DecyclingSet.memDouble on (N,) u64 m-mers -> u64 class
    in {0, 1, 2} (reference Decycling.cpp:28-52, float64-exact)."""
    t = _coef_table(m)
    N = seq.shape[0]
    # compute_r consumes from coef index 4*(m-1) downward with the m-mer's
    # LOW bases first -> slot i (1..m-1) sees base (m-1-i) from the left,
    # i.e. bit offset 2*(i-1) from the LOW end reversed... replicate the
    # loop literally: r += coef[i*4 + (seq & 3)], seq >>= 2, i -= 1
    r = np.zeros(N, dtype=np.float64)
    s = seq.copy()
    for i in range(m - 1, 0, -1):
        r += t[i][(s & U64(3)).astype(np.int64)]
        s >>= U64(2)
    rot = ((seq & U64(3)) << U64(2 * (m - 1))) + (seq >> U64(2))
    r_rot = np.zeros(N, dtype=np.float64)
    s = rot.copy()
    for i in range(m - 1, 0, -1):
        r_rot += t[i][(s & U64(3)).astype(np.int64)]
        s >>= U64(2)
    eps = 1e-6
    cls = np.full(N, 2, dtype=U64)
    cls = np.where((r > eps) & (r_rot < eps), U64(0), cls)
    cls = np.where((r < -eps) & (r_rot > -eps), U64(1), cls)
    return cls


def bfc_hash_np(key: np.ndarray, m: int) -> np.ndarray:
    """Vectorized reference mixer (hashing.cpp:8-20) incl. the heavy
    class in bits 62-63."""
    mask = U64((1 << (2 * m)) - 1)
    heavy = _mem_double_np(key, m)
    with np.errstate(over="ignore"):
        key = (~key + (key << U64(21))) & mask
        key = key ^ (key >> U64(24))
        key = ((key + (key << U64(3))) + (key << U64(8))) & mask
        key = key ^ (key >> U64(14))
        key = ((key + (key << U64(2))) + (key << U64(4))) & mask
        key = key ^ (key >> U64(28))
        key = (key + (key << U64(31))) & mask
        return (heavy << U64(62)) + key


def key_batch(codes: np.ndarray, m: int, b: int):
    """Key a batch of (Q, k) k-mer codes: returns (bucket (Q,) u32,
    packed key columns (W, Q) u32) — the store.make_keys identity of
    each k-mer under its own minimizer decomposition (the reference
    str2kmer + find_kmer keying)."""
    Q, k = codes.shape
    m_mask = U64((1 << (2 * m)) - 1)
    hi, lo = codes_to_u128(codes)

    # -- get_minimizer (Kmers.cpp:367-408), vectorized over Q ----------
    cur = lo.copy()  # uint64_t cur_seq = seq: the k > 32 truncation quirk
    fwd = cur & m_mask
    mini = np.minimum(fwd, _rcb64_np(fwd, m))
    hash_mini = bfc_hash_np(mini, m)
    reversed_ = mini != fwd
    min_position = np.zeros(Q, dtype=np.int64)
    # canonized(seq, k) via the broken 128-bit RC (tie-break rule b)
    rc_hi, rc_lo = _rcb128_broken_np(hi, lo, k)
    canon_k = _u128_le(hi, lo, rc_hi, rc_lo)
    for i in range(1, k - m + 1):
        cur = cur >> U64(2)
        fwd = cur & m_mask
        mmer = np.minimum(fwd, _rcb64_np(fwd, m))
        new_hash = bfc_hash_np(mmer, m)
        lt = new_hash < hash_mini
        eq = new_hash == hash_mini
        closer = eq & (k - m - i < min_position)
        tie_pos = eq & (k - m - i == min_position) & ~canon_k
        take = lt | closer
        min_position = np.where(take, np.where(lt, i, k - m - i),
                                np.where(tie_pos, k - m - i,
                                         min_position))
        mini = np.where(take | tie_pos, mmer, mini)
        reversed_ = np.where(take, mmer != fwd,
                             np.where(tie_pos, False, reversed_))
        hash_mini = np.where(take, new_hash, hash_mini)
    idx = np.where(reversed_, k - m - min_position, min_position
                   ).astype(U64)

    # -- hash_kmer_minimizer_inplace + bucket id -----------------------
    s = U64(2) * idx
    with np.errstate(over="ignore"):
        big = s >= U64(64)
        s1 = np.where(big, s - U64(64), s)
        lo_sh = np.where(big, hi >> s1,
                         np.where(s1 == 0, lo,
                                  (lo >> s1) | (hi << (U64(64) - s1))))
        slice_mm = lo_sh & m_mask
        hashed = bfc_hash_np(slice_mm, m)
        hashed_slice = hashed & m_mask
        delta = slice_mm ^ hashed_slice
        d_lo = np.where(big, U64(0), np.where(s == 0, delta, delta << s))
        d_hi = np.where(big, delta << s1,
                        np.where(s == 0, U64(0), delta >> (U64(64) - s)))
        key_hi = hi ^ d_hi
        key_lo = lo ^ d_lo

    # bucket: reduced hashed minimizer (Brisk.hpp:135-137)
    m_reduc_suffix = (m - b + 1) // 2
    bucket = ((hashed >> U64(2 * m_reduc_suffix))
              & U64((1 << (2 * b)) - 1)).astype(np.uint32)

    # -- pack into big-endian key words (store.make_keys layout) -------
    W = store.key_words(k, b)
    le = [np.zeros(Q, dtype=np.uint32) for _ in range(W)]

    def deposit(val_u64: np.ndarray, bitpos: int, width: int) -> None:
        with np.errstate(over="ignore"):
            for w in range(W):
                base = 32 * w
                if base + 32 <= bitpos or base >= bitpos + width:
                    continue
                if base >= bitpos:
                    word = (val_u64 >> U64(base - bitpos))
                else:
                    word = (val_u64 << U64(bitpos - base))
                le[w] |= (word & U64(0xFFFFFFFF)).astype(np.uint32)

    deposit(idx, 0, 8)
    deposit(key_lo, 8, min(64, 2 * k))
    if 2 * k > 64:
        deposit(key_hi, 72, 2 * k - 64)
    deposit(bucket.astype(U64), 8 + 2 * k, 2 * b)
    return bucket, np.stack(le[::-1])
