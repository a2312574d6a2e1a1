"""Host-side index enumeration: reconstruct original k-mers from stored
hashed keys (port of brisk_tpu.index.readout; numpy, after one copy of
the transient per-k-mer view to the host).

Stored entry key = packed (bucket, hashed_kmer, mini_idx) words
(store.make_keys). The original k-mer is recovered by un-hashing the
2m-bit slice at mini_idx with the inverse mixer (hashing.cpp:23-49) —
64-bit multiplies, vectorized in numpy uint64."""

from typing import Tuple

import numpy as np

from brisk_tpu_torch._u32 import to_np
from brisk_tpu_torch.index import store
from brisk_tpu_torch.params import Parameters


def bfc_hash_inv_np(key: np.ndarray, mask: int) -> np.ndarray:
    """Vectorized inverse of the reference mixer on uint64 arrays."""
    with np.errstate(over="ignore"):
        key = key.astype(np.uint64)
        m = np.uint64(mask)
        tmp = key - (key << np.uint64(31))
        key = (key - (tmp << np.uint64(31))) & m
        tmp = key ^ (key >> np.uint64(28))
        key = key ^ (tmp >> np.uint64(28))
        key = (key * np.uint64(14933078535860113213)) & m
        tmp = key ^ (key >> np.uint64(14))
        tmp = key ^ (tmp >> np.uint64(14))
        tmp = key ^ (tmp >> np.uint64(14))
        key = key ^ (tmp >> np.uint64(14))
        key = (key * np.uint64(15244667743933553977)) & m
        tmp = key ^ (key >> np.uint64(24))
        key = key ^ (tmp >> np.uint64(24))
        tmp = ~key
        tmp = ~(key - (tmp << np.uint64(21)))
        tmp = ~(key - (tmp << np.uint64(21)))
        key = (~(key - (tmp << np.uint64(21)))) & m
        return key


def entries_u64(state: store.IndexState, params: Parameters
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                           np.ndarray]:
    """Vectorized read-out of a compacted state.

    Returns (bucket u32, kmer_hi u64, kmer_lo u64, mini_idx u32,
    counts u32) with the ORIGINAL (un-hashed) k-mer values as 64-bit
    hi/lo pairs (2k <= 126 bits)."""
    n = int(state.n_sorted)
    keys = to_np(state.keys[:, :n])
    counts = to_np(state.data[:n])
    live = counts != 0  # drop compact_fast's zero-data columns
    if not np.all(live):
        keys = keys[:, live]
        counts = counts[live]
    bucket, hi, lo, mini_idx = store.unpack_keys_np(keys, params.k,
                                                    params.b)
    m_mask = np.uint64(params.m_mask)
    s = np.uint64(2) * mini_idx.astype(np.uint64)
    with np.errstate(over="ignore"):
        big = s >= np.uint64(64)
        s1 = np.where(big, s - np.uint64(64), s)
        lo_sh = np.where(big, hi >> s1,
                         np.where(s1 == 0, lo,
                                  (lo >> s1) | (hi << (np.uint64(64) - s1))))
        slices = lo_sh & m_mask
        unhashed = bfc_hash_inv_np(slices, params.m_mask)
        delta = slices ^ unhashed  # XOR difference within the slice
        d_lo = np.where(big, np.uint64(0),
                        np.where(s == 0, delta, delta << s))
        d_hi = np.where(big, delta << s1,
                        np.where(s == 0, np.uint64(0),
                                 delta >> (np.uint64(64) - s)))
        return bucket, hi ^ d_hi, lo ^ d_lo, mini_idx, counts


def entries(state: store.IndexState, params: Parameters
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(kmers_obj, counts, buckets): kmers as an object array of Python
    ints (original un-hashed values), counts as uint32."""
    bucket, hi, lo, _, counts = entries_u64(state, params)
    kmers = (hi.astype(object) << 64) | lo.astype(object)
    return kmers, counts, bucket
