"""Packed per-k-mer keys and the per-k-mer log-structured state (port of
brisk_tpu.index.store: the transient sorted view of the arena, the
re-keying state of reallocate, and `pack_key_np` for the payload API's
scalar keys; `lookup` and `bucket_of` serve the sharded facade and come
with it).

A packed key is the bit-field concatenation
    bucket(2b bits) | hashed_kmer(2k bits) | mini_idx(8 bits)
laid out big-endian over W = key_words(k, b) u32 words, so word-wise
lexicographic order equals (bucket, hashed kmer, mini_idx) order. One
spare top bit is always reserved, so the all-ones INVALID word is
unreachable by a real key. Keys are stored as int32 bit patterns.
"""

from typing import NamedTuple

import numpy as np
import torch

from brisk_tpu_torch import kernels
from brisk_tpu_torch._u32 import INVALID, M32, lexsort, to_i32, to_u32


def key_words(k: int, b: int) -> int:
    """#u32 words of a packed key: bucket(2b) | kmer(2k) | mini_idx(8),
    plus one reserved top bit (INVALID sentinel headroom)."""
    return -(-(2 * b + 2 * k + 8 + 1) // 32)


class IndexState(NamedTuple):
    keys: torch.Tensor   # (W, cap) int32 packed keys (big-endian words)
    data: torch.Tensor   # (cap,) int64 counts
    n_sorted: int        # keys[:, :n_sorted] sorted (duplicates adjacent)
    n_used: int


def empty(capacity: int, nkey: int, device="cpu") -> IndexState:
    return IndexState(
        keys=torch.full((nkey, capacity), -1, dtype=torch.int32,
                        device=device),
        data=torch.zeros(capacity, dtype=torch.int64, device=device),
        n_sorted=0, n_used=0)


def grow(state: IndexState, new_capacity: int) -> IndexState:
    """Capacity growth: INVALID key columns and zero data appended."""
    cap = state.keys.shape[1]
    assert new_capacity > cap
    pad = new_capacity - cap
    return state._replace(
        keys=torch.cat([state.keys, state.keys.new_full(
            (state.keys.shape[0], pad), -1)], dim=1),
        data=torch.cat([state.data, state.data.new_zeros(pad)]))


def append(state: IndexState, keys: torch.Tensor, values: torch.Tensor,
           valid: torch.Tensor) -> IndexState:
    """Append a batch of (key, value) columns to the unsorted log, in
    place. Invalid columns are written as INVALID tombstones with zero
    data and still occupy log slots (ensure_room takes the RAW batch
    width). keys (W, n) u32 words; values (n,) counts."""
    n0, n = state.n_used, keys.shape[1]
    state.keys[:, n0:n0 + n] = torch.where(valid[None, :], to_i32(keys), -1)
    state.data[n0:n0 + n] = torch.where(valid, values.to(torch.int64), 0)
    return state._replace(n_used=n0 + n)


def ensure_room(state: IndexState, n_incoming: int) -> IndexState:
    """Grow (double) until the log can absorb n_incoming columns."""
    cap = state.keys.shape[1]
    while state.n_used + n_incoming > cap:
        cap *= 2
        state = grow(state, cap)
    return state


def _deposit(limbs, word, bitpos: int):
    """OR (word << bitpos) into little-endian u32 limbs (static bitpos)."""
    n = len(limbs)
    out = list(limbs)
    w, bit = divmod(bitpos, 32)
    if w < n:
        out[w] = out[w] | (((word << bit) & M32) if bit else word)
    if bit and w + 1 < n:
        out[w + 1] = out[w + 1] | (word >> (32 - bit))
    return out


def make_key_words(bucket: torch.Tensor, key_limbs, mini_idx: torch.Tensor,
                   k: int, b: int) -> list:
    """Big-endian LIST of W int64 u32 word tensors (key_limbs: a (4, N)
    tensor or a 4-tuple of u32 limbs)."""
    W = key_words(k, b)
    words = [torch.zeros_like(bucket)] * W  # little-endian while building
    words = _deposit(words, mini_idx, 0)
    for j in range(4):
        if 32 * j < 2 * k:
            words = _deposit(words, key_limbs[j], 8 + 32 * j)
    words = _deposit(words, bucket, 8 + 2 * k)
    return words[::-1]


def make_keys(bucket, key_limbs, mini_idx, k: int, b: int) -> torch.Tensor:
    """(W, N) int64 u32 big-endian key words."""
    return torch.stack(make_key_words(bucket, key_limbs, mini_idx, k, b))


def bucket_of(rows: torch.Tensor, k: int, b: int) -> torch.Tensor:
    """The bucket id of packed key rows (W, N), int32 bit patterns or
    int64 u32, as (N,) int64."""
    W = rows.shape[0]
    w, bit = divmod(8 + 2 * k, 32)  # little-endian word/bit of bucket LSB
    le = [to_u32(rows[W - 1 - i]) for i in range(W)]
    v = le[w] >> bit
    if bit and w + 1 < W:
        v = v | ((le[w + 1] << (32 - bit)) & M32)
    return v & ((1 << (2 * b)) - 1)


def pack_key_np(bucket: int, hashed_kmer: int, mini_idx: int, k: int,
                b: int) -> np.ndarray:
    """Host-side single-key packing (for scalar queries/tests)."""
    W = key_words(k, b)
    v = (bucket << (2 * k + 8)) | (hashed_kmer << 8) | mini_idx
    return np.array([(v >> (32 * (W - 1 - w))) & 0xFFFFFFFF
                     for w in range(W)], dtype=np.uint32)


def unpack_keys_np(keys: np.ndarray, k: int, b: int):
    """Host-side vectorized unpack of (W, N) uint32 packed keys ->
    (bucket u32, hashed kmer (hi, lo) u64 pairs, mini_idx u32)."""
    W = keys.shape[0]
    le = keys[::-1].astype(np.uint64)
    mini_idx = (le[0] & np.uint64(0xFF)).astype(np.uint32)

    def bits(lo_bit: int, width: int) -> np.ndarray:
        out = np.zeros(keys.shape[1], dtype=np.uint64)
        for w in range(W):
            base = 32 * w
            if base + 32 <= lo_bit or base >= lo_bit + width:
                continue
            word = le[w]
            if base >= lo_bit:
                out |= word << np.uint64(base - lo_bit)
            else:
                out |= word >> np.uint64(lo_bit - base)
        if width < 64:
            out &= np.uint64((1 << width) - 1)
        return out

    kmer_lo = bits(8, min(64, 2 * k))
    kmer_hi = bits(72, max(0, 2 * k - 64)) if 2 * k > 64 else \
        np.zeros(keys.shape[1], dtype=np.uint64)
    bucket = bits(8 + 2 * k, 2 * b).astype(np.uint32)
    return bucket, kmer_hi, kmer_lo, mini_idx


def _lex_sort(keys: torch.Tensor, *payloads):
    """Sort the columns of (W, N) keys lexicographically (stable),
    carrying payloads. Returns (sorted keys, tuple of payloads)."""
    perm = lexsort([keys[i] for i in range(keys.shape[0])])
    return keys[:, perm], tuple(p[perm] for p in payloads)


def _first_of_runs(keys: torch.Tensor) -> torch.Tensor:
    """Column starts a run of equal keys (along the last dim)."""
    first = torch.zeros(keys.shape[1:], dtype=torch.bool,
                        device=keys.device)
    first[..., 0] = True
    first[..., 1:] |= torch.any(keys[..., 1:] != keys[..., :-1], dim=0)
    return first


def _reverse_cummin(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.flip(torch.cummin(torch.flip(x, [dim]), dim).values, [dim])


def _sorted_runs(state: IndexState):
    """The used columns lex-sorted (the rest INVALID keys with zero data),
    with run-first / run-last masks, the valid mask and the running sum
    of the data."""
    cap = state.keys.shape[1]
    in_use = torch.arange(cap, device=state.keys.device) < state.n_used
    keys = torch.where(in_use[None, :], state.keys, -1)
    data = torch.where(in_use, state.data, 0)
    keys, (data,) = _lex_sort(keys, data)
    first = _first_of_runs(keys)
    is_last = torch.ones_like(first)
    is_last[:-1] = first[1:]
    valid = to_u32(keys[0]) != INVALID
    return keys, data, first, is_last, valid, torch.cumsum(data, 0)


def compact_fast(state: IndexState) -> IndexState:
    """Sort + consolidate duplicate counts WITHOUT compressing: each
    duplicate run's total lands on its FIRST column; later duplicates
    stay in place as zero-data columns. keys[:, :n_sorted] are sorted;
    readers treat data == 0 columns as dead."""
    keys, data, first, is_last, valid, csum = _sorted_runs(state)
    last_csum = _reverse_cummin(
        torch.where(is_last, csum, torch.iinfo(torch.int64).max))
    totals = torch.where(first & valid, last_csum - (csum - data), 0)
    n_valid = int(valid.sum())
    return IndexState(keys, totals, n_valid, n_valid)


def _run_totals_torch(data: torch.Tensor, first: torch.Tensor):
    """Each run's total and each column's run index, over columns in
    sorted order (plain version of kernels.run_totals, csrc/run_scan.cu):
    data (N,) int64, first (N,) bool run starts. Returns seg_total (N,)
    int64, the run's sum mod 2^32 at its last column and 0 elsewhere
    (summed in int64 and masked, so a total past 2^32 keeps its low
    bits), and seg_id (N,) int64, cumsum(first) - 1."""
    is_last = torch.ones_like(first)
    is_last[:-1] = first[1:]
    csum = torch.cumsum(data, 0)
    seg_base = torch.cummax(torch.where(first, csum - data, 0), 0).values
    seg_total = torch.where(is_last, (csum - seg_base) & M32, 0)
    seg_id = torch.cumsum(first.to(torch.int64), 0) - 1
    return seg_total, seg_id


def compact(state: IndexState) -> IndexState:
    """Global sort + duplicate segment-sum: the whole state becomes one
    sorted, deduplicated run (key columns [0, n_unique), the rest
    INVALID with zero data). Each run's total moves from its LAST column
    to its FIRST by two stable packing sorts keyed on the run's rank. The
    run totals are one kernel on a CUDA tensor (kernels.run_totals), the
    plain version on the CPU."""
    keys, data, first, is_last, valid, _ = _sorted_runs(state)
    if data.device.type == "cuda":
        seg_total, seg_id = kernels.run_totals(data, first)
    else:
        seg_total, seg_id = _run_totals_torch(data, first)
    big = 0x7FFFFFFF
    keys_u = keys[:, torch.sort(torch.where(first, seg_id, big),
                                stable=True).indices]
    data_u = seg_total[torch.sort(torch.where(is_last, seg_id, big),
                                  stable=True).indices]
    n_unique = int((first & valid).sum())
    keep = torch.arange(keys.shape[1], device=keys.device) < n_unique
    return IndexState(torch.where(keep[None, :], keys_u, -1),
                      torch.where(keep, data_u, 0), n_unique, n_unique)


def _write_back(state: IndexState, sub_keys: torch.Tensor,
                sub_data: torch.Tensor, n: int) -> IndexState:
    """A copy of `state` with its first columns replaced by the
    compacted prefix (the input state is left as it was)."""
    keys = state.keys.clone()
    data = state.data.clone()
    keys[:, :sub_keys.shape[1]] = sub_keys
    data[:sub_data.shape[0]] = sub_data
    return IndexState(keys, data, n, n)


def compact_auto(state: IndexState) -> IndexState:
    """compact() that sorts only a power-of-two prefix covering the used
    region instead of the whole capacity. Columns >= n_used must be
    INVALID keys with zero data (empty/grow/append/compact keep that)."""
    cap = state.keys.shape[1]
    n = state.n_used
    n2 = 1 << max(10, (max(n, 1) - 1).bit_length())
    if n2 >= cap:
        return compact(state)
    sub = compact(IndexState(state.keys[:, :n2], state.data[:n2],
                             state.n_sorted, state.n_used))
    return _write_back(state, sub.keys, sub.data, sub.n_sorted)

