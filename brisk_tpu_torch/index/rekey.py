"""Dynamic index growth: re-key every stored entry under new (m, b)
(port of brisk_tpu.index.rekey).

Brisk::reallocate (Brisk.hpp:202-224) walks every k-mer, re-runs
get_minimizer with m+2 and re-inserts into a fresh index. Here the walk
is batched: stored hashed keys are un-hashed on the host (vectorized
numpy, index.readout), the k-mers are laid out one per lane on the
device, and the new minimizer decomposition is one
windowed_get_minimizer evaluation at the final position of each lane
(update_kmer's get_minimizer-on-the-value semantics, Brisk.hpp:88-97,
not the streaming enumerator).

Deviation from the reference, as in brisk_tpu: when two old entries
collapse to one new key (the same k-mer value stored under two old
minimizer keys), the reference keeps whichever its cursor visits last
(Brisk.hpp:219); this SUMS them, so counts_dict is invariant under
reallocate.
"""

import numpy as np
import torch

from brisk_tpu_torch.index import readout, store
from brisk_tpu_torch.ops import enumerate as enum_ops
from brisk_tpu_torch.ops import hashing, minimizer, u128
from brisk_tpu_torch.params import Parameters


def _codes_from_values(hi: np.ndarray, lo: np.ndarray, k: int) -> np.ndarray:
    """(N,) u64 pairs -> (N, k) uint32 2-bit codes, leftmost base first."""
    n = hi.shape[0]
    codes = np.empty((n, k), dtype=np.uint32)
    for j in range(k):
        bit = 2 * (k - 1 - j)
        if bit >= 64:
            codes[:, j] = ((hi >> np.uint64(bit - 64)) & np.uint64(3))
        else:
            codes[:, j] = ((lo >> np.uint64(bit)) & np.uint64(3))
    return codes


def _rekey_batch(codes: torch.Tensor, k: int, m: int, b: int
                 ) -> torch.Tensor:
    """codes (N, k) int64 -> new (W, N) int64 u32 key words under
    minimizer size m."""
    pa = minimizer.position_pipeline(codes, k, m)
    st = minimizer.windowed_get_minimizer(pa, pa.fwd_k, k, m)
    kmer = tuple(limb[:, -1] for limb in pa.fwd_k)
    pos = st.pos[:, -1]
    idx = torch.where(st.rev[:, -1], (k - m) - pos, pos)
    slice_mm = u128.mask_bits(u128.shr_var(kmer, idx * 2), 2 * m)
    s_hi, s_lo = hashing.mix_key(slice_mm[0], slice_mm[1], m)
    key = enum_ops._hash_slice_replace(kmer, idx, s_hi, s_lo, m)
    bucket = enum_ops._bucket_id(s_hi, s_lo, m, b)
    return store.make_keys(bucket, u128.stack(key), idx, k, b)


def reindex(state: store.IndexState, old: Parameters, new: Parameters,
            batch: int = 1 << 16) -> store.IndexState:
    """Re-key all entries of a compacted state from `old` to `new`, on
    the state's device."""
    dev = state.keys.device
    state = store.compact_auto(state)
    _, hi, lo, _, data = readout.entries_u64(state, old)
    n = hi.shape[0]
    out = store.empty(max(1 << 10, 1 << int(np.ceil(np.log2(max(n, 1) * 2)))),
                      store.key_words(new.k, new.b), dev)
    for start in range(0, n, batch):
        end = min(start + batch, n)
        codes = _codes_from_values(hi[start:end], lo[start:end], new.k)
        rows = _rekey_batch(torch.from_numpy(codes.astype(np.int64)).to(dev),
                            new.k, new.m, new.b)
        out = store.ensure_room(out, rows.shape[1])
        out = store.append(
            out, rows, torch.from_numpy(data[start:end].astype(np.int64)
                                        ).to(dev),
            torch.ones(rows.shape[1], dtype=torch.bool, device=dev))
    return store.compact_auto(out)
