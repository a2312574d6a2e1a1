"""Generic fixed-width DATA payloads (port of brisk_tpu.index.payload, the
`Brisk<DATA>` store; reference Brisk.hpp:23-42).

A payload is D u32 lanes per entry with a STATIC per-lane merge kind
applied when duplicate keys consolidate:

  "sum"   — lanes that accumulate (counts; u32 wrap)
  "max"   — monotone maxima (e.g. last position when positions ascend)
  "min"   — monotone minima (e.g. first position)

Layout mirrors index.store: packed lexicographic keys (W, cap) and lanes
(D, cap), both int32 tensors holding u32 bit patterns, a sorted
deduplicated run [0, n_sorted) and an unsorted log up to n_used.

The reference merges duplicates with a segmented associative scan and
two packing sorts. PyTorch has no associative scan, so `compact` reduces
each run directly: segment id = running count of run starts, then a
scatter-add (sum, masked to 32 bits) or scatter-reduce (max / min, on the
u32 values widened to int64). All three are order-independent on
integers, so the result equals the reference bit for bit on any device.
"""

from typing import NamedTuple, Tuple

import numpy as np
import torch

from brisk_tpu_torch._u32 import (INVALID, M32, from_np, lexsort, to_i32,
                                  to_np, to_u32)
from brisk_tpu_torch.index import store

KINDS = ("sum", "max", "min")
_REDUCE = {"max": "amax", "min": "amin"}


class PayloadState(NamedTuple):
    keys: torch.Tensor   # (W, cap) int32 packed keys (store.make_keys)
    data: torch.Tensor   # (D, cap) int32 payload lanes
    n_sorted: int        # keys[:, :n_sorted] sorted, deduplicated
    n_used: int


def empty(capacity: int, nkey: int, width: int, device="cpu"
          ) -> PayloadState:
    return PayloadState(
        keys=torch.full((nkey, capacity), -1, dtype=torch.int32,
                        device=device),
        data=torch.zeros((width, capacity), dtype=torch.int32,
                         device=device),
        n_sorted=0, n_used=0)


def grow(state: PayloadState, new_capacity: int) -> PayloadState:
    """Capacity growth: INVALID key columns and zero lanes appended."""
    cap = state.keys.shape[1]
    assert new_capacity > cap
    pad = new_capacity - cap
    return state._replace(
        keys=torch.cat([state.keys, state.keys.new_full(
            (state.keys.shape[0], pad), -1)], dim=1),
        data=torch.cat([state.data, state.data.new_zeros(
            (state.data.shape[0], pad))], dim=1))


def ensure_room(state: PayloadState, n_incoming: int) -> PayloadState:
    """Grow (double) until the log can absorb n_incoming columns."""
    cap = state.keys.shape[1]
    while state.n_used + n_incoming > cap:
        cap *= 2
        state = grow(state, cap)
    return state


def _words(x: torch.Tensor) -> torch.Tensor:
    """u32 words (int64 values or int32 bit patterns) -> int32."""
    return x if x.dtype == torch.int32 else to_i32(x)


def append(state: PayloadState, keys: torch.Tensor, values: torch.Tensor,
           valid: torch.Tensor) -> PayloadState:
    """Append (W, N) keys with (D, N) lanes to the unsorted log, in
    place: invalid columns become INVALID tombstones with zero lanes and
    still take log slots (n_used advances by N). Raises instead of
    clamping when the log has no room (callers ensure_room first)."""
    n0, n = state.n_used, keys.shape[1]
    cap = state.keys.shape[1]
    if n0 + n > cap:
        raise ValueError(f"payload.append: {n} columns at offset {n0} "
                         f"overflow capacity {cap} (ensure_room first)")
    state.keys[:, n0:n0 + n] = torch.where(valid[None, :], _words(keys), -1)
    state.data[:, n0:n0 + n] = torch.where(valid[None, :], _words(values),
                                           0)
    return state._replace(n_used=n0 + n)


def append_masked(state: PayloadState, keys: torch.Tensor,
                  lanes: torch.Tensor) -> PayloadState:
    """append of columns already tombstoned (an invalid column holds
    INVALID keys and zero lanes): (W, N) keys and (D, N) lanes, int32,
    written at n_used with two slice copies, in place; n_used advances
    by N. Raises when the log has no room, as append does."""
    n0, n = state.n_used, keys.shape[1]
    cap = state.keys.shape[1]
    if n0 + n > cap:
        raise ValueError(f"payload.append_masked: {n} columns at offset "
                         f"{n0} overflow capacity {cap} (ensure_room "
                         f"first)")
    state.keys[:, n0:n0 + n] = keys
    state.data[:, n0:n0 + n] = lanes
    return state._replace(n_used=n0 + n)


def compact(state: PayloadState, kinds: Tuple[str, ...]) -> PayloadState:
    """Global sort + duplicate merge: the used columns become one sorted
    run of distinct keys (the rest INVALID with zero lanes), each lane
    reduced over its key's duplicates under that lane's kind. INVALID
    tombstones are dropped. Returns a new state of the same capacity."""
    W, cap = state.keys.shape
    D = state.data.shape[0]
    if len(kinds) != D:
        raise ValueError(f"{len(kinds)} kinds for {D} payload lanes")
    for kind in kinds:
        if kind not in KINDS:
            raise ValueError(f"unknown merge kind {kind!r} "
                             f"(use one of {KINDS})")
    dev = state.keys.device
    out = empty(cap, W, D, dev)
    n = state.n_used
    if n == 0:
        return out
    perm = lexsort([state.keys[i, :n] for i in range(W)])
    keys = state.keys[:, :n][:, perm]
    first = store._first_of_runs(keys)
    seg = torch.cumsum(first, 0) - 1
    heads = keys[:, first]
    # INVALID keys sort last, so the valid runs are a prefix
    n_unique = int((to_u32(heads[0]) != INVALID).sum())
    out.keys[:, :n_unique] = heads[:, :n_unique]
    n_seg = heads.shape[1]
    for d, kind in enumerate(kinds):
        lane = to_u32(state.data[d, :n][perm])
        red = torch.zeros(n_seg, dtype=torch.int64, device=dev)
        if kind == "sum":
            red = red.index_add_(0, seg, lane) & M32
        else:
            red = red.scatter_reduce_(0, seg, lane, _REDUCE[kind],
                                      include_self=False)
        out.data[d, :n_unique] = to_i32(red[:n_unique])
    return out._replace(n_sorted=n_unique, n_used=n_unique)


def lookup(state: PayloadState, keys: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W, Q) packed keys -> (found (Q,) bool, lanes (D, Q) int32; 0 where
    not found). Binary search over the sorted run [0, n_sorted) with the
    reference's step count; callers compact first."""
    cap = state.keys.shape[1]
    q = to_u32(keys)
    nk, nq = q.shape
    dev = state.keys.device
    lo = torch.zeros(nq, dtype=torch.int64, device=dev)
    hi = torch.full((nq,), state.n_sorted, dtype=torch.int64, device=dev)
    steps = int(np.ceil(np.log2(max(cap, 2)))) + 1
    for _ in range(steps):
        mid = (lo + hi) // 2
        # out-of-range reads clamp, as the reference's gather does
        a = to_u32(state.keys[:, mid.clamp(max=cap - 1)])
        lt = a[0] < q[0]
        eqs = a[0] == q[0]
        for i in range(1, nk):
            lt = lt | (eqs & (a[i] < q[i]))
            eqs = eqs & (a[i] == q[i])
        lo = torch.where(lt, mid + 1, lo)
        hi = torch.where(lt, hi, mid)
    pos = lo.clamp(0, cap - 1)
    found = (to_u32(state.keys[:, pos]) == q).all(0) & (lo < state.n_sorted)
    vals = torch.where(found[None, :], state.data[:, pos], 0)
    return found, vals


def from_numpy(keys: np.ndarray, data: np.ndarray, n_sorted: int,
               n_used: int, device="cpu") -> PayloadState:
    """PayloadState from numpy uint32 keys (W, cap) and lanes (D, cap) —
    e.g. the arrays of the JAX package's PayloadState."""
    return PayloadState(from_np(keys, device), from_np(data, device),
                        int(n_sorted), int(n_used))


def to_numpy(state: PayloadState) -> dict:
    """Inverse of from_numpy: numpy uint32 `keys`, `data` + int counters."""
    return dict(keys=to_np(state.keys), data=to_np(state.data),
                n_sorted=int(state.n_sorted), n_used=int(state.n_used))
