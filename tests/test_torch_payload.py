"""index.payload of the port against brisk_tpu.index.payload on the CPU:
empty / append / grow / ensure_room / compact / lookup on numpy-seeded
random states with forced duplicates, tombstones, every merge kind, sums
near 2^32 and max / min values >= 2^31. Arrays must be equal exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brisk_tpu.index import payload as jp
from brisk_tpu_torch._u32 import from_np
from brisk_tpu_torch.index import payload as tp

torch.set_num_threads(2)

CAP = 1024


def _columns(rng, W, D, n, n_distinct, tomb=0.1):
    """n key columns drawn from n_distinct real keys (top bit of word 0
    clear, as store.make_keys guarantees), ~`tomb` of them INVALID
    tombstones with zero lanes; lanes mix small values, values near 2^32
    and values >= 2^31."""
    pool = rng.integers(0, 1 << 32, (W, n_distinct), dtype=np.uint64)
    pool[0] >>= 1
    # keys that differ in the last word only, and in the first only
    pool[:, 1] = pool[:, 0]
    pool[-1, 1] ^= 1
    pool[:, 2] = pool[:, 0]
    pool[0, 2] ^= 1 << 30
    keys = pool[:, rng.integers(0, n_distinct, n)].astype(np.uint32)
    pick = rng.integers(0, 3, (D, n))
    data = np.where(pick == 0, rng.integers(0, 100, (D, n)),
                    np.where(pick == 1,
                             rng.integers((1 << 32) - 50, 1 << 32, (D, n)),
                             rng.integers(1 << 31, 1 << 32, (D, n)))
                    ).astype(np.uint32)
    valid = rng.random(n) >= tomb
    return keys, data, valid


def _pair(W, D, cap=CAP):
    return jp.empty(cap, W, D), tp.empty(cap, W, D)


def _append_both(js, ts, keys, data, valid):
    js = jp.append(js, jnp.asarray(keys), jnp.asarray(data),
                   jnp.asarray(valid))
    ts = tp.append(ts, from_np(keys, "cpu"), from_np(data, "cpu"),
                   torch.from_numpy(valid))
    return js, ts


def _assert_same(js, ts):
    got = tp.to_numpy(ts)
    assert (got["n_sorted"], got["n_used"]) == (int(js.n_sorted),
                                                int(js.n_used))
    np.testing.assert_array_equal(got["keys"], np.asarray(js.keys))
    np.testing.assert_array_equal(got["data"], np.asarray(js.data))


@pytest.mark.parametrize("kinds", [("sum",), ("sum", "max"),
                                   ("sum", "max", "min"),
                                   ("sum", "min", "min", "max")])
@pytest.mark.parametrize("W", [3, 6])
def test_append_and_compact_match(kinds, W):
    rng = np.random.default_rng(len(kinds) * 10 + W)
    D = len(kinds)
    js, ts = _pair(W, D)
    for n, n_distinct in ((300, 40), (200, 400)):
        keys, data, valid = _columns(rng, W, D, n, n_distinct)
        js, ts = _append_both(js, ts, keys, data, valid)
        _assert_same(js, ts)
    js, ts = jp.compact(js, kinds), tp.compact(ts, kinds)
    _assert_same(js, ts)
    assert 0 < ts.n_sorted < 500
    # a second round on top of the sorted run
    keys, data, valid = _columns(rng, W, D, 250, 60)
    js, ts = _append_both(js, ts, keys, data, valid)
    js, ts = jp.compact(js, kinds), tp.compact(ts, kinds)
    _assert_same(js, ts)


def test_sum_wraps_and_max_min_order_as_u32():
    """Three duplicates of one key whose sum passes 2^32, and lanes whose
    values sit on both sides of 2^31."""
    kinds = ("sum", "max", "min")
    keys = np.array([[5, 5, 5, 7], [1, 1, 1, 2], [9, 9, 9, 3]], np.uint32)
    data = np.array([[0xFFFFFFF0, 0x20, 0x7FFFFFFF, 1],
                     [0x7FFFFFFF, 0x80000000, 3, 0xFFFFFFFF],
                     [0x80000001, 0x7FFFFFFF, 0xFFFFFFFE, 0]], np.uint32)
    js, ts = _pair(3, 3, cap=8)
    js, ts = _append_both(js, ts, keys, data, np.ones(4, bool))
    js, ts = jp.compact(js, kinds), tp.compact(ts, kinds)
    _assert_same(js, ts)
    got = tp.to_numpy(ts)["data"][:, 0]
    np.testing.assert_array_equal(
        got, [(0xFFFFFFF0 + 0x20 + 0x7FFFFFFF) & 0xFFFFFFFF, 0x80000000,
              0x7FFFFFFF])


def test_empty_and_all_tombstone_states():
    kinds = ("sum", "max")
    js, ts = _pair(3, 2)
    _assert_same(jp.compact(js, kinds), tp.compact(ts, kinds))
    rng = np.random.default_rng(3)
    keys, data, _ = _columns(rng, 3, 2, 50, 10)
    js, ts = _append_both(js, ts, keys, data, np.zeros(50, bool))
    js, ts = jp.compact(js, kinds), tp.compact(ts, kinds)
    _assert_same(js, ts)
    assert ts.n_sorted == 0


def test_grow_and_ensure_room_match():
    rng = np.random.default_rng(4)
    js, ts = _pair(3, 2, cap=64)
    for n in (40, 40, 100, 7):
        keys, data, valid = _columns(rng, 3, 2, n, 30)
        js, ts = jp.ensure_room(js, n), tp.ensure_room(ts, n)
        js, ts = _append_both(js, ts, keys, data, valid)
        _assert_same(js, ts)
    assert ts.keys.shape[1] == 256
    _assert_same(jp.grow(js, 300), tp.grow(ts, 300))


def test_append_overflow_raises():
    """The reference clamps a slice write past its capacity; the port
    raises instead."""
    ts = tp.empty(16, 3, 2)
    keys = from_np(np.zeros((3, 10), np.uint32), "cpu")
    vals = from_np(np.zeros((2, 10), np.uint32), "cpu")
    ts = tp.append(ts, keys, vals, torch.ones(10, dtype=torch.bool))
    with pytest.raises(ValueError, match="overflow capacity"):
        tp.append(ts, keys, vals, torch.ones(10, dtype=torch.bool))
    with pytest.raises(ValueError, match="unknown merge kind"):
        tp.compact(ts, ("sum", "mean"))


@pytest.mark.parametrize("full", [False, True])
def test_lookup_hits_and_misses(full):
    """Stored keys (hits), their neighbours and random keys (misses), on
    a compacted state; `full` fills the capacity so the search reads
    past the sorted run's end."""
    kinds = ("sum", "max", "min")
    rng = np.random.default_rng(5 + full)
    cap = 256
    js, ts = _pair(3, 3, cap=cap)
    n_distinct = cap if full else 150
    keys = rng.integers(0, 1 << 32, (3, n_distinct), dtype=np.uint64)
    keys[0] >>= 1
    keys = keys.astype(np.uint32)
    if full:
        keys[2] = np.arange(cap, dtype=np.uint32)  # all distinct
    data = rng.integers(0, 1 << 32, (3, n_distinct), dtype=np.uint64
                        ).astype(np.uint32)
    js, ts = _append_both(js, ts, keys, data, np.ones(n_distinct, bool))
    js, ts = jp.compact(js, kinds), tp.compact(ts, kinds)
    if full:
        assert ts.n_sorted == cap
    near = keys[:, :40].copy()
    near[2] ^= 1
    big = np.full((3, 5), 0x7FFFFFFF, np.uint32)
    big[0, 0] = 0xFFFFFFFF  # INVALID itself
    q = np.concatenate([keys[:, ::3], near, big,
                        rng.integers(0, 1 << 31, (3, 30)).astype(np.uint32)],
                       axis=1)
    jf, jv = jp.lookup(js, jnp.asarray(q))
    tf, tv = tp.lookup(ts, from_np(q, "cpu"))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy().view(np.uint32), np.asarray(jv))
    assert tf.any() and not tf.all()


def test_numpy_round_trip():
    rng = np.random.default_rng(6)
    keys, data, valid = _columns(rng, 3, 2, 100, 30)
    js, _ = _pair(3, 2)
    js, _ = _append_both(js, tp.empty(CAP, 3, 2), keys, data, valid)
    ts = tp.from_numpy(np.asarray(js.keys), np.asarray(js.data),
                       js.n_sorted, js.n_used, "cpu")
    _assert_same(js, ts)
    assert ts.keys.dtype == torch.int32 and ts.data.dtype == torch.int32
