"""The port's maintenance paths against brisk_tpu on the CPU:
insert/finalize cycles with automatic consolidation, the carry path of
the span finalize, consolidate_all, store compaction, re-keying and
reallocate. Exact comparisons, array for array."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brisk_tpu.api import Brisk as JBrisk
from brisk_tpu.index import rekey as j_rekey
from brisk_tpu.index import sklstore as j_skl
from brisk_tpu.index import store as j_store
from brisk_tpu.params import Parameters as JParameters
from brisk_tpu_torch import _u32
from brisk_tpu_torch.api import Brisk as TBrisk
from brisk_tpu_torch.index import rekey as t_rekey
from brisk_tpu_torch.index import sklstore as t_skl
from brisk_tpu_torch.index import store as t_store
from brisk_tpu_torch.oracle import pyref
from brisk_tpu_torch.params import Parameters

torch.set_num_threads(2)

CONFIGS = [(31, 11, 8), (63, 21, 14)]
GEOM = dict(batch=4, window=96, stack=2)


def _rand_seq(rng, n):
    return "".join(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
                   .tobytes().decode())


def _cols(state):
    """Host uint32 columns and counters of an arena (either package)."""
    if isinstance(state, t_skl.SklState):
        return t_skl.to_numpy(state)
    out = {f: np.asarray(getattr(state, f))
           for f in ("bucket", "meta", "nucs", "data", "offs")}
    out.update(n_rows=int(state.n_rows), n_fin_rows=int(state.n_fin_rows),
               n_fin_kmers=int(state.n_fin_kmers))
    return out


def _assert_arena(js, ts, s_max, rows=None):
    """Rows [0, rows) (default n_rows) and their padded data slots."""
    ja, ta = _cols(js), _cols(ts)
    for c in ("n_rows", "n_fin_rows", "n_fin_kmers"):
        assert ta[c] == ja[c], c
    n = ja["n_rows"] if rows is None else rows
    for f in ("bucket", "meta", "offs"):
        np.testing.assert_array_equal(ta[f][:n], ja[f][:n], err_msg=f)
    np.testing.assert_array_equal(ta["nucs"][:, :n], ja["nucs"][:, :n])
    np.testing.assert_array_equal(ta["data"][:n * s_max],
                                  ja["data"][:n * s_max])


def _pair(k, m, b, seqs, finalize_each=True):
    """Both packages' Brisk after inserting `seqs` (a finalize after
    each, so the arena holds one segment per sequence)."""
    jb = JBrisk(JParameters(k, m, b), **GEOM)
    tb = TBrisk(Parameters(k, m, b), device="cpu", **GEOM)
    for s in seqs:
        jb.insert_sequence(s)
        tb.insert_sequence(s)
        if finalize_each:
            jb.finalize()
            tb.finalize()
    return jb, tb


def _segmented_arena(k, m, b, seed, fresh_tail=False):
    """A JAX arena of three finalized segments with cross-segment
    duplicates (the second and third inserts repeat the first), and
    optionally fresh rows behind them."""
    rng = np.random.default_rng(seed)
    s1 = _rand_seq(rng, 300)
    jb = JBrisk(JParameters(k, m, b), **GEOM)
    for s in (s1, _rand_seq(rng, 200) + s1[:150], s1):
        jb.insert_sequence(s)
        jb.finalize()
    assert len(jb._skl_segments) == 3
    if fresh_tail:
        jb.insert_sequence(s1[100:])
        assert int(jb.skl.n_rows) > int(jb.skl.n_fin_rows)
    return jb.skl


def test_insert_finalize_cycles_match_jax():
    """20 insert -> finalize cycles with max_segments = 3: the automatic
    consolidation fires several times, and after every cycle the arena,
    its segments and counts equal brisk_tpu's."""
    k, m, b = CONFIGS[0]
    s_max = t_skl.skl_dims(k, m, b)[1]
    rng = np.random.default_rng(2)
    jb, tb = _pair(k, m, b, [])
    jb.max_segments = tb.max_segments = 3
    base = _rand_seq(rng, 400)
    consolidations = 0
    for cyc in range(20):
        seq = base if cyc % 3 == 0 else _rand_seq(rng, 300)
        n_seg = len(tb._skl_segments)
        jb.insert_sequence(seq)
        tb.insert_sequence(seq)
        jb.finalize()
        tb.finalize()
        consolidations += len(tb._skl_segments) < n_seg
        _assert_arena(jb.skl, tb.skl, s_max)
        assert tb._skl_segments == jb._skl_segments
    assert consolidations >= 3
    assert tb.counts_dict() == jb.counts_dict()
    assert tb.stats() == jb.stats()
    assert tb.skl_stats() == jb.skl_stats()
    kmers = [pyref.num2str(v, k) for v in sorted(tb.counts_dict())[::41]]
    assert tb.get_many(kmers) == jb.get_many(kmers)


@pytest.mark.parametrize("drop_dead", [False, True])
@pytest.mark.parametrize("k,m,b", CONFIGS)
def test_finalize_span_fused_carry_path(k, m, b, drop_dead):
    """The carry path (per-slot counts ride the row sort, row-major
    expansion, 2^18 chunks) with and without the dead-row drop, on an
    arena of three finalized segments: every row and slot of the span."""
    s_max = t_skl.skl_dims(k, m, b)[1]
    cols = _cols(_segmented_arena(k, m, b, seed=k))
    N = cols["n_rows"]
    R_pad = t_skl._shape_family(N, floor=1 << 10)
    ts = t_skl._ensure_span_caps(t_skl.from_numpy(cols, "cpu"), 0, R_pad,
                                 s_max)
    js = j_skl._ensure_span_caps(
        j_skl.SklState(*(jnp.asarray(cols[f]) for f in
                         ("bucket", "meta", "nucs", "data", "offs")),
                       jnp.int32(N), jnp.int32(N),
                       jnp.int32(cols["n_fin_kmers"])), 0, R_pad, s_max)
    jo = j_skl._finalize_span_fused(
        js.bucket, js.meta, js.nucs, js.data, js.offs, jnp.int32(0),
        jnp.int32(N), k=k, m=m, b=b, s_max=s_max, R_pad=R_pad,
        carry_counts=True, drop_dead=drop_dead)
    n_live, total_k = t_skl._finalize_span_fused(
        ts, 0, R_pad, k, m, b, s_max, carry_counts=True, drop_dead=drop_dead)
    assert (int(n_live), int(total_k)) == (int(jo[5]), int(jo[6]))
    if drop_dead:
        assert int(n_live) < N  # the repeats left dead rows behind
    for f, j in zip(("bucket", "meta", "nucs", "data", "offs"), jo[:5]):
        np.testing.assert_array_equal(_u32.to_np(getattr(ts, f)),
                                      np.asarray(j), err_msg=f)


@pytest.mark.parametrize("k,m,b", CONFIGS)
def test_consolidate_all_matches(k, m, b):
    s_max = t_skl.skl_dims(k, m, b)[1]
    # three segments and a fresh tail, which consolidate_all finalizes
    # first
    js = _segmented_arena(k, m, b, seed=k + 1, fresh_tail=True)
    ts = t_skl.from_numpy(_cols(js), "cpu")
    n0 = int(js.n_rows)
    jc = j_skl.consolidate_all(js, k, m, b)
    tc = t_skl.consolidate_all(ts, k, m, b)
    _assert_arena(jc, tc, s_max)
    assert int(tc.n_rows) < n0


def _random_index_state(rng, k, b, n, n_dup):
    """(keys (W, cap) uint32, data) with n live columns of which n_dup
    repeat earlier keys, in a capacity of 2n with INVALID padding."""
    W = j_store.key_words(k, b)
    keys = rng.integers(0, 1 << 32, (W, n), dtype=np.uint64).astype(np.uint32)
    keys[0] &= 0x7FFFFFFF  # a real key never has the reserved top bit
    dup = rng.integers(0, n - n_dup, n_dup)
    keys[:, n - n_dup:] = keys[:, dup]
    data = rng.integers(1, 300, n).astype(np.uint32)
    pad = np.full((W, n), 0xFFFFFFFF, np.uint32)
    return np.concatenate([keys, pad], 1), np.concatenate(
        [data, np.zeros(n, np.uint32)])


def _assert_store(js, ts):
    assert (ts.n_sorted, ts.n_used) == (int(js.n_sorted), int(js.n_used))
    np.testing.assert_array_equal(_u32.to_np(ts.keys), np.asarray(js.keys))
    np.testing.assert_array_equal(ts.data.numpy().astype(np.uint32),
                                  np.asarray(js.data))


@pytest.mark.parametrize("full", [True, False])
def test_store_compact_and_log_ops(full):
    """empty -> append (with tombstones) -> ensure_room/grow -> compact
    and compact_auto (full) or compact_fast equal brisk_tpu's states."""
    rng = np.random.default_rng(3)
    k, b = 31, 8
    keys, data = _random_index_state(rng, k, b, 1500, 400)
    W = keys.shape[0]
    js, ts = j_store.empty(1024, W), t_store.empty(1024, W)
    valid = rng.random(1500) > 0.1
    for lo in range(0, 1500, 500):
        sl = slice(lo, lo + 500)
        kk, dd, vv = keys[:, sl], data[sl], valid[sl]
        js = j_store.ensure_room(js, 500)
        ts = t_store.ensure_room(ts, 500)
        js = j_store.append(js, jnp.asarray(kk), jnp.asarray(dd),
                            jnp.asarray(vv))
        ts = t_store.append(ts, _u32.from_np(kk, "cpu"),
                            torch.from_numpy(dd.astype(np.int64)),
                            torch.from_numpy(vv))
    _assert_store(js, ts)
    assert ts.keys.shape[1] == 2048
    if full:
        _assert_store(j_store.compact_auto(js), t_store.compact_auto(ts))
    fn_j = j_store.compact if full else j_store.compact_fast
    fn_t = t_store.compact if full else t_store.compact_fast
    _assert_store(fn_j(js), fn_t(ts))


@pytest.fixture(scope="module", params=CONFIGS, ids=["k31", "k63"])
def expanded(request):
    """Both packages' Brisk and the transient per-k-mer view of an index
    with duplicate k-mers across records."""
    k, m, b = request.param
    rng = np.random.default_rng(k)
    s = _rand_seq(rng, 350)
    jb, tb = _pair(k, m, b, [s, _rand_seq(rng, 250) + s[:120]],
                   finalize_each=False)
    return dict(p=(k, m, b), jb=jb, tb=tb, jv=jb._expanded_view(),
                tv=tb._expanded_view())


def test_rekey_and_from_entries(expanded):
    k, m, b = expanded["p"]
    old = JParameters(k, m, b)
    new_j = JParameters(k, m + 2, min(b + 2, 15))
    new_t = Parameters(k, m + 2, min(b + 2, 15))
    jr = j_rekey.reindex(expanded["jv"], old, new_j)
    tr = t_rekey.reindex(expanded["tv"], Parameters(k, m, b), new_t)
    _assert_store(jr, tr)
    s_max = t_skl.skl_dims(k, new_t.m, new_t.b)[1]
    _assert_arena(j_skl.from_entries(jr, k, new_j.m, new_j.b),
                  t_skl.from_entries(tr, k, new_t.m, new_t.b), s_max)


def test_reallocate_matches(expanded):
    """Two reallocates (at k=63 the second clamps b at 15): params,
    arena and counts equal brisk_tpu's."""
    jb, tb = expanded["jb"], expanded["tb"]
    before = tb.counts_dict()
    for _ in range(2):
        jb.reallocate()
        tb.reallocate()
        p = tb.params
        assert (p.k, p.m, p.b) == (jb.params.k, jb.params.m, jb.params.b)
        _assert_arena(jb.skl, tb.skl, t_skl.skl_dims(p.k, p.m, p.b)[1])
        assert tb._skl_segments == jb._skl_segments
        assert tb.counts_dict() == jb.counts_dict() == before
    if p.k == 63:
        assert (p.m, p.b) == (25, 15)
    kmers = [pyref.num2str(v, p.k) for v in sorted(before)[::37]]
    assert tb.get_many(kmers) == jb.get_many(kmers)
