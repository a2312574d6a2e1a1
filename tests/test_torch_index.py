"""Parity of the port's index layer (rows, insert program, finalize,
join, compaction, state carry-over) with the JAX package on the CPU.
Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brisk_tpu.index import pipeline as j_pipe
from brisk_tpu.index import sklstore as j_skl
from brisk_tpu.index import store as j_store
from brisk_tpu.io import windows as j_win
from brisk_tpu.ops import enumerate as j_enum
from brisk_tpu.oracle import pyref
from brisk_tpu_torch import _u32
from brisk_tpu_torch.index import pipeline as t_pipe
from brisk_tpu_torch.index import sklstore as t_skl
from brisk_tpu_torch.index import store as t_store

torch.set_num_threads(2)

K, M, B = 31, 11, 8
S, BATCH, WINDOW = 2, 16, 96
ROW_CAP = max(16, WINDOW // 4)


def _i64(x):
    return np.asarray(x).astype(np.int64)


def _assert_arena(js, ts, fin=False):
    n = int(js.n_rows)
    assert int(ts.n_rows) == n
    for f in ("bucket", "meta"):
        np.testing.assert_array_equal(_u32.to_np(getattr(ts, f))[:n],
                                      np.asarray(getattr(js, f))[:n])
    np.testing.assert_array_equal(_u32.to_np(ts.nucs)[:, :n],
                                  np.asarray(js.nucs)[:, :n])
    if fin:
        s_max = t_skl.skl_dims(K, M, B)[1]
        np.testing.assert_array_equal(_u32.to_np(ts.offs)[:n],
                                      np.asarray(js.offs)[:n])
        np.testing.assert_array_equal(_u32.to_np(ts.data)[:n * s_max],
                                      np.asarray(js.data)[:n * s_max])
        assert int(ts.n_fin_rows) == int(js.n_fin_rows)
        assert int(ts.n_fin_kmers) == int(js.n_fin_kmers)


@pytest.fixture(scope="module")
def inserted():
    """Both packages' arenas after three flat flushes of
    data/debug_test.fa, with every flush's outputs."""
    recs = list(pyref.read_fasta_chunks("data/debug_test.fa"))
    packer = j_win.WindowPacker(K, M, BATCH, l_out=WINDOW)
    nw = j_skl.skl_dims(K, M, B)[3]
    js, ts = j_skl.empty(1 << 14, 1 << 14, nw), t_skl.empty(1 << 14,
                                                            1 << 14, nw)
    jch, tch = j_pipe.zero_chain(), t_pipe.zero_chain()
    outs = []
    for i, fl in enumerate(packer.pack_flat(iter(recs), S)):
        if i == 3:
            break
        vs = fl.valid_start.reshape(S, BATCH)
        ve = fl.valid_end.reshape(S, BATCH)
        jo = j_pipe.insert_flat_sklnative(
            js, jnp.asarray(fl.chunk4), jnp.asarray(vs), jnp.asarray(ve),
            jch, k=K, m=M, b=B, row_cap=ROW_CAP, l_buf=packer.l_buf,
            useful=packer.useful)
        to = t_pipe.insert_flat_sklnative(
            ts, torch.from_numpy(fl.chunk4), torch.from_numpy(vs),
            torch.from_numpy(ve), tch, K, M, B, ROW_CAP, packer.l_buf,
            packer.useful)
        outs.append((jo, to, int(jo[0].n_rows)))
        js, jch, ts, tch = jo[0], jo[6], to[0], to[6]
    return js, ts, outs


def test_insert_flat_sklnative_flushes(inserted):
    js, ts, outs = inserted
    assert len(outs) == 3
    for jo, to, n_rows in outs:
        np.testing.assert_array_equal(to[3].numpy(), np.asarray(jo[3]))
        assert int(to[1]) == int(jo[1]) and int(to[2]) == int(jo[2])
        assert int(to[5]) == int(jo[5]) == n_rows
        for a, c in zip(jo[4], to[4]):  # per-lane end states
            np.testing.assert_array_equal(c.numpy().astype(np.int64),
                                          _i64(a))
        (jend, jex), (tend, tex) = jo[6], to[6]  # the chain carry
        assert bool(jex) == bool(tex)
        assert [int(x) for x in jend] == [int(x) for x in tend]
    _assert_arena(js, ts)


def test_finalize_device(inserted):
    js, ts, _ = inserted
    jf = j_skl.finalize_device(js, K, M, B)
    tf = t_skl.finalize_device(ts, K, M, B)
    _assert_arena(jf, tf, fin=True)
    assert t_skl.stats(tf, K, M, B) == j_skl.stats(jf, K, M, B)
    # the finalized state carries across frameworks and back
    arrays = {f: np.asarray(getattr(jf, f))
              for f in ("bucket", "meta", "nucs", "data", "offs")}
    arrays.update(n_rows=int(jf.n_rows), n_fin_rows=int(jf.n_fin_rows),
                  n_fin_kmers=int(jf.n_fin_kmers))
    back = t_skl.to_numpy(t_skl.from_numpy(arrays, "cpu"))
    for f, v in arrays.items():
        np.testing.assert_array_equal(back[f], v)
    # the transient expansion and the distinct count agree too
    jk, jc = j_skl.expand_device(jf, K, M, B)
    tk, tc = t_skl.expand_device(tf, K, M, B)
    np.testing.assert_array_equal(_u32.to_np(tk), np.asarray(jk))
    np.testing.assert_array_equal(tc.numpy(), _i64(jc))


def test_rows_from_emissions_with_overflow():
    recs = list(pyref.read_fasta_chunks("data/test.fa"))
    packer = j_win.WindowPacker(K, M, BATCH, l_out=WINDOW)
    wb = next(packer.pack(iter(recs)))
    codes, vs, ve = wb.codes, wb.valid_start, wb.valid_end
    em, _ = j_enum.enumerate_batch(
        jnp.asarray(codes), jnp.ones(BATCH, bool), jnp.asarray(ve),
        j_enum.zero_carry(BATCH), k=K, m=M, b=B,
        valid_start=jnp.asarray(vs))
    pos = np.arange(K - 1, packer.l_buf)[None, :]
    first_valid = pos == vs[:, None]
    fields = (em.key, em.bucket, em.mini_idx, em.use_rc, em.valid,
              first_valid, em.boundary)
    np_in = [np.asarray(x) for x in fields]
    for row_cap in (ROW_CAP, 4):  # 4 rows per lane forces overflows
        jo = j_skl.rows_from_emissions(*(jnp.asarray(x) for x in np_in),
                                       K, M, B, row_cap)
        to = t_skl.rows_from_emissions(
            *(torch.from_numpy(np.array(x, dtype=np.int64) if x.dtype != bool
                               else np.array(x))
              for x in np_in), K, M, B, row_cap)
        for a, c in zip(jo, to):
            np.testing.assert_array_equal(c.numpy().astype(np.int64),
                                          _i64(a))
        if row_cap == 4:
            assert bool(to[3].any())


def _random_keys(rng, W, n, n_distinct):
    pool = rng.integers(0, 1 << 31, (W, n_distinct), dtype=np.uint32)
    pool[0] &= 0x7FFFFFFF  # the reserved top bit of a packed key
    return pool[:, rng.integers(0, n_distinct, n)]


def test_query_join_partials():
    rng = np.random.default_rng(4)
    W = 3
    ik = _random_keys(rng, W, 3000, 900)
    iw = rng.integers(0, 300, 3000).astype(np.uint32)
    qk = np.concatenate([_random_keys(rng, W, 2000, 900),
                         ik[:, :500]], axis=1)
    ql = (rng.random(qk.shape[1]) < 0.9).astype(np.uint32)
    qk[:, :40] = 0xFFFFFFFF  # padding slots
    ql[:40] = 0
    want = np.asarray(j_skl._query_join_partials(
        jnp.asarray(ik), jnp.asarray(iw), jnp.asarray(qk), jnp.asarray(ql)))
    got = t_skl._query_join_partials(
        _u32.from_np(ik, "cpu"), torch.from_numpy(iw.astype(np.int64)),
        _u32.from_np(qk, "cpu"), torch.from_numpy(ql.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert got.sum() > 0


def test_compact_fast():
    rng = np.random.default_rng(9)
    keys = _random_keys(rng, 3, 2048, 400)
    keys[:, 1500:] = 0xFFFFFFFF
    data = rng.integers(0, 5, 2048).astype(np.uint32)
    jst = j_store.compact_fast(j_store.IndexState(
        jnp.asarray(keys), jnp.asarray(data), jnp.int32(0), jnp.int32(1800)))
    tst = t_store.compact_fast(t_store.IndexState(
        _u32.from_np(keys, "cpu"), torch.from_numpy(data.astype(np.int64)),
        0, 1800))
    np.testing.assert_array_equal(_u32.to_np(tst.keys), np.asarray(jst.keys))
    np.testing.assert_array_equal(tst.data.numpy(), _i64(jst.data))
    assert tst.n_sorted == int(jst.n_sorted)


def test_key_words_and_packing():
    rng = np.random.default_rng(3)
    bucket = rng.integers(0, 1 << 16, 257).astype(np.uint32)
    limbs = rng.integers(0, 1 << 32, (4, 257), dtype=np.uint32)
    mini = rng.integers(0, 40, 257).astype(np.uint32)
    for k, b in ((31, 8), (63, 14), (21, 6)):
        assert t_store.key_words(k, b) == j_store.key_words(k, b)
        want = np.asarray(j_store.make_keys(jnp.asarray(bucket),
                                            jnp.asarray(limbs),
                                            jnp.asarray(mini), k, b))
        got = t_store.make_keys(*(torch.from_numpy(x.astype(np.int64))
                                  for x in (bucket, limbs, mini)), k, b)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
